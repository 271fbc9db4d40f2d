"""Linear-attention CUDA kernel: wrapper, launch count and plain twin.

Port of the TPU kernel ``cfpnet_tpu/ops/pallas_attention.py::
linear_attention_pallas`` (wrapper ``linear_attention_auto``). The kernel
is ``cfpnet_torch/csrc/linear_attention.cu``; its plain version is
``cfpnet_torch/ops/attention.py::linear_attention``.

``linear_attention(q, k, v)`` takes the JAX layout [N, L, H, D] (which is
[N, L, C] in memory, C = H*D). A CPU tensor goes through the plain version;
a CUDA tensor goes through the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.attention import linear_attention as linear_attention_plain
from . import build

SUPPORTED_D = (4, 8, 16, 32)
# (n,h) blocks of pass 1 aimed at, two per SM of the H100's 132
_TARGET_BLOCKS = 264
_TILE_S = 64  # keys staged per step of pass 1 (kTileS in the source)

launches = 0  # kernel launches since the last reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def _kernel():
    fn = build.load("linear_attention").cfp_linear_attention_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    return fn


def chunking(N: int, H: int, S: int):
    """(nchunk, chunk): how pass 1 splits the S keys over blocks."""
    nchunk = max(1, min(-(-S // _TILE_S), -(-_TARGET_BLOCKS // (N * H))))
    return nchunk, -(-S // nchunk)


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """Unmasked multi-head elu+1 linear attention. q: [N, L, H, D];
    k, v: [N, S, H, D]. Returns [N, L, H, D]."""
    if q.device.type == "cpu":
        return linear_attention_plain(q, k, v, eps=eps)
    _check(q, k, v)
    global launches
    N, L, H, D = q.shape
    S = k.shape[1]
    nchunk, chunk = chunking(N, H, S)
    P = D * D + D
    out = torch.empty_like(q)
    partial = torch.empty(N * H * nchunk * P, device=q.device, dtype=torch.float32)
    kv = torch.empty(N * H * P, device=q.device, dtype=torch.float32)
    rc = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), partial.data_ptr(),
        kv.data_ptr(), N, L, S, H, D, nchunk, chunk, eps,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"linear_attention kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"linear_attention: {name} must be on {q.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"linear_attention: {name} must be float32, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"linear_attention: {name} must be [N, *, H, D], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"linear_attention: {name} must be contiguous")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("linear_attention: the CUDA kernel has no backward yet; "
                                  "run the forward under torch.no_grad()")
    N, L, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != N or k.shape[2:] != (H, D):
        raise ValueError(f"linear_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if D not in SUPPORTED_D:
        raise ValueError(f"linear_attention: head dim {D} not in {SUPPORTED_D}")
    if k.shape[1] == 0 or L == 0:
        raise ValueError("linear_attention: empty sequence")
