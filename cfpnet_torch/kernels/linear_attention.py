"""Linear-attention CUDA kernel: wrapper, launch plan, launch count and plain
twin.

Port of the TPU kernel ``cfpnet_tpu/ops/pallas_attention.py::
linear_attention_pallas`` (wrapper ``linear_attention_auto``). The kernel
is ``cfpnet_torch/csrc/linear_attention.cu``; its plain version is
``cfpnet_torch/ops/attention.py::linear_attention``.

``linear_attention(q, k, v)`` takes the JAX layout [N, L, H, D] (which is
[N, L, C] in memory, C = H*D). A CPU tensor goes through the plain version;
a CUDA tensor goes through the kernel or raises. On the card the gradient
is autograd of the plain version, recomputed from the saved inputs, as
``kernels/fused_loftr.py`` takes its own: the TPU kernel has no backward
kernel to port.

``launch_plan(N, L, S, H, D)`` owns the geometry of a call's two device
kernels (the summary pass's head groups, clusters, cluster sums, key tiles
and slices; the apply pass's query tile and shared-memory pitch), which the
C entry point takes as arguments, so the plan is checked on the CPU
(``tests/test_torch_port_attention.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from types import MappingProxyType
from typing import Mapping

import torch

from ..ops.attention import linear_attention as linear_attention_plain
from . import build
from .dwconv import (MAX_BLOCKS_PER_SM, MAX_THREADS_PER_SM, REGISTERS_PER_SM, SMEM_PER_BLOCK,
                     SMEM_PER_SM, SMEM_RESERVED, SMS)

SUPPORTED_D = (4, 8, 16, 32)
CLUSTER_MAX = 16  # blocks a cluster: the H100's most (above 8 non-portable)
SUM_BLOCKS = 128  # summary blocks aimed at where the keys are many
MIN_KEYS = 32  # keys a summary block at least
TILE_FLOATS = 8192  # floats of K (and of V) a summary tile holds, at most
APPLY_SUM_FLOATS = 8448  # floats of cluster sums an apply block may add (g * H * P)


def cluster_max(D: int) -> int:
    """Blocks a summary cluster at most: 16 where a block's keys cost many
    products (D >= 16), 8 at D <= 8, where the wider cluster barrier costs
    more than the fewer cluster sums save (PERF.md, the attention step
    table)."""
    return CLUSTER_MAX if D >= 16 else 8


def sum_max_threads(D: int) -> int:
    """The summary kernel's launch bound (Cfg<D>::SUM_MAXT)."""
    return 512 if D == 32 else 256


def apply_max_threads(D: int) -> int:
    """The apply kernel's launch bound (Cfg<D>::APPLY_MAXT), at two blocks an
    SM."""
    return 640 if D == 8 else 512


def outputs_per_thread(D: int) -> int:
    """Outputs an apply thread computes (Cfg<D>::EO)."""
    return 4 if D in (4, 32) else 8


launches = 0  # kernel launches since the last reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def _blocks_per_sm(threads: int, smem: int, max_threads: int, min_blocks: int = 1) -> int:
    regs = min(255, REGISTERS_PER_SM // (max_threads * min_blocks) // 8 * 8)
    return min(SMEM_PER_SM // (smem + SMEM_RESERVED), MAX_THREADS_PER_SM // threads,
               MAX_BLOCKS_PER_SM, REGISTERS_PER_SM // (threads * regs))


@functools.lru_cache(maxsize=64)
def launch_plan(N: int, L: int, S: int, H: int, D: int) -> Mapping:
    """The launch for q [N, L, H, D] and k, v [N, S, H, D], read-only
    (computed once per shape and shared by the calls).

    Summary pass: a block takes ``hb`` heads (``hg`` head groups) of one
    batch row over ``chunk`` keys, in ``tk``-key tiles (rows ``kpitch``
    floats apart); a 4x4 block of KV is an item of ``slices`` adjacent
    lanes, which split the tile's keys and add up by a butterfly; ``cl``
    blocks a cluster add their sums in distributed shared memory and ``g``
    clusters per (row, head group) each write one sum. Apply pass: ``tl``
    query rows a block, ``H * D / EO`` threads a row, heads ``pitch`` floats
    apart in shared memory, the ``g`` sums staged beside them.
    ``blocks_per_sm`` bounds the registers a thread by the launch bound
    (ptxas may use fewer), ``waves`` is a grid over the blocks the 132 SMs
    hold at once."""
    P = D * D + D
    per_head = (D // 4) ** 2
    hb = min(H, max(1, sum_max_threads(D) // per_head))
    hg = -(-H // hb)
    items = hb * per_head
    # lanes an item: a power of two <= 32, so that a butterfly adds them
    slices = 1 << min(5, max(0, (sum_max_threads(D) // items).bit_length() - 1))
    sum_threads = -(-slices * items // 32) * 32
    splits = max(1, min(-(-S // MIN_KEYS), -(-SUM_BLOCKS // (N * hg))))
    cl = min(cluster_max(D), splits)
    g = max(1, min(-(-splits // cl), APPLY_SUM_FLOATS // (H * P)))
    chunk = -(-S // (g * cl))
    # key rows 4 floats apart where the lanes of an item read different rows
    kpitch = hb * D + (4 if slices > 1 else 0)
    tk = max(1, min(TILE_FLOATS // kpitch, chunk))
    share4 = -(-hb * P // 4 // cl)  # float4s of the sums a cluster rank adds
    sum_smem = 4 * (2 * tk * kpitch + (4 * cl * share4 if cl > 1 else 0))
    sum_blocks = N * hg * g * cl

    eo = outputs_per_thread(D)
    tpr = H * D // eo  # apply threads a query row
    unit = max(1, 32 // tpr)  # rows that make a whole warp
    tl = -(-L // max(1, SMS // N))
    tl = -(-tl // unit) * unit
    tl = max(1, min(tl, apply_max_threads(D) // tpr))
    apply_threads = -(-tl * tpr // 32) * 32
    w = D // eo
    pitch = P + (4 * w - P) % 32  # P <= pitch, pitch = 4 w mod 32
    apply_smem = 4 * H * pitch + (4 * g * H * P if g > 1 else 0)
    apply_blocks = -(-L // tl) * N
    sum_per_sm = _blocks_per_sm(sum_threads, sum_smem, sum_max_threads(D))
    apply_per_sm = _blocks_per_sm(apply_threads, apply_smem, apply_max_threads(D), 2)
    return MappingProxyType(dict(
        hb=hb, hg=hg, cl=cl, g=g, chunk=chunk, tk=tk, kpitch=kpitch, slices=slices, items=items,
        sum_threads=sum_threads, sum_smem=sum_smem, sum_blocks=sum_blocks,
        sum_blocks_per_sm=sum_per_sm, sum_waves=sum_blocks / (SMS * sum_per_sm),
        eo=eo, tl=tl, pitch=pitch, apply_threads=apply_threads, apply_smem=apply_smem,
        apply_blocks=apply_blocks, apply_blocks_per_sm=apply_per_sm,
        apply_waves=apply_blocks / (SMS * apply_per_sm),
        apply_balance=apply_blocks / (SMS * math.ceil(apply_blocks / SMS)),
        sums_floats=N * g * H * P))


_fn = None


def _kernel():
    """The C entry point, its ctypes signature set once."""
    global _fn
    if _fn is None:
        fn = build.load("linear_attention").cfp_linear_attention_f32
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 19
                       + [ctypes.c_float, ctypes.c_void_p])
        _fn = fn
    return _fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on 16 bytes (a
    view at an odd offset): the kernel reads 16-byte groups."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """Unmasked multi-head elu+1 linear attention. q: [N, L, H, D];
    k, v: [N, S, H, D]. Returns [N, L, H, D]; differentiable in q, k and v."""
    if q.device.type == "cpu":
        return linear_attention_plain(q, k, v, eps=eps)
    return _LinearAttention.apply(q, k, v, eps)


class _LinearAttention(torch.autograd.Function):
    """The kernel forward; the backward is autograd of the plain version,
    recomputed from the saved q, k, v (the TPU kernel has no VJP; the JAX
    train step differentiates the XLA path)."""

    @staticmethod
    def forward(ctx, q, k, v, eps):
        ctx.save_for_backward(q, k, v)
        ctx.eps = eps
        return _launch(q, k, v, eps)

    @staticmethod
    def backward(ctx, grad):
        saved = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = linear_attention_plain(*saved, eps=ctx.eps)
            grads = torch.autograd.grad(out, saved, grad)
        return (*grads, None)


def _launch(q, k, v, eps):
    _check(q, k, v)
    global launches
    N, L, H, D = q.shape
    S = k.shape[1]
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    p = launch_plan(N, L, S, H, D)
    out = torch.empty_like(q)
    sums = torch.empty(p["sums_floats"], device=q.device, dtype=torch.float32)
    rc = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), sums.data_ptr(),
        N, L, S, H, D, p["hb"], p["hg"], p["cl"], p["g"], p["chunk"], p["tk"], p["kpitch"],
        p["slices"],
        p["sum_threads"], p["sum_smem"], p["tl"], p["pitch"], p["apply_threads"],
        p["apply_smem"], eps, torch.cuda.current_stream(q.device).cuda_stream)
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
    N, L, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != N or k.shape[2:] != (H, D):
        raise ValueError(f"linear_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if D not in SUPPORTED_D:
        raise ValueError(f"linear_attention: head dim {D} not in {SUPPORTED_D}")
    if k.shape[1] == 0 or L == 0:
        raise ValueError("linear_attention: empty sequence")
