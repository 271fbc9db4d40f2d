"""Fused LoFTR-layer CUDA kernel: wrapper, launch count, plain twin and
gradient.

Port of the TPU kernel ``cfpnet_tpu/ops/pallas_loftr.py::fused_loftr``
(``_fused_loftr_impl``, kernel ``_kernel``, custom VJP ``_fused_bwd``). The
kernel is ``cfpnet_torch/csrc/fused_loftr.cu``; its plain version is
``cfpnet_torch/ops/loftr.py::loftr_apply``.

``fused_loftr(x, source, p, nhead)`` takes x [N, L, C], source [N, S, C]
and ``LoFTRParams`` whose matrices are [in, out] views of [out, in]
storage, as ``LoFTREncoderLayer.loftr_params`` gives them (the kernel reads
the ``nn.Linear`` weights as they are stored), all float32 or all bfloat16
(the bf16 variant rounds where the Pallas kernel does: the message before
the merge, LN1's output, the ReLU output and the output; its products are
one TF32 pass on bf16-valued operands, exact). A CPU tensor goes through
the plain version; a CUDA tensor goes through the kernel or raises.

One wrapper call is two kernel launches on the card (the per-group KV
summary, then the row pass, which starts before the summary ends by
programmatic dependent launch and waits for it only where it reads the
summary); ``launches`` counts wrapper calls that launched. The gradient is that of the plain version, recomputed from the
saved inputs, as the JAX package's custom VJP takes the VJP of
``loftr_apply_xla``; in bf16 it raises (the bf16 train step, ROADMAP §A
2c).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..ops.loftr import LoFTRParams, loftr_apply
from . import build
from .dtypes import DTYPES, check_dtypes, count_launch

SUPPORTED_C = (32, 64, 128)
SUPPORTED_HEADS = (4, 8)

launches = 0  # kernel launches since the last reset_launches()
# the same launches by element type ("float32", "bfloat16")
launches_by_dtype: Dict[str, int] = {}


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_dtype.clear()


_fns = {}


def _kernel(dtype: torch.dtype):
    """The C entry point for ``dtype``, its ctypes signature set once."""
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(build.load("fused_loftr"), f"cfp_fused_loftr_{DTYPES[dtype]}")
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        _fns[dtype] = fn
    return fn


def fused_loftr(x: torch.Tensor, source: torch.Tensor, p: LoFTRParams, nhead: int,
                eps: float = 1e-6) -> torch.Tensor:
    """One unmasked LoFTR encoder layer. x: [N, L, C]; source: [N, S, C].
    Returns [N, L, C]; differentiable in x, source and every weight."""
    return _FusedLoFTR.apply(x, source, nhead, eps, *p)


class _FusedLoFTR(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, source, nhead, eps, *weights):
        ctx.save_for_backward(x, source, *weights)
        ctx.nhead, ctx.eps = nhead, eps
        p = LoFTRParams(*weights)
        if x.device.type == "cpu":
            return loftr_apply(x, source, p, nhead, eps)
        return _launch(x, source, p, nhead, eps)

    @staticmethod
    def backward(ctx, grad):
        if grad.dtype == torch.bfloat16:
            raise NotImplementedError("fused_loftr: the bf16 backward is not ported (the bf16 "
                                      "train step, ROADMAP.md §A 2c)")
        saved = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = loftr_apply(saved[0], saved[1], LoFTRParams(*saved[2:]), ctx.nhead, ctx.eps)
            grads = torch.autograd.grad(out, saved, grad)
        return (grads[0], grads[1], None, None, *grads[2:])


def _launch(x, source, p, nhead, eps):
    _check(x, source, p, nhead)
    global launches
    N, L, C = x.shape
    S = source.shape[1]
    D = C // nhead
    out = torch.empty_like(x)
    kv = torch.empty(N * nhead * (D * D + D), device=x.device, dtype=torch.float32)
    rc = _kernel(x.dtype)(
        x.data_ptr(), source.data_ptr(), *(w.data_ptr() for w in p), out.data_ptr(),
        kv.data_ptr(), N, L, S, C, D, eps, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_loftr kernel launch failed: cudaError {rc}")
    launches += 1
    count_launch(launches_by_dtype, x.dtype)
    return out


def _check(x, source, p, nhead):
    if x.dim() != 3 or source.dim() != 3:
        raise ValueError(f"fused_loftr: x and source must be [N, *, C], got {tuple(x.shape)}, "
                         f"{tuple(source.shape)}")
    N, L, C = x.shape
    if source.shape[0] != N or source.shape[2] != C:
        raise ValueError(f"fused_loftr: source {tuple(source.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if C not in SUPPORTED_C or nhead not in SUPPORTED_HEADS:
        raise ValueError(f"fused_loftr: C={C}, {nhead} heads; the kernel takes C in "
                         f"{SUPPORTED_C} with {SUPPORTED_HEADS} heads")
    if L == 0 or source.shape[1] == 0:
        raise ValueError("fused_loftr: empty sequence")
    shapes = dict(wq=(C, C), wk=(C, C), wv=(C, C), wm=(C, C), g1=(C,), b1=(C,),
                  w0=(2 * C, 2 * C), w1=(2 * C, C), g2=(C,), b2=(C,))
    tensors = [("x", x), ("source", source)] + list(zip(LoFTRParams._fields, p))
    check_dtypes("fused_loftr", tensors)
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"fused_loftr: {name} must be on a CUDA device with x, "
                             f"got {t.device}")
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"fused_loftr: {name} must be {shapes[name]}, got {tuple(t.shape)}")
        # matrices are [in, out] views of [out, in] storage (an nn.Linear weight's .t())
        stored = t.t() if t.dim() == 2 else t
        if not stored.is_contiguous():
            what = ("the transpose of a contiguous [out, in] tensor" if stored is not t
                    else "contiguous")
            raise ValueError(f"fused_loftr: {name} must be {what}")
        if t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"fused_loftr: {name} must be aligned to 4 elements "
                             f"({4 * t.element_size()} bytes)")
