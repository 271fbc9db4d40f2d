"""Large-kernel depthwise-conv CUDA kernel: wrapper, launch count and plain
twin.

Port of the TPU kernel ``cfpnet_tpu/ops/pallas_dwconv.py::
depthwise_conv2d_pallas``. The kernel is ``cfpnet_torch/csrc/dwconv.cu``;
its plain version is ``cfpnet_torch/ops/dwconv.py::depthwise_conv2d``.

``depthwise_conv2d(x, weight, bias)`` takes x [B, H, W, C] (NHWC, the
fusion path's token layout, so no permute), weight [C, 1, k, k] (torch
depthwise layout) and bias [C]. A CPU tensor goes through the plain
version; a CUDA tensor goes through the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..ops.dwconv import depthwise_conv2d as depthwise_conv2d_plain
from . import build

SUPPORTED_K = (7, 15, 31)

launches = 0  # kernel launches since the last reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def _kernel():
    fn = build.load("dwconv").cfp_dwconv2d_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


def depthwise_conv2d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME-padded stride-1 depthwise conv plus bias, NHWC."""
    if x.device.type == "cpu":
        return depthwise_conv2d_plain(x, weight, bias)
    _check(x, weight, bias)
    global launches
    B, H, W, C = x.shape
    k = weight.shape[-1]
    out = torch.empty_like(x)
    rc = _kernel()(x.data_ptr(), weight.data_ptr(), 0 if bias is None else bias.data_ptr(),
                   out.data_ptr(), B, H, W, C, k,
                   torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dwconv kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def _check(x, weight, bias):
    tensors = [("x", x), ("weight", weight)] + ([] if bias is None else [("bias", bias)])
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"dwconv: {name} must be on {x.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"dwconv: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"dwconv: {name} must be contiguous")
        if torch.is_grad_enabled() and t.requires_grad:
            raise NotImplementedError("dwconv: the CUDA kernel has no backward yet; "
                                      "run the forward under torch.no_grad()")
    if x.dim() != 4:
        raise ValueError(f"dwconv: x must be [B, H, W, C], got {tuple(x.shape)}")
    C = x.shape[-1]
    k = weight.shape[-1]
    if tuple(weight.shape) != (C, 1, k, k):
        raise ValueError(f"dwconv: weight must be [{C}, 1, k, k], got {tuple(weight.shape)}")
    if k not in SUPPORTED_K:
        raise ValueError(f"dwconv: kernel size {k} not in {SUPPORTED_K}")
    if bias is not None and tuple(bias.shape) != (C,):
        raise ValueError(f"dwconv: bias must be [{C}], got {tuple(bias.shape)}")
