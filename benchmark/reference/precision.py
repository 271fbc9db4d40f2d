"""The reference in a lower precision: the controls of the output checks.

- ``fp8()``: every product and convolution of the reference (``F.conv2d``,
  ``F.linear``, ``@``, ``einsum``) takes its floating operands rounded to
  float8 e4m3, each scaled by its own largest magnitude to the format's
  largest finite value first (per-tensor scaling, as fp8 inference does);
  the sums stay float32. The control of a bfloat16 cell.
- ``tf32()``: the card's TF32 products for float32 matmuls and convolutions
  (``allow_tf32``), in the forward and the backward. The control of a
  float32 cell that runs with TF32 off.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0
_PRODUCTS = {F.conv2d, F.linear, torch.einsum, torch.matmul, torch.Tensor.__matmul__,
             torch.Tensor.matmul}


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in its dtype."""
    scale = E4M3_MAX / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


class _Fp8(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            def q(a):
                if isinstance(a, torch.Tensor) and a.is_floating_point():
                    return round_fp8(a)
                if isinstance(a, (list, tuple)):
                    return type(a)(q(b) for b in a)
                return a

            args = tuple(q(a) for a in args)
            kwargs = {k: q(v) for k, v in kwargs.items()}
        return func(*args, **kwargs)


def fp8():
    """Context in which the reference's products run on fp8 operands."""
    return _Fp8()


@contextlib.contextmanager
def tf32():
    """Context in which float32 matmuls and convolutions run in TF32."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# the control of a cell by the dtype it states
CONTROL = {"bfloat16": fp8, "float32": tf32}
