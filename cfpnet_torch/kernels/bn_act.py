"""Eval-mode BatchNorm epilogue CUDA kernel: wrapper, launch plan, launch
count and plain twin.

The kernel is ``cfpnet_torch/csrc/bn_act.cu``. It replaces no TPU kernel:
the JAX package leaves BatchNorm, the activation after it and a block's
shortcut add to XLA's fusion, which the port's eager and CUDA-graph forward
does not have. One call computes, per channel c of x,

    y = act((x - mean[c]) * (rsqrt(var[c] + eps) * weight[c]) + bias[c]) (+ residual)

with act one of ``ACTS`` (identity, SiLU, LeakyReLU(0.01), ReLU): the eval
formula of ``models/layers.py::BatchNorm``, then the caller's activation,
then its shortcut, in one read of x (and of the shortcut) and one write of
y, arithmetic in f32 and one rounding to the element type at the store.
Its plain twin ``bn_act_plain`` writes the same out in PyTorch in that
order, rounding at every op as the parent formula always did.

``bn_act(x, weight, bias, mean, var, eps, act, channel_dim, residual)`` takes
x with its channels along ``channel_dim`` (1 for NCHW, -1 for
channel-innermost tokens), contiguous, or a 4-D NCHW map in channels-last
memory (read as channel-innermost); every tensor float32 or every one
bfloat16, the shortcut with x's shape and strides. It is the
``torch.library`` op ``cfpnet::bn_act``: a CPU tensor goes through the plain
twin, a CUDA tensor through the kernel, and a tensor on any other device
raises, as does any call the kernel does not take (``refusal``), under a
trace too; under ``torch.export`` it stays one node. It has no gradient:
``ops/dispatch.py::batch_norm`` sends it only calls that need none.

``launch_plan(n, C, inner, vec, aligned)`` picks the kernel's mode (PLANE,
TOKENS or SCALAR, ``csrc/bn_act.cu``) and its grid; ``fast_div`` gives the
multiply-and-shift constants of the kernel's divisions by ``inner`` and C,
so both are checked on the CPU (``tests/test_torch_port_bn_act.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from types import MappingProxyType
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from . import build
from .dtypes import DTYPES, check_dtypes, count_launch, traced_output

ACTS = ("identity", "silu", "leaky_relu", "relu")  # the C entry's act codes, in order
LEAKY_SLOPE = 0.01  # nn.LeakyReLU(0.01) of models/decoder.py::UpSampleBN
THREADS = 256  # csrc/bn_act.cu, kThreads
MODES = ("plane", "tokens", "scalar")  # csrc/bn_act.cu, Mode
MAX_ELEMENTS = 2 ** 31  # the kernel's divisions and offsets are 32-bit

_ACTIVATIONS = {
    "identity": lambda y: y,
    "silu": F.silu,
    "leaky_relu": lambda y: F.leaky_relu(y, LEAKY_SLOPE),
    "relu": F.relu,
}


def bn_act_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 mean: torch.Tensor, var: torch.Tensor, eps: float, act: str = "identity",
                 channel_dim: int = 1, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BatchNorm's written-out formula, then ``act``, then ``+ residual``, in
    PyTorch ops. The output takes the dtype of (x, weight, bias), as flax's
    ``_normalize`` does (a bf16 step's BatchNorm gives bf16, its f32
    statistics notwithstanding)."""
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    mul = torch.rsqrt(var + eps) * weight
    y = (x - mean.view(shape)) * mul.view(shape) + bias.view(shape)
    y = _ACTIVATIONS[act](y.to(torch.promote_types(torch.promote_types(x.dtype, weight.dtype),
                                                   bias.dtype)))
    return y if residual is None else y + residual


def fast_div(d: int) -> Tuple[int, int]:
    """(mul, shift) with n // d == ((n * mul) >> 32) >> shift for 0 <= n <
    2**31 and d > 1 (CUTLASS's FastDivmod); (0, 0) for d == 1, which the
    kernel takes as n itself."""
    if d < 1:
        raise ValueError(f"fast_div: divisor {d} < 1")
    if d == 1:
        return 0, 0
    bits = (d - 1).bit_length()  # ceil(log2 d)
    return -(-(1 << (31 + bits)) // d), bits - 1


@functools.lru_cache(maxsize=512)
def launch_plan(n: int, C: int, inner: int, vec: int, aligned: bool) -> Mapping:
    """The launch over n elements of C channels, each a run of ``inner``
    elements in memory, read ``vec`` elements (16 bytes) a thread where
    ``aligned`` (every pointer 16-byte aligned): PLANE where a run holds a
    whole vector, so a vector meets at most one boundary; TOKENS where
    channels are innermost and C a multiple of ``vec``, so a vector holds
    whole channels; SCALAR, a thread an element, otherwise. ``items`` are
    the threads that take a vector (an element in SCALAR), ``blocks`` of
    ``THREADS`` cover them and, in the vector modes, one more thread for the
    ``tail`` elements past the last whole vector."""
    if aligned and inner >= vec:
        mode = "plane"
    elif aligned and inner == 1 and C % vec == 0:
        mode = "tokens"
    else:
        mode = "scalar"
    items, tail = (n, 0) if mode == "scalar" else divmod(n, vec)
    threads = items + (1 if tail else 0)
    inner_mul, inner_shift = fast_div(inner)
    c_mul, c_shift = fast_div(C)
    return MappingProxyType(dict(
        mode=mode, items=items, tail=tail, blocks=-(-threads // THREADS), inner_mul=inner_mul,
        inner_shift=inner_shift, c_mul=c_mul, c_shift=c_shift))


def memory_layout(x: torch.Tensor, channel_dim: int) -> Optional[Tuple[int, int]]:
    """(C, inner) of x in memory: the channels and the run of elements of one
    channel between two steps of it. None where the kernel cannot read x:
    neither contiguous nor a 4-D NCHW map in channels-last memory."""
    cd = channel_dim % x.dim()
    if x.is_contiguous():
        return x.shape[cd], math.prod(x.shape[cd + 1:])
    if x.dim() == 4 and cd == 1 and x.is_contiguous(memory_format=torch.channels_last):
        return x.shape[1], 1
    return None


def refusal(x, weight, bias, mean, var, act: str = "identity", channel_dim: int = 1,
            residual: Optional[torch.Tensor] = None) -> Optional[Exception]:
    """Why ``bn_act`` would raise on these tensors (wherever they lie), or
    None where the kernel takes them. Reads only shapes, strides, dtypes and
    devices, so it runs under a trace too."""
    tensors = [("x", x), ("weight", weight), ("bias", bias), ("mean", mean), ("var", var)]
    if residual is not None:
        tensors.append(("residual", residual))
    try:
        check_dtypes("bn_act", tensors)
    except TypeError as e:
        return e
    if act not in ACTS:
        return ValueError(f"bn_act: act {act!r} is none of {ACTS}")
    if x.dim() < 2 or not -x.dim() <= channel_dim < x.dim():
        return ValueError(f"bn_act: channel_dim {channel_dim} of a {x.dim()}-D x")
    C = x.shape[channel_dim]
    for name, t in tensors:
        if t.device != x.device:
            return ValueError(f"bn_act: {name} is on {t.device} and x on {x.device}")
        if name in ("weight", "bias", "mean", "var") and tuple(t.shape) != (C,):
            return ValueError(f"bn_act: {name} must be [{C}], got {tuple(t.shape)}")
    if memory_layout(x, channel_dim) is None:
        return ValueError(f"bn_act: x must be contiguous (or an NCHW map in channels-last "
                          f"memory), got strides {x.stride()}")
    if residual is not None and not _same_layout(residual, x):
        return ValueError(f"bn_act: residual {tuple(residual.shape)} {residual.stride()} must "
                          f"have x's shape and strides, {tuple(x.shape)} {x.stride()}")
    if x.numel() >= MAX_ELEMENTS:
        return ValueError(f"bn_act: {x.numel()} elements, the kernel takes fewer than 2^31")
    return None


def _same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same shape and the same strides, but for those of size-1 axes."""
    return a.shape == b.shape and all(sa == sb for sa, sb, n in zip(a.stride(), b.stride(), a.shape)
                                      if n > 1)


def bn_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
           var: torch.Tensor, eps: float, act: str = "identity", channel_dim: int = 1,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eval BatchNorm, ``act`` and ``+ residual`` in one call of the op
    ``cfpnet::bn_act``; raises on what the kernel does not take
    (``refusal``), on the CPU too."""
    return bn_act_op(x, weight, bias, mean, var, float(eps), act, channel_dim, residual)


@torch.library.custom_op("cfpnet::bn_act", mutates_args=(), device_types="cuda")
def bn_act_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
              var: torch.Tensor, eps: float, act: str, channel_dim: int,
              residual: Optional[torch.Tensor]) -> torch.Tensor:
    """The op: the kernel on a CUDA tensor (``_launch``), the plain twin on a
    CPU one; ``torch.export`` keeps it as one node."""
    return _launch(x, weight, bias, mean, var, eps, act, channel_dim, residual)


@bn_act_op.register_kernel("cpu")
def _(x, weight, bias, mean, var, eps, act, channel_dim, residual):
    _check(x, weight, bias, mean, var, act, channel_dim, residual)
    return bn_act_plain(x, weight, bias, mean, var, eps, act, channel_dim, residual)


@bn_act_op.register_fake
def _(x, weight, bias, mean, var, eps, act, channel_dim, residual):
    _check(x, weight, bias, mean, var, act, channel_dim, residual)
    return traced_output("bn_act", x, torch.preserve_format)


def _check(*args) -> None:
    err = refusal(*args)
    if err is not None:
        raise err


_fns = {}


def _kernel(dtype: torch.dtype):
    """The C entry point for ``dtype``, its ctypes signature set once."""
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(build.load("bn_act"), f"cfp_bn_act_{DTYPES[dtype]}")
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_uint, ctypes.c_int,
                                                ctypes.c_uint, ctypes.c_int]
                       + [ctypes.c_uint] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        _fns[dtype] = fn
    return fn


def _launch(x, weight, bias, mean, var, eps, act, channel_dim, residual):
    _check(x, weight, bias, mean, var, act, channel_dim, residual)
    if x.device.type != "cuda":
        raise ValueError(f"bn_act: the kernel takes tensors on a CUDA device, got {x.device}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    C, inner = memory_layout(x, channel_dim)
    ptrs = [t.data_ptr() for t in (x, residual, weight, bias, mean, var, out) if t is not None]
    p = launch_plan(x.numel(), C, inner, 16 // x.element_size(), all(a % 16 == 0 for a in ptrs))
    rc = _kernel(x.dtype)(
        x.data_ptr(), 0 if residual is None else residual.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), mean.data_ptr(), var.data_ptr(), out.data_ptr(), x.numel(), C,
        MODES.index(p["mode"]), p["items"], p["blocks"], inner, p["inner_mul"], p["inner_shift"],
        p["c_mul"], p["c_shift"], eps, ACTS.index(act),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bn_act kernel launch failed: cudaError {rc}")
    count_launch("bn_act", x.dtype)
    return out


def bytes_moved(n: int, C: int, element_size: int, residual: bool) -> int:
    """Bytes a call over n elements of C channels must move at least: x (and
    the shortcut) read once, y written once, the four [C] parameters once."""
    return element_size * (n * (3 if residual else 2) + 4 * C)
