"""Large-kernel depthwise-conv CUDA kernel: wrapper, launch plan, launch count
and plain twin.

Port of the TPU kernel ``cfpnet_tpu/ops/pallas_dwconv.py::
depthwise_conv2d_pallas``. The kernel is ``cfpnet_torch/csrc/dwconv.cu``;
its plain version is ``cfpnet_torch/ops/dwconv.py::depthwise_conv2d``.

``depthwise_conv2d(x, weight, bias)`` takes x [B, H, W, C] (NHWC, the
fusion path's token layout, so no permute), weight [C, 1, k, k] (torch
depthwise layout) and bias [C]. A CPU tensor goes through the plain
version; a CUDA tensor goes through the kernel or raises. The gradient
(``_DepthwiseConv2d``) takes dx from the same kernel on the rotated taps and
dW from one PyTorch call (its depthwise weight-gradient kernel) on NCHW
copies.

``TILING`` holds the one choice of tiling per k; ``kernels/build.py``
compiles its fixed part into the kernel (``nvcc_defines``), and
``launch_plan(B, H, W, C, k)`` derives from it the tile, grid and
shared-memory pitches that each launch passes, so the plan is checked on
the CPU (``tests/test_torch_port_dwconv.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from types import MappingProxyType
from typing import Mapping, NamedTuple, Optional

import torch

from ..ops.dwconv import depthwise_conv2d as depthwise_conv2d_plain
from . import build

SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_PER_BLOCK = 232_448  # bytes of shared memory a block may use
SMEM_PER_SM = 233_472  # bytes an SM holds for its blocks
SMEM_RESERVED = 1_024  # bytes the runtime keeps per resident block
MAX_BLOCKS_PER_SM = 32
MAX_THREADS_PER_SM = 2_048
REGISTERS_PER_SM = 65_536


class Tiling(NamedTuple):
    """How the kernel covers a k x k conv: a thread computes ``ry`` rows x
    ``rx`` columns of one channel over 1/``ns`` of the kernel columns; a block
    has ns x 4 x ``ty`` x ``cb`` threads (``ty`` even, ``cb`` a power of two
    >= 4) and owns a (ty*ry) x (4*rx) tile of cb channels. ``max_threads`` is
    the kernel's launch bound (the most threads a block, and so the most
    registers a thread), ``f4`` the float4 loads a thread keeps in flight
    while it stages."""
    rx: int
    ry: int
    ty: int
    cb: int
    ns: int
    max_threads: int
    f4: int


# Chosen on the card among the tilings that keep all blocks of the main-path
# grid resident at once (PERF.md, the dwconv step table). rx, ry, ns,
# max_threads and f4 are compiled into csrc/dwconv.cu (nvcc_defines); ty and
# cb, with the pitches, are passed at each launch.
TILING = {31: Tiling(8, 2, 10, 8, 2, 640, 16), 15: Tiling(4, 2, 10, 8, 2, 640, 8),
          7: Tiling(4, 1, 6, 8, 1, 512, 8)}
SUPPORTED_K = tuple(TILING)

# kernel launches since the last reset_launches(): a forward call launches
# once, and its backward once more for dx (the flipped taps), so a train step
# of the production model launches 6 times for the outputs and 6 for dx
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def bank_groups(rx: int, ry: int, pitch: int, swz: int, band: int) -> list:
    """Bank groups (16-byte slots mod 8) that the 8 lanes of a quarter warp,
    4 columns (lx) x 2 consecutive thread rows (ly), reach with one float4
    window load, where ``band`` (0 or 1) is the parity of the first lane's
    band of ``ry`` input rows: row y starts at y*pitch + swz*((y // ry) % 2)."""
    return [(lx * rx // 4 + (b * ry * pitch + ((b + band) % 2) * swz) // 4) % 8
            for b in range(2) for lx in range(4)]


def conflict_free(rx: int, ry: int, pitch: int, swz: int) -> bool:
    return all(len(set(bank_groups(rx, ry, pitch, swz, band))) == 8 for band in range(2))


def split_column(k: int, ns: int) -> int:
    """The kernel columns of the first split (csrc/dwconv.cu's D): all k, or
    about half, rounded up to whole float4s."""
    return k if ns == 1 else _round4((k + 1) // 2)


def splits(k: int, ns: int) -> list:
    """The kernel columns [start, start + length) of each of ns splits."""
    d = split_column(k, ns)
    return [(0, d)] if ns == 1 else [(0, d), (d, k - d)]


def nvcc_defines() -> tuple:
    """The compile-time part of TILING as nvcc flags for csrc/dwconv.cu, one
    ``-DCFP_DWCONV_<NAME>_<k>=<value>`` a value (nvcc splits a -D at its
    commas)."""
    return tuple(f"-DCFP_DWCONV_{name}_{k}={value}" for k, t in TILING.items()
                 for name, value in (("RX", t.rx), ("RY", t.ry), ("NS", t.ns),
                                     ("D", split_column(k, t.ns)),
                                     ("MAXT", t.max_threads), ("F4", t.f4)))


@functools.lru_cache(maxsize=64)
def launch_plan(B: int, H: int, W: int, C: int, k: int) -> Mapping:
    """The launch for x [B, H, W, C] and a k x k kernel, read-only (computed
    once per shape and shared by the calls): the tiling, the kernel's
    per-call arguments (ty, cb, pitch, swz, plane, wplane) and what they
    imply for the grid. ``blocks_per_sm`` bounds the registers a thread by
    the launch bound ``max_threads`` (ptxas may use fewer), ``waves`` is the
    grid over the blocks the 132 SMs hold at once, ``balance`` the mean SM's
    share of the blocks over the busiest SM's, ``useful`` the share of the
    tiles' outputs inside the map."""
    t = TILING[k]
    rx, ry, ty, cb, ns = t.rx, t.ry, t.ty, t.cb, t.ns
    tw, th = 4 * rx, ty * ry
    # floats from a row's start to the end of the last thread's float4 window
    window = max(3 * rx + d0 + _round4(rx + n - 1) for d0, n in splits(k, ns))
    pitch, swz = min((p, s) for s in (0, 4) for p in range(window + s, window + s + 64, 4)
                     if conflict_free(rx, ry, p, s))
    plane = (th + k - 1) * pitch + swz
    while (plane // 4) % 2 == 0:  # the four planes a 16-byte staging store fills, apart
        plane += 4
    wplane = k * _round4(k)
    while (wplane // 4) % 2 == 0:
        wplane += 4
    threads = ns * 4 * ty * cb
    smem = 4 * cb * (plane + wplane)
    tiles_x, tiles_y, cgroups = -(-W // tw), -(-H // th), -(-C // cb)
    blocks = tiles_x * tiles_y * cgroups * B
    regs = min(255, REGISTERS_PER_SM // t.max_threads // 8 * 8)
    per_sm = min(SMEM_PER_SM // (smem + SMEM_RESERVED), MAX_THREADS_PER_SM // threads,
                 MAX_BLOCKS_PER_SM, REGISTERS_PER_SM // (threads * regs))
    return MappingProxyType(dict(
        rx=rx, ry=ry, ty=ty, cb=cb, ns=ns, pitch=pitch, swz=swz, plane=plane, wplane=wplane,
        tile=(th, tw), threads=threads, smem_bytes=smem, grid=(tiles_x * tiles_y, cgroups, B),
        blocks=blocks, blocks_per_sm=per_sm, waves=blocks / (SMS * per_sm),
        balance=blocks / (SMS * math.ceil(blocks / SMS)),
        useful=H * W * C / (tiles_y * th * tiles_x * tw * cgroups * cb)))


_fn = None


def _kernel():
    """The C entry point, its ctypes signature set once."""
    global _fn
    if _fn is None:
        fn = build.load("dwconv").cfp_dwconv2d_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        _fn = fn
    return _fn


def depthwise_conv2d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME-padded stride-1 depthwise conv plus bias, NHWC; differentiable
    in x, weight and bias."""
    return _DepthwiseConv2d.apply(x, weight, bias)


def _conv(x, weight, bias):
    """The forward conv: the plain version for a CPU tensor, else the kernel."""
    if x.device.type == "cpu":
        return depthwise_conv2d_plain(x, weight, bias)
    return _launch(x, weight, bias)


class _DepthwiseConv2d(torch.autograd.Function):
    """The conv and its gradient, as the JAX package's XLA path takes it (the
    TPU kernel has no VJP):

    - dx: the same conv of dy with the taps rotated by 180 degrees and no
      bias: for odd k and symmetric SAME padding the transpose of a
      correlation is the correlation with the rotated taps, so the forward
      kernel computes it (a second launch a call on the card);
    - dW: one PyTorch call, ``torch.nn.grad.conv2d_weight``, where XLA
      computes it in the JAX package, on NCHW copies of x and dy: PyTorch
      then runs its own depthwise weight-gradient kernel, while on the
      channels-last views it hands the call to cuDNN, 13 times slower at
      k = 31 on the train step's maps (PERF.md, per-call train table); the
      plain twin's autograd would be k*k full-size passes;
    - db: dy summed over batch, rows and columns.
    """

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return _conv(x, weight, bias)

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        gy = gy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _conv(gy, weight.flip(-1, -2), None)
        if ctx.needs_input_grad[1]:
            k, C = weight.shape[-1], weight.shape[0]
            dw = torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2).contiguous(), weight.shape,
                gy.permute(0, 3, 1, 2).contiguous(), padding=k // 2, groups=C)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = gy.sum((0, 1, 2))
        return dx, dw, db


def _launch(x, weight, bias):
    _check(x, weight, bias)
    global launches
    B, H, W, C = x.shape
    k = weight.shape[-1]
    p = launch_plan(B, H, W, C, k)
    out = torch.empty_like(x)
    rc = _kernel()(x.data_ptr(), weight.data_ptr(), 0 if bias is None else bias.data_ptr(),
                   out.data_ptr(), B, H, W, C, k, p["ty"], p["cb"], p["pitch"], p["swz"],
                   p["plane"], p["wplane"], torch.cuda.current_stream(x.device).cuda_stream)
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
    if C % 4 != 0:
        raise ValueError(f"dwconv: the kernel reads 4-channel groups; C={C} is not a multiple of 4")
    for name, t in (("x", x), ("weight", weight)):
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"dwconv: {name} must be 16-byte aligned")
