"""Fused LoFTR-layer CUDA kernel: wrapper, launch count, plain twin and
gradient.

Port of the TPU kernel ``cfpnet_tpu/ops/pallas_loftr.py::fused_loftr``
(``_fused_loftr_impl``, kernel ``_kernel``, custom VJP ``_fused_bwd``). The
kernel is ``cfpnet_torch/csrc/fused_loftr.cu`` in f32 (3xTF32 products) and
``cfpnet_torch/csrc/fused_loftr_bf16.cu`` in bf16 (bf16 tensor-core
products); its plain version is ``cfpnet_torch/ops/loftr.py::loftr_apply``.

``fused_loftr(x, source, p, nhead)`` takes x [N, L, C], source [N, S, C]
and ``LoFTRParams`` whose matrices are [in, out] views of [out, in]
storage, as ``LoFTREncoderLayer.loftr_params`` gives them (the kernel reads
the ``nn.Linear`` weights as they are stored), all float32 or all bfloat16
(the bf16 variant rounds where the Pallas kernel does: the message before
the merge, LN1's output, the ReLU output and the output; its products are
bf16 x bf16 with f32 sums). It is the ``torch.library`` op
``cfpnet::fused_loftr`` (the weights a list in ``LoFTRParams`` order): a
CPU tensor goes through the plain version, a CUDA tensor through the
kernel or raises, and ``torch.export`` keeps the call as one node.

One wrapper call is two kernel launches on the card (the per-group KV
summary, then the row pass, which starts before the summary ends by
programmatic dependent launch and waits for it only where it reads the
summary); ``launches`` counts wrapper calls that launched. The gradient,
registered on the op, is that of the plain version, recomputed from the
saved inputs, as the JAX package's custom VJP takes the VJP of
``loftr_apply_xla``; in bf16 that of the bf16 plain version, so the
gradients come back in bf16.

``launch_plan(N, L, S, C, H, dtype)`` is a call's geometry: row tiles of
``tm`` rows, clusters of ``cl`` blocks, the clusters (blocks at ``cl`` = 1)
of the row pass and the shared bytes of each pass, and the summary pass's
split of the source rows over a cluster. The bf16 C entry point takes it at
each call; the f32 one computes the same itself (``csrc/fused_loftr.cu``:
``RowTiles``, and its occupancy query), which the plan describes. The
plans are checked on the CPU (``tests/test_torch_port_loftr_plan.py``).
"""

from __future__ import annotations

import ctypes
import functools
from types import MappingProxyType
from typing import List, Mapping

import torch
from torch.utils.flop_counter import register_flop_formula

from ..ops.loftr import LoFTRParams, loftr_apply
from . import build
from .dtypes import check_dtypes, count_launch, dtype_name, meta, plain_flops, traced_output
from .dwconv import (MAX_THREADS_PER_SM, REGISTERS_PER_SM, SMEM_PER_BLOCK, SMEM_PER_SM,
                     SMEM_RESERVED, SMS)

SUPPORTED_C = (32, 64, 128)
SUPPORTED_HEADS = (4, 8)
THREADS = 256  # a block of either pass
# The bf16 row-pass variants the library builds, per C (for each of its two
# head widths): (tile rows, blocks a cluster); csrc/fused_loftr_bf16.cu,
# CFP_BF16_ROW_VARIANTS.
ROW_VARIANTS_BF16 = {32: ((64, 1), (128, 1)), 64: ((32, 1), (64, 1)), 128: ((32, 2), (64, 2))}
# The row pass's tile heights: (blocks a cluster, the heights tried for one
# round, lowest first, the height for several rounds). A call takes the
# first one-round height whose tiles all fit one round of the resident
# clusters (a second, nearly empty round costs a whole tile's latency
# again), else the several-rounds height. In bf16 the plan's rule
# (bench_dwconv.py --sweep, PERF.md: at C = 64, two blocks an SM, 32-row
# tiles balance the rounds better; at C = 32, three blocks an SM, and at
# C = 128, one, the taller tile spreads its barriers over more rows); in
# f32 csrc/fused_loftr.cu's (RowTiles, RowCfg::CL).
ROW_TILES = {torch.bfloat16: {32: (1, (64, 128), 128), 64: (1, (32, 64), 32),
                              128: (2, (32, 64), 64)},
             torch.float32: {32: (1, (64,), 64), 64: (1, (32,), 64), 128: (4, (48,), 48)}}
# bf16 summary blocks aimed at where the groups are many: each block then
# walks ceil(N * HG / SUM_BLOCKS) groups of its head group, its weights
# staged once
SUM_BLOCKS = 4 * SMS
# Clusters of (cl, blocks an SM) resident at once on the H100's 132 SMs
# (cudaOccupancyMaxActiveClusters on the card; cfp_fused_loftr_bf16_resident)
CLUSTERS_RESIDENT = {(2, 1): 66, (4, 1): 30}


def row_smem(C: int, D: int, tm: int, cl: int, dtype: torch.dtype) -> int:
    """Dynamic shared bytes of a row-pass block (``RowCfg::kSmem`` of the
    dtype's source), 1024 of them for the swizzle's alignment."""
    oc, oh = C // cl, 2 * C // cl
    if dtype == torch.float32:
        scratch = tm * max(2 * C + 4, C + 4 + oc)
        return 1024 + 4 * (2 * oc * C + oh * 2 * C + oc * 2 * C + tm * (2 * C + 4) + scratch)
    weights = 2 * (2 * oc * C + oh * 2 * C + oc * 2 * C)
    region = max(2 * tm * (2 * C + 8), 2 * tm * (C + 8) + 4 * tm * oc)
    return 1024 + weights + 2 * tm * (2 * C + 8) + region + 8 * tm * ln_slots(tm, oc, cl)


def ln_slots(tm: int, oc: int, cl: int) -> int:
    """Partial statistics a row of the bf16 LayerNorm products (``LnTiles::
    SLOTS``): the fewest 8-column tiles a warp tile (2, 4, ...) that leave no
    more warp tiles than the 8 warps, times the warp tiles across a row of
    the cluster."""
    nt = 2
    while oc // 8 % nt or tm // 16 * (oc // 8 // nt) > THREADS // 32:
        nt *= 2
        if nt > oc // 8:
            raise ValueError(f"fused_loftr: {tm}-row tiles over {oc} columns need more than "
                             f"one warp tile a warp in the LayerNorm products")
    return cl * (oc // 8 // nt)


def summary_smem(C: int, D: int, dtype: torch.dtype) -> int:
    """Dynamic shared bytes of a summary block (``SumCfg::kSmem``)."""
    ow = max(D, 16)
    hb = ow // D
    ts = 160 if C == 32 else 8192 // C
    items = hb * D * (D + 1) // 4
    r = 1 if items >= THREADS else THREADS // items
    sums = 4 * ts * ow * 2 + 16 * r * items + 4 * hb * (D * D + D)
    if dtype == torch.float32:
        return 4 * 2 * ow * C + 4 * ts * (C + 4) + sums
    return 1024 + 2 * 2 * ow * C + 2 * ts * (C + 8) + sums


def _blocks_per_sm(smem: int, min_blocks: int) -> int:
    """Row-pass blocks an SM holds: by shared memory, threads, and registers
    at the launch bound's cap (ptxas may use fewer)."""
    regs = min(255, REGISTERS_PER_SM // (THREADS * min_blocks) // 8 * 8)
    return min(SMEM_PER_SM // (smem + SMEM_RESERVED), MAX_THREADS_PER_SM // THREADS,
               REGISTERS_PER_SM // (THREADS * regs))


def _row_units(C: int, D: int, tm: int, cl: int, dtype: torch.dtype):
    """(shared bytes, blocks an SM, resident clusters or blocks) of a row
    variant. The launch bound asks for as many blocks an SM as fit, up to
    three (bf16), or for two at C = 32 (f32), else one."""
    smem = row_smem(C, D, tm, cl, dtype)
    if dtype == torch.float32:
        min_blocks = 2 if C == 32 else 1
    else:
        min_blocks = max(1, min(3, SMEM_PER_SM // (smem + SMEM_RESERVED)))
    per_sm = _blocks_per_sm(smem, min_blocks)
    return smem, per_sm, SMS * per_sm if cl == 1 else CLUSTERS_RESIDENT[(cl, per_sm)]


@functools.lru_cache(maxsize=256)
def launch_plan(N: int, L: int, S: int, C: int, H: int,
                dtype: torch.dtype = torch.bfloat16) -> Mapping:
    """The launch of one call on x [N, L, C], source [N, S, C], H heads, in
    ``dtype``; read-only, computed once per shape.

    Row pass: ``tm``-row tiles (``tiles`` of them) walked by ``units``
    clusters of ``cl`` blocks (``grid`` blocks; at most the ``resident``
    clusters the card holds at once, ``blocks_per_sm`` blocks an SM, in
    ``rounds`` rounds), each block holding ``cols`` output columns, ``heads``
    whole heads, in ``smem`` shared bytes; ``tm`` by ``ROW_TILES``.
    Summary pass: ``sum_blocks`` blocks of ``sum_smem`` bytes, the source
    rows split over clusters of ``sum_split`` where there are fewer than 64
    (group, head group) pairs; in bf16 without a split each block takes
    ``sum_groups`` groups of its head group (f32: one). Raises ValueError with the kernel's reason
    for what it does not take."""
    if dtype not in ROW_TILES:
        raise TypeError(f"fused_loftr: {dtype}; the kernel takes {tuple(ROW_TILES)}")
    if C not in SUPPORTED_C or H not in SUPPORTED_HEADS:
        raise ValueError(f"fused_loftr: C={C}, {H} heads; the kernel takes C in "
                         f"{SUPPORTED_C} with {SUPPORTED_HEADS} heads")
    if min(N, L, S) < 1:
        raise ValueError("fused_loftr: empty sequence")
    D = C // H
    NL = N * L
    cl, one_round, several = ROW_TILES[dtype][C]
    tm = next((h for h in one_round if -(-NL // h) <= _row_units(C, D, h, cl, dtype)[2]),
              several)
    smem, per_sm, resident = _row_units(C, D, tm, cl, dtype)
    cols = C // cl
    if cols % D:
        raise ValueError(f"fused_loftr: {cols} columns a block do not hold whole heads of {D}")
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"fused_loftr: {smem} shared bytes a block; the card has "
                         f"{SMEM_PER_BLOCK}")
    tiles = -(-NL // tm)
    units = min(resident, tiles)
    hg = C // max(D, 16)
    split = max(1, min(8, -(-S // 16))) if N * hg < 64 else 1
    groups = 1
    if dtype == torch.bfloat16 and split == 1:
        groups = -(-N * hg // SUM_BLOCKS)
    return MappingProxyType(dict(
        dtype=dtype_name(dtype), cl=cl, tm=tm, tiles=tiles, units=units,
        grid=cl * units, resident=resident, blocks_per_sm=per_sm, rounds=-(-tiles // units),
        cols=cols, heads=cols // D, smem=smem, sum_split=split, sum_groups=groups,
        sum_blocks=hg * split * -(-N // groups), sum_smem=summary_smem(C, D, dtype)))


_fns = {}


def _kernel(dtype: torch.dtype):
    """The C entry point for ``dtype``, its ctypes signature set once: the
    f32 one takes the shape, the bf16 one also the plan."""
    fn = _fns.get(dtype)
    if fn is None:
        if dtype == torch.bfloat16:
            fn = build.load("fused_loftr_bf16").cfp_fused_loftr_bf16
            ints = 10
        else:
            fn = build.load("fused_loftr").cfp_fused_loftr_f32
            ints = 5
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * ints
                       + [ctypes.c_float, ctypes.c_void_p])
        _fns[dtype] = fn
    return fn


def resident(C: int, D: int, tm: int, cl: int) -> int:
    """Resident clusters (blocks at cl = 1) of the bf16 row variant (C, D,
    tm, cl) on the current card, by its occupancy query."""
    fn = build.load("fused_loftr_bf16").cfp_fused_loftr_bf16_resident
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    units = ctypes.c_int(0)
    rc = fn(C, D, tm, cl, ctypes.byref(units))
    if rc != 0:
        raise RuntimeError(f"fused_loftr: occupancy of ({C}, {D}, {tm}, {cl}): cudaError {rc}")
    return units.value


def fused_loftr(x: torch.Tensor, source: torch.Tensor, p: LoFTRParams, nhead: int,
                eps: float = 1e-6) -> torch.Tensor:
    """One unmasked LoFTR encoder layer. x: [N, L, C]; source: [N, S, C].
    Returns [N, L, C]; differentiable in x, source and every weight. One
    call of the op ``cfpnet::fused_loftr``."""
    return fused_loftr_op(x, source, list(p), nhead, eps)


@torch.library.custom_op("cfpnet::fused_loftr", mutates_args=(), device_types="cuda")
def fused_loftr_op(x: torch.Tensor, source: torch.Tensor, weights: List[torch.Tensor],
                   nhead: int, eps: float) -> torch.Tensor:
    """The op, its ten weights in ``LoFTRParams`` order: the kernel on a
    CUDA tensor (``_launch``, which allocates its KV scratch itself), the
    plain version on a CPU one; ``torch.export`` keeps it as one node."""
    return _launch(x, source, LoFTRParams(*weights), nhead, eps)


@fused_loftr_op.register_kernel("cpu")
def _(x, source, weights, nhead, eps):
    return loftr_apply(x, source, LoFTRParams(*weights), nhead, eps)


@fused_loftr_op.register_fake
def _(x, source, weights, nhead, eps):
    return traced_output("fused_loftr", x)


def _setup_context(ctx, inputs, output):
    x, source, weights, nhead, eps = inputs
    ctx.save_for_backward(x, source, *weights)
    ctx.nhead, ctx.eps = nhead, eps


def _backward(ctx, grad):
    """The gradient of the plain version, recomputed from the saved inputs."""
    saved = [t.detach().requires_grad_() for t in ctx.saved_tensors]
    with torch.enable_grad():
        out = loftr_apply(saved[0], saved[1], LoFTRParams(*saved[2:]), ctx.nhead, ctx.eps)
        grads = torch.autograd.grad(out, saved, grad)
    return grads[0], grads[1], list(grads[2:]), None, None


fused_loftr_op.register_autograd(_backward, setup_context=_setup_context)


@register_flop_formula(torch.ops.cfpnet.fused_loftr)
def _flop_formula(x_shape, source_shape, weight_shapes, nhead, eps, out_shape=None,
                  **kwargs) -> int:
    """The operations ``torch.utils.flop_counter`` counts in the plain
    version at these shapes (to the counter the op is one node, which it
    would count as nothing)."""
    return plain_flops(loftr_apply, meta(x_shape), meta(source_shape),
                       LoFTRParams(*map(meta, weight_shapes)), nhead, eps)


def _launch(x, source, p, nhead, eps):
    _check(x, source, p, nhead)
    N, L, C = x.shape
    S = source.shape[1]
    D = C // nhead
    out = torch.empty_like(x)
    kv = torch.empty(N * nhead * (D * D + D), device=x.device, dtype=torch.float32)
    plan = ()
    if x.dtype == torch.bfloat16:
        pl = launch_plan(N, L, S, C, nhead, x.dtype)
        plan = (pl["tm"], pl["cl"], pl["units"], pl["sum_split"], pl["sum_blocks"])
    rc = _kernel(x.dtype)(
        x.data_ptr(), source.data_ptr(), *(w.data_ptr() for w in p), out.data_ptr(),
        kv.data_ptr(), N, L, S, C, D, *plan, eps,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_loftr kernel launch failed: cudaError {rc}")
    count_launch("fused_loftr", x.dtype)
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
        # 4 elements (16 bytes in f32); in bf16 the weights 16 bytes, which
        # the TMA and the summary's 16-byte loads need
        align = 16 if t.dtype == torch.bfloat16 and name in shapes else 4 * t.element_size()
        if t.data_ptr() % align:
            raise ValueError(f"fused_loftr: {name} must be aligned to {align} bytes")
