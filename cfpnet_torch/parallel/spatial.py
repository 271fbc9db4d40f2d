"""Spatial partitioning: one process drives a ``dp x sp`` grid of devices,
the batch split over ``dp`` data groups and image rows over ``sp`` shards.

Port of the 2-D half of ``cfpnet_tpu/parallel/mesh.py`` (``make_mesh_2d``,
``shard_batch_spatial``, ``shard_batch_spatial_presplit``). The JAX package
hands a ``('data', 'spatial')`` sharded array to the unchanged jitted step
and GSPMD inserts the halo exchanges; here the model walks its row-sharded
form (the modules' ``forward_rows``) and every exchange is written out as a
read of other shards' rows (``rows``). The results are those of the one-device
forward up to the order of the sums.

A row-sharded map is a list over the data groups of lists over the shards,
``X[d][s]``, each a tensor on ``grid.device(d, s)`` holding that group's
images and the shard's rows of the map. Each map of height ``H`` is split
by ``row_bounds(H, sp)``: the shards' row counts differ by at most one, and
a shard may own no rows (2 rows over 4 shards). Non-image leaves of a batch
(histograms, masks) are lists over the data groups.

Single-controller, as in JAX: in a process group of more than one process
``check_single_process`` raises ``NotImplementedError``. A ``devices`` list
may repeat a device (``["cpu"] * 4``, ``["cuda:0"] * 2``): the library's way
to run a grid on fewer devices than it has cells; the command lines take
the cards there are.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.interp import resize_bilinear_align_corners, resize_rows_align_corners, row_window
from .mesh import world_size

Rows = List[List[torch.Tensor]]  # X[d][s]


@dataclass(frozen=True)
class Grid:
    """A ``dp x sp`` grid of devices: cell ``(d, s)`` is
    ``devices[d * sp + s]`` (JAX's ``reshape(dp, sp)``); ``root``,
    ``devices[0]``, holds the model, the whole-batch work and the sums."""
    dp: int
    sp: int
    devices: Tuple[torch.device, ...]

    def device(self, d: int, s: int) -> torch.device:
        return self.devices[d * self.sp + s]

    @property
    def root(self) -> torch.device:
        return self.devices[0]


def available_devices(device) -> List[torch.device]:
    """The devices a command line may put a grid on: every card where
    ``device`` is a card, else ``device`` alone."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def check_single_process() -> None:
    if world_size() > 1:
        raise NotImplementedError(
            "spatial partitioning is single-controller; use shard_batch for multi-host DP")


def make_mesh_2d(dp: int, sp: int, devices: Optional[Sequence] = None,
                 batch_size: Optional[int] = None) -> Grid:
    """The ``dp x sp`` grid over the first ``dp * sp`` of ``devices``
    (default: every card), with JAX's errors (``mesh.py:72-88``)."""
    if dp < 1 or sp < 1:
        raise ValueError(f"mesh axes must be >= 1, got dp={dp} sp={sp}")
    devices = [torch.device(d) for d in (available_devices("cuda") if devices is None
                                         else devices)]
    if dp * sp > len(devices):
        raise ValueError(f"mesh {dp}x{sp} needs {dp * sp} devices, have {len(devices)}")
    if batch_size is not None and batch_size % dp != 0:
        raise ValueError(f"batch {batch_size} not divisible by dp={dp}")
    return Grid(dp, sp, tuple(devices[:dp * sp]))


def data_axis(sp: int, n_devices: int, unit: int, dp: int = 0, what: str = "eval",
              flag: str = "--eval_bs") -> int:
    """The data axis of a spatial run (JAX ``loop.py:94-109, 372-388``):
    ``dp`` where given, else every device over ``sp``, then down to a
    divisor of ``unit`` (the batch, or the microbatch under
    ``--grad_accum``), saying how many devices stay idle."""
    n = dp or max(1, n_devices // sp)
    while n > 1 and unit % n != 0:
        n -= 1
    idle = n_devices - n * sp
    if idle > 0:
        print(f"spatial {what} mesh: dp={n} x sp={sp} uses {n * sp} of {n_devices} devices "
              f"({idle} idle) — pick {flag} divisible by {n_devices // sp} to use the full "
              f"mesh")
    return n


def row_bounds(H: int, sp: int) -> List[int]:
    """Shard ``s`` of a map of ``H`` rows owns rows ``[b[s], b[s + 1])``."""
    return [s * H // sp for s in range(sp + 1)]


def height(X: Rows, dim: int = 2) -> int:
    return sum(x.shape[dim] for x in X[0])


def rows(parts: Sequence[torch.Tensor], a: int, b: int, device, dim: int = 2) -> torch.Tensor:
    """Global rows ``[a, b)`` of one data group's row-sharded map on
    ``device``, zeros outside ``[0, H)``: every halo and every gather."""
    pieces, start = [], 0
    ref = parts[0]
    H = sum(p.shape[dim] for p in parts)

    def zeros(n):
        shape = list(ref.shape)
        shape[dim] = n
        return torch.zeros(shape, dtype=ref.dtype, device=device)

    if a < 0:
        pieces.append(zeros(min(b, 0) - a))
    for p in parts:
        lo, hi = max(a, start), min(b, start + p.shape[dim])
        if lo < hi:
            pieces.append(p.narrow(dim, lo - start, hi - lo).to(device))
        start += p.shape[dim]
    if b > H:
        pieces.append(zeros(b - max(a, H)))
    if not pieces:
        return zeros(0)
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)


def gather(X: Rows, device, dim: int = 2) -> torch.Tensor:
    """The whole map, every data group's images in order, on ``device``."""
    H = height(X, dim)
    return torch.cat([rows(parts, 0, H, device, dim) for parts in X])


def scatter(x: torch.Tensor, grid: Grid, dim: int = 2) -> Rows:
    """A whole map split onto the grid: the inverse of ``gather``."""
    bounds = row_bounds(x.shape[dim], grid.sp)
    groups = x.chunk(grid.dp) if grid.dp > 1 else (x,)
    return [[g.narrow(dim, bounds[s], bounds[s + 1] - bounds[s]).to(grid.device(d, s))
             for s in range(grid.sp)] for d, g in enumerate(groups)]


def each(fn: Callable, *Xs: Rows) -> Rows:
    """``fn`` shard by shard over maps of the same partition."""
    return [[fn(*xs) for xs in zip(*groups)] for groups in zip(*Xs)]


def sum_to(tensors, device) -> torch.Tensor:
    """The sum of ``tensors`` (one a shard) on ``device``: the cross-shard
    sum of a statistic, differentiable through the copies."""
    tensors = [t.to(device) for t in tensors]
    out = tensors[0]
    for t in tensors[1:]:
        out = out + t
    return out


def image_means(X: Rows, grid: Grid) -> torch.Tensor:
    """[B, C] on the root: each image's mean of an NCHW map over all its
    rows and columns, summed in float32 or wider, in the map's dtype."""
    H, W = height(X), X[0][0].shape[3]
    dtype = X[0][0].dtype
    acc = torch.promote_types(dtype, torch.float32)
    sums = [sum_to([x.sum((2, 3), dtype=acc) for x in parts], grid.root) for parts in X]
    return (torch.cat(sums) / (H * W)).to(dtype)


def per_group(fn: Callable, X: Rows, t: torch.Tensor, grid: Grid) -> Rows:
    """``fn(shard, rows of t)`` for a per-image ``t`` of the whole batch:
    each shard gets its data group's images of ``t`` on its device."""
    groups = t.chunk(grid.dp) if grid.dp > 1 else (t,)
    return [[fn(x, g.to(x.device)) for x in parts] for parts, g in zip(X, groups)]


def conv2d_rows(conv: nn.Conv2d, X: Rows, pad_top: Optional[int] = None,
                pad_w: Optional[Tuple[int, int]] = None,
                out_h: Optional[int] = None) -> Rows:
    """``conv`` over a row-sharded NCHW map. Output row ``r`` reads input
    rows ``r * stride - pad_top`` to ``r * stride - pad_top + k - 1``, zeros
    outside the map, so each shard convolves its own window of the map
    (``rows``) with no padding of its rows. Defaults: ``conv``'s own
    symmetric padding."""
    kh, kw = conv.kernel_size
    sh, sw = conv.stride
    H, W = height(X), X[0][0].shape[3]
    if pad_top is None:
        pad_top, pad_w = conv.padding[0], (conv.padding[1],) * 2
        out_h = (H + 2 * pad_top - kh) // sh + 1
    out_w = (W + pad_w[0] + pad_w[1] - kw) // sw + 1
    bounds = row_bounds(out_h, len(X[0]))
    out = []
    for parts in X:
        group = []
        for s, x in enumerate(parts):
            a, b = bounds[s], bounds[s + 1]
            w = conv.weight.to(x.device)
            bias = None if conv.bias is None else conv.bias.to(x.device)
            if a == b:
                group.append(x.new_zeros((x.shape[0], w.shape[0], 0, out_w),
                                         dtype=torch.promote_types(x.dtype, w.dtype)))
                continue
            window = rows(parts, a * sh - pad_top, (b - 1) * sh - pad_top + kh, x.device)
            if pad_w != (0, 0):
                window = F.pad(window, (pad_w[0], pad_w[1], 0, 0))
            group.append(F.conv2d(window, w, bias, (sh, sw), 0, conv.dilation, conv.groups))
        out.append(group)
    return out


def resize_rows(X: Rows, out_h: int, out_w: int) -> Rows:
    """Align-corners bilinear resize of a row-sharded NHWC map to
    ``out_h x out_w`` (``ops/interp.py::resize_bilinear_align_corners``):
    each output shard takes its rows of the interpolation matrix and reads
    the input rows they weigh."""
    h = height(X, 1)
    if h != out_h:
        bounds = row_bounds(out_h, len(X[0]))
        out = []
        for parts in X:
            group = []
            for s, x in enumerate(parts):
                a, b = bounds[s], bounds[s + 1]
                lo, hi = row_window(h, out_h, a, b)
                group.append(resize_rows_align_corners(rows(parts, lo, hi, x.device, dim=1),
                                                       h, out_h, a, b, lo))
            out.append(group)
        X = out
    if X[0][0].shape[2] != out_w:
        X = each(lambda x: resize_bilinear_align_corners(x, x.shape[1], out_w), X)
    return X


def apply_rows(module: nn.Module, X: Rows, grid: Grid) -> Rows:
    """``module`` over a row-sharded NCHW map: its ``forward_rows`` where it
    has one, ``conv2d_rows`` for a convolution, in turn for a
    ``Sequential``, and shard by shard for a pointwise activation."""
    if hasattr(module, "forward_rows"):
        return module.forward_rows(X, grid)
    if isinstance(module, nn.Conv2d):
        return conv2d_rows(module, X)
    if isinstance(module, nn.Sequential):
        return chain(module, X, grid)
    if isinstance(module, (nn.LeakyReLU, nn.ReLU, nn.SiLU)):
        return each(module, X)
    raise NotImplementedError(f"no row-sharded form of {type(module).__name__}")


def chain(modules, X: Rows, grid: Grid) -> Rows:
    """``apply_rows`` of each of ``modules`` in turn."""
    for m in modules:
        X = apply_rows(m, X, grid)
    return X


def shard_batch_spatial(batch: Dict[str, torch.Tensor], grid: Grid) -> Dict[str, object]:
    """A batch on the grid: every 4-D ``[B, H, W, C]`` leaf row-sharded
    (``X[d][s]``, dim 1), every other leaf a list over the data groups,
    each on its group's first device. JAX's errors for a batch that ``dp``
    does not divide and rows that ``sp`` does not divide."""
    check_single_process()
    for k, v in batch.items():
        if v.dim() >= 1 and v.shape[0] % grid.dp != 0:
            raise ValueError(f"batch[{k!r}] has batch dim {v.shape[0]} — not divisible by "
                             f"the {grid.dp}-way 'data' mesh axis")
        if v.dim() == 4 and v.shape[1] % grid.sp != 0:
            raise ValueError(f"batch[{k!r}] has {v.shape[1]} rows — not divisible by the "
                             f"{grid.sp}-way 'spatial' mesh axis; pick --spatial_shards from "
                             f"the divisors of the image height")
    out = {}
    for k, v in batch.items():
        if v.dim() == 4:
            out[k] = scatter(v, grid, dim=1)
        else:
            out[k] = [g.to(grid.device(d, 0))
                      for d, g in enumerate(v.chunk(grid.dp) if grid.dp > 1 else (v,))]
    return out


def shard_batch_spatial_presplit(batch: Dict[str, torch.Tensor], grid: Grid,
                                 accum: int) -> List[Dict[str, object]]:
    """``--grad_accum``'s microbatches on the grid: microbatch ``i`` is the
    batch's rows ``[i * mb, (i + 1) * mb)`` (JAX's host pre-split,
    ``mesh.py:151-190``), each through ``shard_batch_spatial``. JAX's
    errors, the microbatch's divisibility by ``dp`` included."""
    check_single_process()
    for k, v in batch.items():
        if v.dim() < 1 or v.shape[0] % accum != 0:
            raise ValueError(f"batch[{k!r}] batch dim {tuple(v.shape[:1])} not divisible by "
                             f"--grad_accum {accum}")
        mb = v.shape[0] // accum
        if mb % grid.dp != 0:
            raise ValueError(f"batch[{k!r}] microbatch size {mb} not divisible by the "
                             f"{grid.dp}-way 'data' mesh axis (bs={v.shape[0]}, "
                             f"grad_accum={accum})")
        if v.dim() == 4 and v.shape[1] % grid.sp != 0:
            raise ValueError(f"batch[{k!r}] has {v.shape[1]} rows — not divisible by the "
                             f"{grid.sp}-way 'spatial' mesh axis")
    mb = next(iter(batch.values())).shape[0] // accum
    return [shard_batch_spatial({k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}, grid)
            for i in range(accum)]


def whole(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """A leaf split over the data groups, whole on ``device``."""
    return torch.cat([p.to(device) for p in parts])
