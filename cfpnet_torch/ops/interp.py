"""Align-corners bilinear resize.

Port of ``cfpnet_tpu/ops/interp.py`` (``_interp_matrix``,
``resize_bilinear_align_corners``).
The resize is two small dense products with static interpolation matrices
built on the host, exactly as in the JAX package, so the two agree to the
last bit of the matrix entries (``F.interpolate`` computes its weights in
another order and would not).

Each matrix is copied to its device once, per (in size, out size, dtype,
device), and kept there: a copy from the host on every call would make the
forward wait for the card at each resize (a copy from pageable memory
synchronizes the stream) and could not be captured in a CUDA graph. The
copies are kept by ``device_constant``, which makes them outside any trace
(``torch.export``): a tensor a trace made is fake, and an eager call that
read it afterwards would compute on it.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Hashable

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) align-corners linear interpolation matrix.

    Matches torch align_corners=True: src coord = dst * (in-1)/(out-1);
    out==1 -> src 0.
    """
    m = np.zeros((out_size, in_size), dtype=np.float64)
    if in_size == 1 or out_size == 1:
        m[:, 0] = 1.0
        return m
    scale = (in_size - 1) / (out_size - 1)
    coord = np.arange(out_size, dtype=np.float64) * scale
    i0 = np.clip(np.floor(coord).astype(np.int64), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w1 = coord - i0
    rows = np.arange(out_size)
    m[rows, i0] += 1.0 - w1
    m[rows, i1] += w1
    return m


def device_constant(cache: Dict[Hashable, torch.Tensor], key: Hashable,
                    make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``cache[key]``, made by ``make()`` at its first call. Under a trace
    (``torch.export``) ``make()`` runs outside it, with the trace's modes
    off: the tensor kept is a real one, never a trace's fake stand-in, and
    the trace takes it in as a constant of its graph (a device constant in
    an exported program, not a copy from the host at each call)."""
    t = cache.get(key)
    if t is None:
        from torch.utils._python_dispatch import _disable_current_modes

        with _disable_current_modes():
            t = make()
        cache[key] = t
    return t


_DEVICE_MATRICES: Dict[tuple, torch.Tensor] = {}


def _device_matrix(in_size: int, out_size: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """``_interp_matrix`` cast once to ``dtype`` on ``device``; shared by
    every call, never written."""
    return device_constant(
        _DEVICE_MATRICES, (in_size, out_size, dtype, device),
        lambda: torch.as_tensor(_interp_matrix(in_size, out_size), dtype=dtype, device=device))


def _matrix(in_size: int, out_size: int, like: torch.Tensor) -> torch.Tensor:
    return _device_matrix(in_size, out_size, like.dtype, like.device)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear align-corners resize on the (-3, -2) axes of an NHWC tensor."""
    h, w = x.shape[-3], x.shape[-2]
    if h != out_h:
        x = torch.einsum("oh,...hwc->...owc", _matrix(h, out_h, x), x)
    if w != out_w:
        x = torch.einsum("pw,...hwc->...hpc", _matrix(w, out_w, x), x)
    return x


def row_window(in_size: int, out_size: int, a: int, b: int):
    """``(lo, hi)``: the input rows that output rows ``[a, b)`` of a resize
    from ``in_size`` to ``out_size`` weigh (their matrix rows' nonzero
    columns); ``(0, 0)`` for no output rows."""
    if a >= b:
        return 0, 0
    cols = np.flatnonzero(_interp_matrix(in_size, out_size)[a:b].any(axis=0))
    return int(cols[0]), int(cols[-1]) + 1


def resize_rows_align_corners(window: torch.Tensor, in_h: int, out_h: int, a: int, b: int,
                              lo: int) -> torch.Tensor:
    """Output rows ``[a, b)`` of the align-corners resize along the rows
    (axis -3) of a map of ``in_h`` rows to ``out_h``, from ``window``, the
    map's rows ``[lo, lo + window.shape[-3])`` that ``row_window`` names:
    the rows of ``resize_bilinear_align_corners``' first product."""
    m = _matrix(in_h, out_h, window)[a:b, lo:lo + window.shape[-3]]
    return torch.einsum("oh,...hwc->...owc", m, window)
