"""Align-corners bilinear resize.

Port of ``cfpnet_tpu/ops/interp.py`` (``_interp_matrix``,
``resize_bilinear_align_corners``).
The resize is two small dense products with static interpolation matrices
built on the host, exactly as in the JAX package, so the two agree to the
last bit of the matrix entries (``F.interpolate`` computes its weights in
another order and would not).
"""

from __future__ import annotations

import functools

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


def _matrix(in_size: int, out_size: int, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(_interp_matrix(in_size, out_size), dtype=like.dtype,
                           device=like.device)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear align-corners resize on the (-3, -2) axes of an NHWC tensor."""
    h, w = x.shape[-3], x.shape[-2]
    if h != out_h:
        x = torch.einsum("oh,...hwc->...owc", _matrix(h, out_h, x), x)
    if w != out_w:
        x = torch.einsum("pw,...hwc->...hpc", _matrix(w, out_w, x), x)
    return x
