"""ToF zone-histogram simulation (VL53L5CX model).

Port (a copy) of ``cfpnet_tpu/data/tof_sim.py``. ``get_hist`` runs the
host C++ kernel (``data/native.py``, ``csrc/host/tofsim.cpp``) where it is
built and enabled, else the vectorized numpy version below, which agrees
with it to float rounding; ``native.active()`` says which runs.

Numerically matches the reference host pipeline
(reference src/utils/dataloader.py:65-134) but replaces its per-zone
python ``torch.histc`` loop and ``np.split`` cluster search (reference
:106-118) with one-shot vectorized numpy over all zones:

1. rasterize per-zone depth histograms (0.04 m bins over [0, max_distance]),
2. zero bin 0, subtract the noise floor (20) and clip,
3. keep only the largest contiguous non-zero cluster per zone (strongest
   return; first-max tie-breaking like ``np.argmax``),
4. fit (mu, sigma) by histogram moments,
5. expand each valid zone to ``zone_sample_num`` depth samples (uniform
   linspace over mu±3sigma, or Gaussian inverse-CDF quantiles).

These run on the host (feeding the device pipeline); every op is O(zones ×
bins) vectorized so the 12-worker process pool the reference needs
(reference nyu.py:48-52) is unnecessary.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .geometry import ZoneGeometry

BIN_WIDTH = 0.04
NOISE_FLOOR = 20.0


def zone_histograms(
    depth: np.ndarray, geom: ZoneGeometry, max_distance: float
) -> np.ndarray:
    """Per-zone depth histograms.

    depth: (H, W) float32 metric depth. Returns (Z, bins) float32.
    Matches ``torch.histc(x, bins, min=0, max=max_distance)`` per zone
    (reference src/utils/dataloader.py:103-106): values outside [0, max] are
    dropped; the last bin is closed on the right.
    """
    bins = int(max_distance / BIN_WIDTH)
    zn = geom.zone_num
    ph, pw = geom.patch_px_h, geom.patch_px_w
    sy, sx = geom.sy_px, geom.sx_px

    region = depth[sy : sy + ph * zn, sx : sx + pw * zn]
    # (zn, ph, zn, pw) -> (Z, ph*pw)
    patches = region.reshape(zn, ph, zn, pw).transpose(0, 2, 1, 3).reshape(zn * zn, -1)

    idx = np.floor(patches / BIN_WIDTH).astype(np.int64)
    valid = (patches >= 0.0) & (patches <= max_distance)
    idx = np.minimum(idx, bins - 1)  # histc: v == max -> last bin
    zone_ids = np.repeat(np.arange(zn * zn, dtype=np.int64), patches.shape[1])
    flat = zone_ids * bins + idx.reshape(-1)
    hist = np.bincount(flat[valid.reshape(-1)], minlength=zn * zn * bins)
    return hist.reshape(zn * zn, bins).astype(np.float32)


def strongest_cluster(hist: np.ndarray) -> np.ndarray:
    """Keep only the largest contiguous non-zero cluster per zone.

    Vectorized equivalent of the reference's per-zone ``np.split`` loop
    (src/utils/dataloader.py:112-118): ties broken by first occurrence
    (np.argmax semantics).
    """
    Z, B = hist.shape
    nz = hist > 0
    starts = nz & ~np.pad(nz[:, :-1], ((0, 0), (1, 0)), constant_values=False)
    run_id = np.cumsum(starts, axis=1) * nz  # 0 = not in a run; runs numbered 1..K
    run_sums = np.zeros((Z, B + 1), dtype=hist.dtype)
    zi = np.broadcast_to(np.arange(Z)[:, None], (Z, B))
    np.add.at(run_sums, (zi.reshape(-1), run_id.reshape(-1)), hist.reshape(-1))
    best = np.argmax(run_sums[:, 1:], axis=1) + 1  # first max, runs in order
    return np.where(run_id == best[:, None], hist, 0.0)


def fit_moments(
    hist: np.ndarray, max_distance: float
) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) by histogram moments + valid mask.

    Matches reference src/utils/dataloader.py:120-131 (including the 1e-9
    regularizers).
    """
    bins = hist.shape[1]
    edges = np.arange(bins + 1, dtype=np.float64) * BIN_WIDTH
    dist = ((edges[1:] + edges[:-1]) / 2.0).astype(np.float32)[None, :]
    n = hist.sum(axis=1)
    mask = n > 0
    mu = (dist * hist).sum(axis=1) / (n + 1e-9)
    var = (hist * (dist - mu[:, None]) ** 2).sum(axis=1) / (n + 1e-9)
    std = np.sqrt(var) + 1e-9
    return np.stack([mu, std], axis=1).astype(np.float32), mask


def get_hist(
    depth: np.ndarray,
    geom: ZoneGeometry,
    max_distance: float = 4.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """depth (H, W) -> (fh (Z,2) mu/sigma, fr (Z,4) rects, mask (Z,) bool).

    Equivalent of ``get_hist_parallel`` (reference
    src/utils/dataloader.py:83-134) minus the torch tensor plumbing.
    Dispatches to the C++ kernel (``data/native.py``) when it is built.
    """
    from .native import native_get_hist

    res = native_get_hist(depth, geom, max_distance, BIN_WIDTH, NOISE_FLOOR)
    if res is not None:
        fh, mask = res
        return fh, geom.zone_rects(), mask
    hist = zone_histograms(depth, geom, max_distance)
    hist[:, 0] = 0.0
    hist = np.clip(hist - NOISE_FLOOR, 0.0, None)
    hist = strongest_cluster(hist)
    fh, mask = fit_moments(hist, max_distance)
    return fh, geom.zone_rects(), mask


def sample_points(
    fh: np.ndarray,
    mask: np.ndarray,
    zone_sample_num: int,
    sample_uniform: bool = True,
) -> np.ndarray:
    """Expand per-zone (mu, sigma) to ``zone_sample_num`` depth samples.

    Matches ``sample_point_from_hist_parallel`` (reference
    src/utils/dataloader.py:65-80). Invalid zones are all-zero.
    """
    Z = fh.shape[0]
    out = np.zeros((Z, zone_sample_num), dtype=np.float32)
    mu, sigma = fh[:, 0], fh[:, 1]
    if sample_uniform:
        t = np.linspace(0.0, 1.0, zone_sample_num, dtype=np.float32)[None, :]
        start = (mu - 3.0 * sigma)[:, None]
        end = (mu + 3.0 * sigma)[:, None]
        # reference tensor_linspace (src/utils/dataloader.py:43-58):
        # start*(1-t) + end*t
        samples = start * (1.0 - t) + end * t
    else:
        samples = (
            mu[:, None]
            + sigma[:, None] * _std_normal_icdf_grid(zone_sample_num)[None, :]
        ).astype(np.float32)
    out[mask] = samples[mask]
    return out


def _std_normal_icdf_grid(zone_sample_num: int) -> np.ndarray:
    """Standard-normal inverse-CDF quantile grid (f64) for the reference's
    non-``sample_uniform`` mode: evenly spaced quantiles over
    [delta, 1-delta], delta=1e-3 (reference src/utils/dataloader.py:68-72),
    through torch's ``ndtri``, the kernel the reference's
    ``torch.distributions.Normal.icdf`` dispatches to."""
    delta = 1e-3
    q = np.arange(delta, 1, (1 - 2 * delta) / (zone_sample_num - 1))[
        :zone_sample_num
    ]
    return torch.special.ndtri(torch.from_numpy(q)).numpy()


def augment_hist(
    fh: np.ndarray,
    mask: np.ndarray,
    rng: np.random.Generator,
    drop_hist: float = 0.0,
    noise_prob: float = 0.0,
    noise_mean: float = 0.0,
    noise_sigma: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Train-time hist augmentation: zone dropout + mu noise.

    Matches reference src/dataloader/nyu.py:155-163 semantics (dropout
    sampled with replacement; noise applied to mu of valid zones w.p.
    noise_prob).
    """
    fh = fh.copy()
    mask = mask.copy()
    if drop_hist > 1e-3:
        index = np.where(mask)[0]
        if len(index) > 0:
            drop = rng.choice(index, int(len(index) * drop_hist))
            mask[drop] = False
    if noise_prob > 1e-3:
        valid = np.where(mask)[0]
        prob = rng.random(len(valid))
        noise = rng.normal(noise_mean, noise_sigma, len(valid))
        sel = prob < noise_prob
        fh[valid[sel], 0] += noise[sel]
    return fh, mask


def zone_subset_slice(zone_type: str, full_zn: int) -> slice | None:
    """Central sub-grid selection for zone ablations.

    Matches reference nyu.py:166-177 / zjuL5.py:107-132:
    8x8 -> identity; 6x6 -> rows/cols 1:7; 4x4 -> 2:6; 2x2 -> 3:5 of an 8x8
    grid (train 2x2 -> 2:4 of a 6x6 grid).
    """
    sub = int(zone_type.split("x")[0])
    if sub >= full_zn:  # '8x8' (or larger) on an <=8-grid = no ablation
        return None
    lo = (full_zn - sub) // 2
    return slice(lo, lo + sub)


def apply_zone_subset(fh, fr, mask, zone_type: str):
    """Select the central ``zone_type`` sub-grid of the zone arrays."""
    full_zn = int(math.isqrt(mask.shape[0]))
    sl = zone_subset_slice(zone_type, full_zn)
    if sl is None:
        return fh, fr, mask
    keep = np.zeros((full_zn, full_zn), dtype=bool)
    keep[sl, sl] = True
    keep = keep.reshape(-1)
    return fh[keep], fr[keep], mask[keep]
