"""ToF simulation and train-time augmentation on the device (``--device_pipeline``).

Port of ``cfpnet_tpu/data/tof_sim_jax.py``: flip, photometric augmentation,
ImageNet normalization, zone histograms, strongest cluster, moments, zone
dropout and mu noise, and point sampling, over a whole batch in PyTorch on
the batch's device. The host then only decodes and crops
(``data/datasets.py`` ships ``image_raw`` and ``depth``), and NYU ships its
crops in uint8.

The random draws are split from the transform: ``draw_augmentations`` makes
every draw the JAX function makes, from a ``torch.Generator`` on the
device, and ``device_preprocess(img, depth, draws, geom, ...)`` is
deterministic. The tests feed it the draws of the JAX key splits.

Numerics as ``tof_sim_jax.py``:
- histc: bins ``min(floor(x * (1 / BIN_WIDTH)), bins - 1)``, only pixels with
  ``0 <= x <= max`` count; counted in integers (``scatter_add_`` on int32,
  invalid pixels to a discard bin), so the counts are exact and the same
  under deterministic algorithms;
- noise floor 20 subtracted after zeroing bin 0;
- the largest contiguous non-zero run of each zone, ties to the first
  (``argmax``), its run sums counted in integers;
- moments with the 1e-9 regularizers;
- the drop count ``floor(n * drop_hist)`` from an exact float64 table.

Constants go to the device once per device and shape (``_on_device``); the
transform makes no copy to the host and no sync.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.interp import device_constant
from ..parallel import mesh
from .datasets import IMAGENET_MEAN, IMAGENET_STD
from .geometry import ZoneGeometry
from .tof_sim import BIN_WIDTH, NOISE_FLOOR, _std_normal_icdf_grid


def _centers(bins: int) -> np.ndarray:
    return (np.arange(bins, dtype=np.float32) + np.float32(0.5)) * np.float32(BIN_WIDTH)


def _grid(zone_sample_num: int, sample_uniform: bool) -> np.ndarray:
    """``jnp.linspace(0, 1, n)`` as it is in float32 (k times the float32
    1 / (n - 1), the last exactly 1), or the inverse-CDF grid."""
    if not sample_uniform:
        return _std_normal_icdf_grid(zone_sample_num).astype(np.float32)
    step = np.float32(1.0) / np.float32(max(zone_sample_num - 1, 1))
    grid = np.arange(zone_sample_num, dtype=np.float32) * step
    grid[-1] = 1.0
    return grid


def _drop_table(zones: int, drop_hist: float) -> np.ndarray:
    """``p_eff`` by valid-zone count n = 0..zones, as ``augment_hist_jax``:
    m = floor(n * drop_hist) in float64, 1 - (1 - 1/n)^m in float32, 0 at
    n = 0."""
    n = np.arange(zones + 1)
    m = np.floor(n * np.float64(drop_hist)).astype(np.float32)
    one = np.float32(1.0)
    p = one - (one - one / np.maximum(n, 1).astype(np.float32)) ** m
    return np.where(n > 0, p, np.float32(0.0)).astype(np.float32)


def _reciprocal(x) -> np.ndarray:
    return np.float32(1.0) / np.asarray(x, np.float32)


# XLA compiles a division by a constant as the product with its float32
# reciprocal; the transform does the same, so that it bins, scales and
# normalizes as the JAX function does bit for bit
INV_BIN_WIDTH = float(_reciprocal(BIN_WIDTH))  # 25.0
INV_U8 = float(_reciprocal(255.0))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32, as XLA contracts it inside a fused
    program: the float64 product of two float32 values is exact, and the
    one float64 rounding of the sum before the float32 one matters only at
    a float32 tie (once in about 2^29). For the small [B, Z, n] tensors of
    the sampling."""
    return torch.addcmul(c.double(), a.double(), b.double()).float()


_ON_DEVICE: Dict[tuple, torch.Tensor] = {}


def _on_device(device: torch.device, make, *args) -> torch.Tensor:
    """``make(*args)`` (float32) copied to ``device`` once
    (``ops/interp.py::device_constant``: never one a trace made)."""
    return device_constant(
        _ON_DEVICE, (device, make, *args),
        lambda: torch.from_numpy(np.ascontiguousarray(make(*args), np.float32)).to(device))


def _zone_patches(depth: torch.Tensor, geom: ZoneGeometry) -> torch.Tensor:
    """[B, H, W] -> [B, Z, patch_px] zone pixel groups (static slices)."""
    zn, ph, pw = geom.zone_num, geom.patch_px_h, geom.patch_px_w
    region = depth[:, geom.sy_px: geom.sy_px + ph * zn, geom.sx_px: geom.sx_px + pw * zn]
    B = region.shape[0]
    z = region.reshape(B, zn, ph, zn, pw).permute(0, 1, 3, 2, 4)
    return z.reshape(B, zn * zn, ph * pw)


def zone_histograms(depth: torch.Tensor, geom: ZoneGeometry,
                    max_distance: float = 4.0) -> torch.Tensor:
    """[B, H, W] depth -> [B, Z, bins] float32 histograms (histc semantics),
    counted in int32."""
    bins = int(max_distance / BIN_WIDTH)
    patches = _zone_patches(depth, geom)  # [B, Z, P]
    B, Z, P = patches.shape
    idx = torch.floor(patches * INV_BIN_WIDTH).to(torch.int64)
    idx = torch.clamp(idx, max=bins - 1)  # histc: x == max -> the last bin
    valid = (patches >= 0.0) & (patches <= max_distance)
    cell = torch.arange(B * Z, device=depth.device).view(B, Z, 1) * bins
    discard = B * Z * bins
    flat = torch.where(valid, cell + idx, discard).reshape(-1)
    counts = torch.zeros(discard + 1, dtype=torch.int32, device=depth.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return counts[:discard].view(B, Z, bins).to(torch.float32)


def strongest_cluster(hist: torch.Tensor) -> torch.Tensor:
    """[..., bins] -> only the largest contiguous non-zero run of each row
    kept (ties to the first). The values must be whole numbers (counts):
    the run sums are taken in int32."""
    bins = hist.shape[-1]
    flat = hist.reshape(-1, bins)
    nz = flat > 0
    starts = nz.clone()
    starts[:, 1:] &= ~nz[:, :-1]
    run_id = torch.cumsum(starts.to(torch.int64), dim=-1) * nz  # 0 = no run
    sums = torch.zeros((flat.shape[0], bins + 1), dtype=torch.int32, device=hist.device)
    sums.scatter_add_(1, run_id, flat.to(torch.int32))
    best = torch.argmax(sums[:, 1:], dim=-1) + 1
    keep = run_id == best[:, None]
    return flat.masked_fill(~keep, 0.0).reshape(hist.shape)


def get_hist(depth: torch.Tensor, geom: ZoneGeometry,
             max_distance: float = 4.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W] -> (fh [B, Z, 2] mu and sigma, mask [B, Z])."""
    bins = int(max_distance / BIN_WIDTH)
    hist = zone_histograms(depth, geom, max_distance)
    hist[..., 0] = 0.0
    hist = torch.clamp(hist - NOISE_FLOOR, min=0.0)
    hist = strongest_cluster(hist)
    centers = _on_device(depth.device, _centers, bins)
    n = hist.sum(dim=-1)
    mask = n > 0
    mu = (hist * centers).sum(dim=-1) / (n + 1e-9)
    var = (hist * (centers - mu[..., None]) ** 2).sum(dim=-1) / (n + 1e-9)
    sigma = torch.sqrt(var) + 1e-9
    return torch.stack([mu, sigma], dim=-1), mask


def sample_points(fh: torch.Tensor, mask: torch.Tensor, zone_sample_num: int,
                  sample_uniform: bool = True) -> torch.Tensor:
    """Per-zone (mu, sigma) -> [B, Z, n] depth samples, invalid zones 0:
    ``start * (1 - t) + end * t`` over mu ± 3 sigma (``sample_uniform``), or
    ``mu + sigma * z`` at the inverse-CDF grid of ``tof_sim.py``."""
    grid = _on_device(fh.device, _grid, zone_sample_num, bool(sample_uniform))
    mu, sg = fh[..., 0:1], fh[..., 1:2]
    if sample_uniform:
        start, end = mu - 3.0 * sg, mu + 3.0 * sg
        # start * (1 - t) + end * t, the sum fused as the JAX function's
        pts = _fma(end, grid, start * (1.0 - grid))
    else:
        pts = _fma(sg, grid, mu)
    return pts.masked_fill(~mask[..., None], 0.0)


def augment_hist(fh: torch.Tensor, mask: torch.Tensor, draws: Dict[str, torch.Tensor],
                 drop_hist: float, noise_prob: float, noise_mean: float,
                 noise_sigma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-time zone dropout and mu noise (reference nyu.py:155-163), as
    ``augment_hist_jax``: each valid zone dropped i.i.d. with the
    with-replacement marginal ``1 - (1 - 1/n)^floor(n * drop_hist)`` (n the
    sample's valid zones; ``draws["drop"]`` below it drops), then
    ``noise_mean + noise_sigma * draws["noise_normal"]`` added to mu where
    ``draws["noise_hit"] < noise_prob``."""
    if drop_hist > 1e-3:
        p_eff = _on_device(mask.device, _drop_table, mask.shape[-1], float(drop_hist))
        n_valid = mask.sum(dim=-1, keepdim=True)
        mask = mask & (draws["drop"] >= p_eff[n_valid])
    if noise_prob > 1e-3:
        hit = draws["noise_hit"] < noise_prob
        noise = noise_mean + noise_sigma * draws["noise_normal"]
        mu = fh[..., 0] + noise.masked_fill(~(hit & mask), 0.0)
        fh = torch.stack([mu, fh[..., 1]], dim=-1)
    return fh, mask


def photometric_augment(img: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Gamma, brightness and color on [B, H, W, 3] 0..1 images (reference
    nyu.py:229-245), each sample with p = 0.5 (``draws["photo"] > 0.5``)."""
    do = (draws["photo"] > 0.5).to(img.dtype).view(-1, 1, 1, 1)
    gamma = draws["gamma"].view(-1, 1, 1, 1)
    bright = draws["brightness"].view(-1, 1, 1, 1)
    colors = draws["colors"].view(-1, 1, 1, 3)
    aug = torch.clamp((img ** gamma) * bright * colors, 0.0, 1.0)
    return do * aug + (1.0 - do) * img


def draw_augmentations(generator: torch.Generator, B: int, Z: int,
                       config) -> Dict[str, torch.Tensor]:
    """Every draw ``tof_sim_jax.device_preprocess`` makes in train mode,
    from ``generator`` on its device: ``flip`` and ``photo`` U(0,1) [B],
    ``gamma`` U(0.9,1.1), ``brightness`` U(0.75,1.25) [B], ``colors``
    U(0.9,1.1) [B, 3]; and, as the JAX function draws them only where
    ``config`` uses them, ``drop`` U(0,1) [B, Z] (``drop_hist > 1e-3``),
    ``noise_hit`` U(0,1) and ``noise_normal`` N(0,1) [B, Z]
    (``noise_prob > 1e-3``)."""
    kw = dict(generator=generator, device=generator.device, dtype=torch.float32)

    def uniform(shape, lo=0.0, hi=1.0):
        return torch.rand(shape, **kw) * (hi - lo) + lo

    draws = dict(flip=uniform((B,)), photo=uniform((B,)), gamma=uniform((B,), 0.9, 1.1),
                 brightness=uniform((B,), 0.75, 1.25), colors=uniform((B, 3), 0.9, 1.1))
    if config.drop_hist > 1e-3:
        draws["drop"] = uniform((B, Z))
    if config.noise_prob > 1e-3:
        draws["noise_hit"] = uniform((B, Z))
        draws["noise_normal"] = torch.randn((B, Z), **kw)
    return draws


def device_preprocess(img: torch.Tensor, depth: torch.Tensor,
                      draws: Optional[Dict[str, torch.Tensor]], geom: ZoneGeometry,
                      max_distance: float = 4.0, zone_sample_num: int = 16,
                      drop_hist: float = 0.0, noise_prob: float = 0.0, noise_mean: float = 0.0,
                      noise_sigma: float = 0.0, train: bool = True,
                      sample_uniform: bool = True) -> Dict[str, torch.Tensor]:
    """The device tail of the data pipeline: flip, photometric augmentation,
    normalize, ToF simulation, hist augmentation and point sampling.

    img [B, H, W, 3] uint8 (divided by 255 here) or float32 in 0..1; depth
    [B, H, W]; ``draws`` from ``draw_augmentations`` (None in eval mode).
    Returns image [B, H, W, 3] normalized, depth [B, H, W, 1] (flipped with
    the image), hist_data [B, Z, n] and mask [B, Z]."""
    if img.dtype == torch.uint8:
        img = img.to(torch.float32) * INV_U8
    if train:
        flip = draws["flip"] > 0.5
        img = torch.where(flip.view(-1, 1, 1, 1), img.flip(2), img)
        depth = torch.where(flip.view(-1, 1, 1), depth.flip(2), depth)
        img = photometric_augment(img, draws)
    mean = _on_device(img.device, np.asarray, tuple(IMAGENET_MEAN))
    norm = (img - mean) * _on_device(img.device, _reciprocal, tuple(IMAGENET_STD))
    fh, mask = get_hist(depth, geom, max_distance)
    if train:
        fh, mask = augment_hist(fh, mask, draws, drop_hist, noise_prob, noise_mean,
                                noise_sigma)
    pts = sample_points(fh, mask, zone_sample_num, sample_uniform)
    return dict(image=norm, depth=depth[..., None], hist_data=pts, mask=mask)


def preprocess_batch(batch: Dict[str, torch.Tensor], config, geom: ZoneGeometry,
                     generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A raw train batch (``image_raw``, ``depth`` [B, H, W, 1]) made into
    the train step's batch with ``config``'s distance, sampling and hist
    augmentation and draws from ``generator``, as the JAX loop's
    ``device_prep`` (``cfpnet_tpu/train/loop.py:486-500``): the simulation
    distance is ``simu_max_distance`` (``--random_simu_max_d`` is read by
    the host path only).

    In a data-parallel run the draws are the global batch's, as the JAX
    transform draws over the sharded global array: every process draws
    for all the rows from the same generator and keeps those of its own
    (``mesh.rank_rows``, the loader's layout)."""
    img = batch["image_raw"]
    world = mesh.world_size()
    draws = draw_augmentations(generator, img.shape[0] * world, geom.zone_num ** 2, config)
    if world > 1:
        rows = mesh.rank_rows(img.shape[0] * world, world, mesh.rank(),
                              int(config.grad_accum or 1))
        rows = torch.as_tensor(rows, device=img.device)
        draws = {k: v[rows] for k, v in draws.items()}
    out = device_preprocess(img, batch["depth"][..., 0], draws, geom,
                            max_distance=config.simu_max_distance,
                            zone_sample_num=config.zone_sample_num,
                            drop_hist=config.drop_hist, noise_prob=config.noise_prob,
                            noise_mean=config.noise_mean, noise_sigma=config.noise_sigma,
                            train=True, sample_uniform=config.sample_uniform)
    return dict(batch, **out)
