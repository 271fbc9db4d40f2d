"""The inputs of the ``cfpnet`` family (``families/cfpnet.py::inputs``):
synthetic scenes and their ToF zone histograms, made in bulk on the host
from the run's seed.

A frozen copy of a sound generator, vectorized over frames: the scenes of
``cfpnet_torch/data/datasets.py::SyntheticDataset`` (depth a smooth field of
sines and cosines with per-frame frequencies, a little noise and 1% of
pixels invalid; the image the normalized depth in grey plus colour noise,
normalized with the ImageNet statistics) and the VL53L5CX zone simulation
of ``cfpnet_torch/data/tof_sim.py`` (the reference loader's
``src/utils/dataloader.py:65-134``: per-zone histograms of 4 cm bins, bin 0
and a noise floor of 20 removed, the strongest contiguous cluster kept, its
mean and spread expanded to the zone's depth samples), with the train-time
zone dropout and depth noise of ``src/dataloader/nyu.py:155-163``.

Every seed gives the same shapes and the same amount of work; only the
content differs.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

BIN_WIDTH = 0.04
NOISE_FLOOR = 20.0
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def scenes(rng: np.random.Generator, n: int, h: int, w: int, max_depth: float):
    """(depth [n,h,w], image [n,h,w,3] in [0, 1]) of ``n`` synthetic frames."""
    yy = np.arange(h, dtype=np.float32)[None, :, None]
    xx = np.arange(w, dtype=np.float32)[None, None, :]
    f1 = rng.uniform(10, 60, n).astype(np.float32)[:, None, None]
    f2 = rng.uniform(10, 60, n).astype(np.float32)[:, None, None]
    dep = 1.0 + 1.3 * np.sin(yy / f1) ** 2 + 1.1 * np.cos(xx / f2) ** 2
    dep = dep + 0.03 * rng.standard_normal((n, h, w), dtype=np.float32)
    dep = np.clip(dep, 0.05, max_depth).astype(np.float32)
    dep[rng.random((n, h, w), dtype=np.float32) < 0.01] = 0.0
    grey = (dep / dep.max(axis=(1, 2), keepdims=True))[..., None]
    img = grey * 0.5 + 0.25 * rng.random((n, h, w, 3), dtype=np.float32)
    return dep, np.clip(img, 0, 1).astype(np.float32)


def zone_moments(depth: np.ndarray, zone_num: int, patch_px: int, max_distance: float):
    """(mu/sigma [n,Z,2], mask [n,Z]) of each zone's strongest return."""
    n, h, w = depth.shape
    zn, p = zone_num, patch_px
    sy, sx = int((h - p * zn) / 2), int((w - p * zn) / 2)
    bins = int(max_distance / BIN_WIDTH)
    patches = (depth[:, sy:sy + p * zn, sx:sx + p * zn].reshape(n, zn, p, zn, p)
               .transpose(0, 1, 3, 2, 4).reshape(n * zn * zn, p * p))
    idx = np.minimum(np.floor(patches / BIN_WIDTH).astype(np.int64), bins - 1)
    valid = (patches >= 0.0) & (patches <= max_distance)
    zones = np.arange(n * zn * zn)[:, None] * bins
    hist = np.bincount((zones + idx)[valid], minlength=n * zn * zn * bins)
    hist = hist.reshape(-1, bins).astype(np.float32)
    hist[:, 0] = 0.0
    hist = np.clip(hist - NOISE_FLOOR, 0.0, None)
    # the largest contiguous run of non-empty bins (the first on a tie)
    nz = hist > 0
    starts = nz & ~np.pad(nz[:, :-1], ((0, 0), (1, 0)))
    run = np.cumsum(starts, axis=1) * nz
    rows = np.arange(hist.shape[0])[:, None] * (bins + 1)
    sums = np.bincount((rows + run).reshape(-1), weights=hist.reshape(-1),
                       minlength=hist.shape[0] * (bins + 1)).reshape(-1, bins + 1)
    hist = np.where(run == (np.argmax(sums[:, 1:], axis=1) + 1)[:, None], hist, 0.0)
    edges = np.arange(bins + 1, dtype=np.float64) * BIN_WIDTH
    dist = ((edges[1:] + edges[:-1]) / 2.0).astype(np.float32)[None]
    cnt = hist.sum(axis=1)
    mu = (dist * hist).sum(axis=1) / (cnt + 1e-9)
    sd = np.sqrt((hist * (dist - mu[:, None]) ** 2).sum(axis=1) / (cnt + 1e-9)) + 1e-9
    fh = np.stack([mu, sd], axis=1).astype(np.float32).reshape(n, zn * zn, 2)
    return fh, (cnt > 0).reshape(n, zn * zn)


def augment(fh, mask, rng: np.random.Generator, drop: float, noise_prob: float,
            noise_mean: float, noise_sigma: float):
    """Train-time zone dropout (drawn with replacement) and noise on the
    mean of valid zones, frame by frame."""
    fh, mask = fh.copy(), mask.copy()
    for f in range(fh.shape[0]):
        if drop > 1e-3:
            index = np.where(mask[f])[0]
            if len(index):
                mask[f, rng.choice(index, int(len(index) * drop))] = False
        if noise_prob > 1e-3:
            valid = np.where(mask[f])[0]
            sel = rng.random(len(valid)) < noise_prob
            noise = rng.normal(noise_mean, noise_sigma, len(valid))
            fh[f, valid[sel], 0] += noise[sel]
    return fh, mask


def samples(fh, mask, n_samples: int):
    """Each valid zone's ``n_samples`` depths, evenly over mu +- 3 sigma
    (``--sample_uniform``); invalid zones all zero."""
    t = np.linspace(0.0, 1.0, n_samples, dtype=np.float32)
    mu, sd = fh[..., :1], fh[..., 1:]
    pts = (mu - 3.0 * sd) * (1.0 - t) + (mu + 3.0 * sd) * t
    return np.where(mask[..., None], pts, 0.0).astype(np.float32)


def make(settings: Dict, mode: str, n: int, seed: int) -> Dict[str, np.ndarray]:
    """``n`` frames for ``mode`` ("train": the train crop with its zones and
    augmentation; else the native frame): ``image`` [n,H,W,3] normalized,
    ``depth`` [n,H,W,1], ``hist_data`` [n,Z,samples], ``mask`` [n,Z]."""
    s = settings
    if not s["sample_uniform"]:
        raise NotImplementedError("only --sample_uniform histograms are generated")
    rng = np.random.default_rng([int(seed), 1])
    if mode == "train":
        h, w, zn, patch = (s["input_height"], s["input_width"], s["train_zone_num"],
                           s["train_patch_px"])
    else:
        h, w, zn, patch = (s["native_height"], s["native_width"], s["eval_zone_num_cfg"],
                           s["eval_patch_px"])
    dep, img = scenes(rng, n, h, w, s["max_depth"])
    fh, mask = zone_moments(dep, zn, patch, s["simu_max_distance"])
    if mode == "train":
        fh, mask = augment(fh, mask, rng, s["drop_hist"], s["noise_prob"], s["noise_mean"],
                           s["noise_sigma"])
    return dict(image=((img - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32),
                depth=dep[..., None], hist_data=samples(fh, mask, s["zone_sample_num"]),
                mask=mask)
