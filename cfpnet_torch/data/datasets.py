"""Datasets: the synthetic fixture and the shared sample tail.

Port of ``cfpnet_tpu/data/datasets.py`` (``normalize_image``,
``finalize_sample``, ``SyntheticDataset``, ``make_dataset``) and of
``cfpnet_tpu/data/pipeline.py::collate``. The NYUv2 and ZJUL5 loaders are
not ported yet: ``make_dataset`` raises for them.

Sample dict: image [H,W,3] f32 (normalized), depth [H,W,1] f32 (meters),
hist_data [Z,n] f32, mask [Z] bool, focal f32. Zone geometry is static (see
geometry.py) so no per-sample rect/patch_info tensors are shipped.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import tof_sim
from .geometry import geometry_for

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def normalize_image(img: np.ndarray) -> np.ndarray:
    return (img - IMAGENET_MEAN) / IMAGENET_STD


class SyntheticDataset:
    """Procedural RGB + depth with the real ToF simulation applied.

    Deterministic per index, and equal sample for sample to the JAX
    package's ``SyntheticDataset``.
    """

    def __init__(self, config, mode: str, length: int = 64):
        self.config = config
        self.mode = mode
        self.length = length

    def __len__(self):
        return self.length

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        cfg = self.config
        h, w = cfg.image_size_for(self.mode)
        rng = np.random.default_rng(cfg.seed * 1000003 + idx)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        f1, f2 = rng.uniform(10, 60), rng.uniform(10, 60)
        dep = 1.0 + 1.3 * np.sin(yy / f1) ** 2 + 1.1 * np.cos(xx / f2) ** 2
        dep += 0.03 * rng.standard_normal((h, w)).astype(np.float32)
        dep = np.clip(dep, 0.05, cfg.max_depth).astype(np.float32)
        dep[rng.random((h, w)) < 0.01] = 0.0  # invalid pixels
        img = np.stack(
            [dep / dep.max()] * 3, axis=-1
        ) * 0.5 + 0.25 * rng.random((h, w, 3)).astype(np.float32)
        img = np.clip(img, 0, 1).astype(np.float32)
        return finalize_sample(img, dep, 500.0, cfg, self.mode, rng)


def finalize_sample(
    img: np.ndarray,
    dep: np.ndarray,
    focal: float,
    cfg,
    mode: str,
    rng: np.random.Generator,
    offset=(0, 0),
) -> Dict[str, np.ndarray]:
    """Shared tail: normalize, ToF-simulate, augment, sample points.

    Float-valued sources (synthetic) ship the image normalized in f32
    (``image``), as the JAX package does for them."""
    geom = geometry_for(cfg, mode, offset)
    max_d = cfg.simu_max_distance
    if cfg.random_simu_max_d and mode == "train":
        max_d = float(rng.uniform(cfg.simu_min_d, cfg.simu_max_d))
    fh, fr, mask = tof_sim.get_hist(dep, geom, max_d)
    if mode == "train":
        fh, mask = tof_sim.augment_hist(
            fh, mask, rng,
            drop_hist=cfg.drop_hist, noise_prob=cfg.noise_prob,
            noise_mean=cfg.noise_mean, noise_sigma=cfg.noise_sigma,
        )
    if cfg.zone_type != f"{geom.zone_num}x{geom.zone_num}":
        fh, fr, mask = tof_sim.apply_zone_subset(fh, fr, mask, cfg.zone_type)
    pts = tof_sim.sample_points(fh, mask, cfg.zone_sample_num, cfg.sample_uniform)
    return dict(
        image=normalize_image(img).astype(np.float32),
        depth=dep[..., None].astype(np.float32),
        hist_data=pts,
        mask=mask,
        focal=np.float32(focal),
    )


def make_dataset(config, mode: str):
    name = config.dataset if mode == "train" else config.dataset_eval
    if name == "synthetic":
        length = getattr(config, "synthetic_length", 64)
        if mode != "train":
            length = min(length, 64)
        return SyntheticDataset(config, mode, length)
    raise NotImplementedError(f"dataset '{name}' is not ported yet")


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-sample dicts into a batch (``pipeline.py::collate``)."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
