"""Datasets: NYUv2, ZJUL5 and a synthetic fixture.

Port of ``cfpnet_tpu/data/datasets.py`` (``normalize_image``,
``sample_image_f32``, ``NYUV2Dataset``, ``ZJUL5Dataset``,
``SyntheticDataset``, ``finalize_sample``, ``make_dataset``) and of
``cfpnet_tpu/data/pipeline.py::collate``. Every sample equals the JAX
package's for the same files, config and generator: the same numpy and PIL
calls in the same order. The self-supervised pair datasets are not ported
(``make_dataset`` raises for ``--selfsup``).

Host-side decode and augmentation, as the reference pipelines:
- NYU train (reference src/dataloader/nyu.py:91-198): border crop 16/12 px,
  optional random rotation ±``degree`` (bilinear image, nearest depth),
  random crop to (input_height, input_width) in uint8, horizontal flip
  p=0.5, photometric augmentation p=0.5 (gamma U(0.9,1.1), brightness
  U(0.75,1.25), per-channel color U(0.9,1.1), clip [0,1]), ImageNet
  normalize, ToF simulation, hist dropout and noise, point sampling; all
  draws from the dataset's numpy generator.
- NYU eval (reference nyu.py:136-146): native 480x640, raw uint8 image
  (``image_u8``, normalized on the device by the eval step), ToF sim,
  ``has_valid_depth`` (a missing depth file is flagged, not raised).
- ZJUL5 (reference src/dataloader/zjuL5.py:74-155): h5 captures carry the
  real VL53L5CX hist_data/fr/mask; only sampling and the zone-subset
  ablation run. Captures are grouped by the signature of their measured
  zone rects (``geometry_groups``), one static geometry each.
- Synthetic: procedural RGB + depth with the real ToF simulation.

PIL and h5py are imported inside the methods that read files, so that the
package imports without them.

Sample dict: image [H,W,3] f32 (normalized) or image_u8 [H,W,3] uint8,
depth [H,W,1] f32 (meters), hist_data [Z,n] f32, mask [Z] bool, focal f32.
Under ``--device_pipeline`` a train sample is only ``image_raw`` (NYU: the
uint8 crop; synthetic: f32 in 0..1) and ``depth`` [H,W,1]: flip,
augmentation, normalization and the ToF simulation run on the device
(``data/tof_sim_device.py``, applied by ``train/loop.py``).
Zone geometry is static (see geometry.py) so no per-sample rect/patch_info
tensors are shipped.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from . import tof_sim
from .geometry import geometry_for, scales_from_rects

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

# camera intrinsics [fx, fy, cx, cy]
NYU_K = np.array(
    [518.8579, 519.4696, 325.5824 - 16.0, 253.7362 - 12.0], dtype=np.float32
)
ZJU_K = np.array([611.2, 609.6, 323.4, 244.9], dtype=np.float32)


def normalize_image(img: np.ndarray) -> np.ndarray:
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def sample_image_f32(sample) -> np.ndarray:
    """Normalized f32 image from a sample carrying either ``image`` (train:
    normalized f32) or ``image_u8`` (eval: raw uint8, normalized on the
    device by ``train/steps.py::make_eval_step``)."""
    if "image" in sample:
        return np.asarray(sample["image"], np.float32)
    u8 = np.asarray(sample["image_u8"], np.float32) / 255.0
    return normalize_image(u8).astype(np.float32)


def _entry_name(entry) -> str:
    return entry["filename"] if isinstance(entry, dict) else entry


class NYUV2Dataset:
    """NYUv2 depth completion with simulated ToF zone histograms.

    ``zone_offset`` (train) is the per-batch zone-grid shift that the
    ``DataLoader`` sets before it decodes a batch."""

    def __init__(self, config, mode: str):
        assert mode in ("train", "online_eval")
        self.config = config
        self.mode = mode
        self.rng = np.random.default_rng(config.seed)
        fname = config.filenames_file if mode == "train" else config.filenames_file_eval
        with open(fname, "r") as f:
            split = json.load(f)
        self.sample_list = split["train" if mode == "train" else "test"]
        self.data_root = config.data_path if mode == "train" else config.data_path_eval
        self.focal = float(NYU_K[0])
        self.zone_offset = 0

    def __len__(self):
        return len(self.sample_list)

    def sample_meta(self, idx):
        """(folder, name) of a sample, for per-image result dumps (reference
        evaluate_all.py:71-77)."""
        rgb_path, _ = self._paths(idx)
        folder = os.path.basename(os.path.dirname(rgb_path)) or "nyu"
        name = os.path.splitext(os.path.basename(rgb_path))[0]
        return folder, name

    def _paths(self, idx):
        # reference nyu.py:96-104: entries like 'sync/scene/00001.h5'; strip
        # the leading dir and swap in the rgb_/sync_depth_ files
        rel = "/".join(_entry_name(self.sample_list[idx]).split("/")[1:])
        base = os.path.join(self.data_root, rel)
        num = os.path.basename(base).split(".")[0]
        d = os.path.dirname(base)
        return os.path.join(d, f"rgb_{num}.jpg"), os.path.join(d, f"sync_depth_{num}.png")

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        from PIL import Image

        rgb_path, depth_path = self._paths(idx)
        image = Image.open(rgb_path)
        cfg = self.config
        has_valid_depth = True
        try:
            depth_gt = Image.open(depth_path)
        except (FileNotFoundError, OSError):
            if self.mode == "train":
                raise
            # flagged and skipped by the eval loop (reference train.py:179-181)
            has_valid_depth = False
            depth_gt = Image.new("I", image.size)

        if self.mode == "train":
            # border crop against registration artifacts (reference nyu.py:118-119)
            image = image.crop((16, 12, 640 - 16, 480 - 12))
            depth_gt = depth_gt.crop((16, 12, 640 - 16, 480 - 12))
            if cfg.do_random_rotate:
                angle = float((self.rng.random() - 0.5) * 2 * cfg.degree)
                image = image.rotate(angle, resample=Image.BILINEAR)
                depth_gt = depth_gt.rotate(angle, resample=Image.NEAREST)
            # crop in uint8: PIL's rotate gives uint8, the exact source of f32/255
            img_u8 = np.asarray(image, dtype=np.uint8)
            dep = np.asarray(depth_gt, dtype=np.float32) / 1000.0
            img_u8, dep = self._random_crop(img_u8, dep, cfg.input_height, cfg.input_width)
            if cfg.device_pipeline:  # the rest runs on the device
                return dict(image_raw=img_u8, depth=dep[..., None].astype(np.float32))
            img = img_u8.astype(np.float32) / 255.0
            img, dep = self._train_preprocess(img, dep)
        else:
            img = np.asarray(image, dtype=np.float32) / 255.0
            dep = np.asarray(depth_gt, dtype=np.float32) / 1000.0

        zo = int(self.zone_offset) if self.mode == "train" else 0
        sample = finalize_sample(img, dep, self.focal, cfg, self.mode, self.rng,
                                 exact_u8=True, offset=(zo, zo))
        if self.mode == "online_eval":
            sample["has_valid_depth"] = np.bool_(has_valid_depth)
        return sample

    def _random_crop(self, img, dep, h, w):
        y = int(self.rng.integers(0, img.shape[0] - h + 1))
        x = int(self.rng.integers(0, img.shape[1] - w + 1))
        return img[y : y + h, x : x + w], dep[y : y + h, x : x + w]

    def _train_preprocess(self, img, dep):
        if self.rng.random() > 0.5:
            img = img[:, ::-1].copy()
            dep = dep[:, ::-1].copy()
        if self.rng.random() > 0.5:
            img = self._augment_image(img)
        return img, dep

    def _augment_image(self, img):
        gamma = self.rng.uniform(0.9, 1.1)
        brightness = self.rng.uniform(0.75, 1.25)
        colors = self.rng.uniform(0.9, 1.1, size=3).astype(np.float32)
        img = np.clip((img**gamma) * brightness * colors[None, None, :], 0.0, 1.0)
        return img.astype(np.float32)


class ZJUL5Dataset:
    """Real VL53L5CX captures, hist precomputed in h5 (eval only).

    Each h5 also carries ``fr``, the sensor's measured zone-to-pixel rects,
    from which the fusion geometry follows (reference zjuL5.py:106,135).
    The model's geometry is static, so init reads every capture's rects once
    and groups the indices by rect signature: ``geometry_groups`` is
    [(scale_geoms, indices, fr)]. A single-rig dataset exposes its geometry
    as ``scale_geoms``; on a mixed-rig one ``scale_geoms`` raises, and
    ``train/loop.py::make_grouped_eval`` sweeps group by group."""

    def __init__(self, config, mode: str = "online_eval"):
        assert mode == "online_eval"
        self.config = config
        with open(config.filenames_file_eval, "r") as f:
            self.sample_list = json.load(f)["test"]
        self.data_root = config.data_path_eval
        self.focal = float(ZJU_K[0])
        self.geometry_groups = []
        self._group_of = []  # idx -> group number
        by_sig = {}
        for i in range(len(self.sample_list)):
            fr = self._subset_fr(self._read_fr(i))
            key = fr.tobytes()
            if key not in by_sig:
                by_sig[key] = len(self.geometry_groups)
                self.geometry_groups.append(
                    (scales_from_rects(fr, config.native_height, config.native_width), [], fr))
            g = by_sig[key]
            self.geometry_groups[g][1].append(i)
            self._group_of.append(g)

    @property
    def scale_geoms(self):
        """The dataset's geometry; raises for a mixed-rig dataset, where no
        single static geometry exists."""
        if not self.geometry_groups:
            return None
        if len(self.geometry_groups) > 1:
            raise ValueError(
                f"mixed-rig ZJUL5 dataset: {len(self.geometry_groups)} distinct zone-rect "
                "signatures, so no single static geometry exists; evaluate per geometry "
                "group (train/loop.py::make_grouped_eval does)")
        return self.geometry_groups[0][0]

    def _file(self, idx) -> str:
        return os.path.join(self.data_root, _entry_name(self.sample_list[idx]))

    def _read_fr(self, idx) -> np.ndarray:
        import h5py

        with h5py.File(self._file(idx), "r") as f:
            return np.asarray(f["fr"][:], dtype=np.float32)

    def _subset_fr(self, fr: np.ndarray) -> np.ndarray:
        _, fr, _ = tof_sim.apply_zone_subset(np.zeros((len(fr), 2), np.float32), fr,
                                             np.zeros((len(fr),), bool), self.config.zone_type)
        return fr

    def __len__(self):
        return len(self.sample_list)

    def sample_meta(self, idx):
        fname = _entry_name(self.sample_list[idx])
        folder = os.path.dirname(fname) or "zjuL5"
        return folder.replace("/", "__"), os.path.splitext(os.path.basename(fname))[0]

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        import h5py

        cfg = self.config
        with h5py.File(self._file(idx), "r") as f:
            img_u8 = np.asarray(f["rgb"][:], dtype=np.uint8)
            dep = np.asarray(f["depth"][:], dtype=np.float32)
            fh = np.asarray(f["hist_data"][:], dtype=np.float32)
            fr = np.asarray(f["fr"][:], dtype=np.float32)
            mask = np.asarray(f["mask"][:]).astype(bool)
        fh, fr, mask = tof_sim.apply_zone_subset(fh, fr, mask, cfg.zone_type)
        if not np.array_equal(fr, self.geometry_groups[self._group_of[idx]][2]):
            raise ValueError(
                f"{_entry_name(self.sample_list[idx])}: zone rects changed since dataset init; "
                "the eval step's geometry is fixed at init, so rebuild the dataset object")
        pts = tof_sim.sample_points(fh, mask, cfg.zone_sample_num, cfg.sample_uniform)
        return dict(
            image_u8=img_u8,
            depth=dep[..., None] if dep.ndim == 2 else dep,
            hist_data=pts,
            mask=mask,
            focal=np.float32(self.focal),
        )


class SyntheticDataset:
    """Procedural RGB + depth with the real ToF simulation applied.

    Deterministic per index, and equal sample for sample to the JAX
    package's ``SyntheticDataset``; ``zone_offset`` as ``NYUV2Dataset``'s.
    """

    def __init__(self, config, mode: str, length: int = 64):
        self.config = config
        self.mode = mode
        self.length = length
        self.zone_offset = 0

    def __len__(self):
        return self.length

    def sample_meta(self, idx):
        return "synthetic", f"{idx:05d}"

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
        if cfg.device_pipeline and self.mode == "train":
            return dict(image_raw=img, depth=dep[..., None])
        zo = int(self.zone_offset) if self.mode == "train" else 0
        return finalize_sample(img, dep, 500.0, cfg, self.mode, rng, offset=(zo, zo))


def finalize_sample(
    img: np.ndarray,
    dep: np.ndarray,
    focal: float,
    cfg,
    mode: str,
    rng: np.random.Generator,
    offset=(0, 0),
    exact_u8: bool = False,
) -> Dict[str, np.ndarray]:
    """Shared tail: normalize, ToF-simulate, augment, sample points.

    Eval samples from uint8 sources (jpg, h5: ``exact_u8=True``) ship the
    raw uint8 image (``image_u8``), which the eval step normalizes on the
    device: a quarter of the bytes to copy, and exact, because the uint8
    pixels are the source of the f32/255 values. Float-valued sources
    (synthetic) and train samples ship the normalized f32 ``image``."""
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
    out = dict(
        depth=dep[..., None].astype(np.float32),
        hist_data=pts,
        mask=mask,
        focal=np.float32(focal),
    )
    if mode == "train" or not exact_u8:
        out["image"] = normalize_image(img).astype(np.float32)
    else:
        out["image_u8"] = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
    return out


def make_dataset(config, mode: str):
    """The dataset that ``config`` names for ``mode`` (``--dataset`` for
    train, ``--dataset_eval`` otherwise)."""
    name = config.dataset if mode == "train" else config.dataset_eval
    if config.selfsup and mode == "train":
        raise NotImplementedError("--selfsup: the self-supervised pair datasets are not "
                                  "ported yet (ROADMAP.md §A 11)")
    if name == "nyu":
        return NYUV2Dataset(config, mode)
    if name in ("zjuL5", "zju", "ZJUL5"):
        return ZJUL5Dataset(config, mode)
    if name == "synthetic":
        length = getattr(config, "synthetic_length", 64)
        if mode != "train":
            length = min(length, 64)
        return SyntheticDataset(config, mode, length)
    raise NotImplementedError(f"dataset '{name}'")


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-sample dicts into a batch (``pipeline.py::collate``)."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
