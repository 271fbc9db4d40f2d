"""Configuration system.

Port of ``cfpnet_tpu/config.py`` (``Config``, ``_build_parser``,
``parse_config``): the same flag surface as the reference config (reference
src/config.py:14-93), the same ``@argfile.txt`` / ``.yaml`` invocation modes
and derived fields, so every argfile under ``configs/`` parses to the same
values in both packages. The port keeps its own copy so that it imports
nothing of the JAX package.

Some flags only mean something to the JAX package's scripts (meshes, spatial
sharding, serving artifacts, device pipeline); they are parsed for surface
parity and read by no code of this package yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class Config:
    # --- optimization (reference src/config.py:14-22) ---
    epochs: int = 25
    n_bins: int = 80
    lr: float = 3e-4
    wd: float = 0.1
    div_factor: float = 25.0
    final_div_factor: float = 100.0
    bs: int = 16
    name: str = "UnetAdaptiveBins"
    norm: str = "linear"  # linear | softmax | sigmoid
    same_lr: bool = False
    resume: str = ""
    notes: str = ""
    tags: str = "sweep"
    workers: int = 11

    # --- data (reference src/config.py:32-54) ---
    dataset: str = "nyu"
    dataset_eval: str = "realsense"
    data_path: str = "../dataset/nyu/sync/"
    filenames_file: str = "./train_test_inputs/nyudepthv2_train_files_with_gt.txt"
    data_path_eval: str = "../dataset/nyu/official_splits/test/"
    filenames_file_eval: str = "./train_test_inputs/nyudepthv2_test_files_with_gt.txt"
    input_height: int = 416
    input_width: int = 544
    max_depth: float = 10.0
    min_depth: float = 1e-3
    do_random_rotate: bool = False
    degree: float = 2.5
    min_depth_eval: float = 1e-3
    max_depth_eval: float = 10.0
    no_logging: bool = False

    # --- model / fusion (reference src/config.py:56-57,72) ---
    patch_size: int = 16
    zone_sample_num: int = 16
    attention_layer: List[str] = field(
        default_factory=lambda: ["hist2image", "image", "hist2image", "image"]
    )
    model_name: str = "deltar"

    # --- ToF simulation + hist augmentation (reference src/config.py:65-79) ---
    drop_hist: float = 0.0
    noise_mean: float = 0.0
    noise_sigma: float = 0.0
    noise_prob: float = 0.0
    train_zone_num: int = 8
    # zone-grid shift augmentation, cycled per batch (data/geometry.py::
    # zone_offset_for)
    train_zone_random_offset: int = 0
    sample_uniform: bool = False
    simu_max_distance: float = 4.0
    d_type: str = "uniform"  # parsed-but-unread in the reference; kept for surface parity
    random_simu_max_d: bool = False
    simu_max_d: float = 4.0
    simu_min_d: float = 3.0

    # --- eval / IO toggles (reference src/config.py:58-64,80-93) ---
    save_for_demo: bool = False
    save_rgb: bool = False
    save_pred: bool = False
    save_error_map: bool = False
    save_entropy: bool = False
    save_dir: str = "tmp"
    weight_path: Optional[str] = None
    validate_every: int = 100
    use_my_cross: bool = False
    test_refine: bool = False
    save_residual: bool = False
    save_residual_entropy: bool = False
    save_gt: bool = False
    change_embedding: bool = False
    test_dataset: str = "zjuL5"
    disable_clip_grad: bool = False
    hist_encoder_10x: bool = False
    no_skip_inside: bool = False
    outside_zone_area_only: bool = False
    zone_area_only: bool = False
    zone_type: str = "8x8"
    selected_epoch: str = "-1"

    # --- extensions of the JAX package (no reference equivalent) ---
    # native sensor resolution the positional encodings / zone pads are laid
    # out for (the reference hard-codes 480x640 at decoder.py:82-88)
    native_height: int = 480
    native_width: int = 640
    # computational dtype of the forward ("float32" | "bfloat16")
    compute_dtype: str = "float32"
    # evaluation batch size (metrics stay per-image at any value)
    eval_bs: int = 1
    # data-parallel shards (0 = all local devices)
    dp_shards: int = 0
    # partitioner-safe depthwise kernel gradients (JAX meshes only)
    safe_dw_vjp: bool = False
    # spatial partitioning: shard image rows over chips (0/1 = off)
    spatial_shards: int = 0
    # multi-host initialization
    multihost: bool = False
    coordinator_address: str = ""
    num_processes: int = 0
    process_id: int = -1
    # shard the eval sweep across hosts
    shard_eval: bool = False
    # run the metric sweep through an exported serving artifact
    serving_artifact: str = ""
    # seed (reference train.py:218 uses 117010053)
    seed: int = 117010053
    # the JAX package's Pallas switch; the port always runs its kernels on CUDA
    use_pallas: bool = False
    # zone-grid geometry knobs. Production values match the reference's
    # hard-coded constants (src/utils/dataloader.py:93-100): train zones are
    # 64x64 px, eval is the full 8x8 VL53L5CX grid of 56x56 px zones.
    eval_zone_num_cfg: int = 8
    train_patch_px: int = 64
    eval_patch_px: int = 56
    # --- self-supervised variant ---
    selfsup: bool = False
    ssim_alpha: float = 0.85
    smoothness_weight: float = 1e-3
    zone_loss_weight: float = 1.0
    # --- observability / debugging ---
    debug_nans: bool = False
    trace_dir: str = ""
    # use the tiny backbone/decoder (tests, demos, dry runs)
    tiny_model: bool = False
    # run the post-decode data pipeline on the device
    device_pipeline: bool = False
    # number of procedural samples in the synthetic dataset
    synthetic_length: int = 64
    # rematerialize backbone activations in the backward pass
    remat: bool = False
    # gradient accumulation microbatches per optimizer update
    grad_accum: int = 1

    # --- derived fields (reference src/config.py:118-121) ---
    mode: str = "train"

    @property
    def batch_size(self) -> int:
        return self.bs

    @property
    def num_threads(self) -> int:
        return self.workers

    @property
    def num_workers(self) -> int:
        return self.workers

    @property
    def min_val(self) -> float:
        return self.min_depth

    @property
    def max_val(self) -> float:
        return self.max_depth

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def eval_zone_num(self) -> int:
        return self.eval_zone_num_cfg

    def zone_num_for(self, mode: str) -> int:
        return self.train_zone_num if mode == "train" else self.eval_zone_num

    def zone_patch_px_for(self, mode: str) -> Tuple[int, int]:
        p = self.train_patch_px if mode == "train" else self.eval_patch_px
        return (p, p)

    def image_size_for(self, mode: str) -> Tuple[int, int]:
        if mode == "train":
            return (self.input_height, self.input_width)
        return (self.native_height, self.native_width)


def _build_parser() -> argparse.ArgumentParser:
    """argparse mirror of the reference flag surface (src/config.py:11-93)."""
    p = argparse.ArgumentParser(
        description="cfpnet_torch config", fromfile_prefix_chars="@", conflict_handler="resolve"
    )

    def convert_arg_line_to_args(arg_line):
        for arg in arg_line.split():
            if arg.strip():
                yield str(arg)

    p.convert_arg_line_to_args = convert_arg_line_to_args

    defaults = Config()
    for f in dataclasses.fields(Config):
        name = f.name
        if name == "mode":
            continue
        default = getattr(defaults, name)
        flag = "--" + name
        alt = "--" + name.replace("_", "-")
        flags = [flag] if alt == flag else [flag, alt]
        if f.type in ("bool", bool) or isinstance(default, bool):
            p.add_argument(*flags, default=default, action="store_true")
        elif name == "attention_layer":
            p.add_argument(*flags, default=default, nargs="+")
        elif isinstance(default, int):
            p.add_argument(*flags, default=default, type=int)
        elif isinstance(default, float):
            p.add_argument(*flags, default=default, type=float)
        else:
            p.add_argument(*flags, default=default, type=str)
    # reference-compat aliases
    p.add_argument("--n-bins", dest="n_bins", type=int)
    p.add_argument("--learning-rate", dest="lr", type=float)
    p.add_argument("--weight-decay", dest="wd", type=float)
    return p


def parse_config(argv: Optional[List[str]] = None) -> Config:
    """Parse a Config from CLI args.

    Invocation modes match the reference (src/config.py:97-114):
    - ``prog @configs/foo.txt``   (argfile)
    - ``prog configs/foo.yaml``   (yaml, merged over defaults)
    - ``prog --flag value ...``   (plain flags)
    """
    if argv is None:
        argv = sys.argv[1:]
    parser = _build_parser()

    if len(argv) >= 1 and ("yaml" in argv[0]):
        import yaml

        path = argv[0].replace("@", "")
        with open(path, "r") as stream:
            cfg = yaml.load(stream, Loader=yaml.FullLoader)
        ns = parser.parse_args(argv[1:])
        merged = {**vars(ns), **cfg}
        known = {f.name for f in dataclasses.fields(Config)}
        merged = {k: v for k, v in merged.items() if k in known}
        return Config(**merged)

    ns = parser.parse_args(argv)
    known = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in vars(ns).items() if k in known}
    return Config(**kw)
