"""Epoch-sweep evaluation driver of the port.

    python -m cfpnet_torch.evaluate_all @configs/X.txt [--selected_epoch best] \\
        [--test_dataset nyu|zjuL5|synthetic] [--device cpu] \\
        [--save_pred] [--save_rgb] [--save_error_map] [--serving_artifact DIR]

Port of the root ``evaluate_all.py``: ``main`` (``:163-242``),
``write_reports`` (``:245-262``), ``make_save_hook`` (``:33-84``),
``artifact_eval_steps`` (``:87-135``) and ``zju_overrides``
(``:148-160``). Users run it after training
(``python -m cfpnet_torch.train``, whose loop writes
``weights/{name}/{ep}_{rmse:.3f}`` and ``weights/{name}/best``,
``train/loop.py::run_training``).

- For each epoch ``ep`` of ``--epochs``, the first file of
  ``weights/{name}`` (sorted) whose name starts with ``{ep}_``, read by
  ``weights.load_reference_checkpoint``; epochs without one are skipped.
  With ``--selected_epoch`` that one file alone (e.g. ``best``), reported
  as epoch 0, as the root driver does.
- One ``train/loop.py::make_grouped_eval`` (the 'evaluate_all' protocol at
  the native resolution; one eval step per rig of a mixed-rig ZJUL5 set),
  built once and reused over the sweep with each epoch's weights loaded
  into the same model. The nine metrics are rounded to 3 places, one row an
  epoch, printed and written by ``write_reports`` to
  ``{save_dir}/results[_nyu].csv`` and ``.xlsx`` (``utils/xlsx.py``).
- The eval set is chosen by ``--test_dataset`` (``eval_dataset_config``,
  the root ``:169-174``): zjuL5 under ``zju_overrides``, else synthetic or
  nyu. ``cfpnet_torch/evaluate.py`` and ``evaluate_time.py`` choose by the
  same function.
- ``--save_pred``, ``--save_rgb`` and ``--save_error_map`` write PNGs into
  per-scene folders under ``--save_dir`` (``make_save_hook``); they need
  Pillow and matplotlib, imported only when a flag is set.
- ``--serving_artifact DIR`` (root ``:182-193``) sweeps the eval set once
  through an exported artifact (``serve/export.py``; weights inside, no
  checkpoint read) instead of the weights files: ``artifact_eval_steps``,
  one row whose epoch is ``artifact``.
- ``--multihost`` joins the job's process group (root ``:165-168``;
  ``parallel/mesh.py::maybe_initialize_distributed``, on the card
  ``cuda:LOCAL_RANK``). ``--shard_eval`` in a group of more than one
  process strides each epoch's images over the processes
  (``train/loop.py::evaluate_sharded``, root ``:219-230``); without it, or
  in one process, every process sweeps the whole set, as in the JAX
  package. Rank 0 alone writes the reports (root ``:248``).
- ``--spatial_shards N`` (> 1) sweeps with image rows split over N cards
  of this process (``train/loop.py::evaluate``, ``parallel/spatial.py``),
  as the root driver's 2-D mesh; ``dp * N`` must not exceed the cards.
- The forward runs in float32 whatever ``--compute_dtype`` says, as the
  JAX package's eval step does (its ``make_eval_step`` casts nothing).

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
from typing import Dict, List, Optional, Tuple

import torch

from . import weights
from .config import parse_config
from .data.datasets import IMAGENET_MEAN, IMAGENET_STD, make_dataset
from .data.pipeline import make_loader
from .models.deltar import make_model, model_geometries, require_deltar
from .parallel import mesh, spatial
from .train.loop import evaluate, evaluate_sharded, make_eval_steps, make_grouped_eval
from .train.steps import make_metric_step

METRICS = ["a1", "a2", "a3", "abs_rel", "rmse", "log_10", "rmse_log", "silog", "sq_rel"]


def zju_overrides(config):
    """Dataset-specific overrides (reference evaluate_all.py:99-109)."""
    return config.replace(
        data_path_eval="data/ZJUL5",
        filenames_file_eval="data/ZJUL5/data.json",
        native_height=480,
        native_width=640,
        max_depth=10.0,
        min_depth=1e-3,
        n_bins=256,
        min_depth_eval=1e-3,
        max_depth_eval=10.0,
        zone_sample_num=16,
        dataset_eval="zjuL5",
    )


def eval_dataset_config(config):
    """``config`` with the eval set that ``--test_dataset`` chooses (root
    ``evaluate_all.py:169-174``): ``zju_overrides`` where it names zjuL5
    (the default), else ``dataset_eval`` synthetic or nyu; any other name
    leaves ``dataset_eval`` as it is."""
    if "zjuL5" in config.test_dataset:
        return zju_overrides(config)
    if "synthetic" in config.test_dataset:
        return config.replace(dataset_eval="synthetic")
    if "nyu" in config.test_dataset:
        return config.replace(dataset_eval="nyu")
    return config


def make_save_hook(config, dataset):
    """Per-image dumps (root ``evaluate_all.py::make_save_hook``): the
    colorized prediction, the input RGB and the error map as PNGs in
    per-scene folders under ``save_dir``, named by the dataset's
    ``sample_meta``, one file per set flag; None when no flag is set. The
    hook is ``train/loop.py::evaluate``'s ``per_image_hook(idx, pred_hw,
    batch, j)``."""
    if not (config.save_pred or config.save_rgb or config.save_error_map):
        return None
    import numpy as np
    from PIL import Image as PILImage

    from .data.datasets import sample_image_f32
    from .utils.vis import colorize, unnormalize

    def meta(idx):
        fn = getattr(dataset, "sample_meta", None)
        return fn(idx) if fn else ("eval", f"{idx:05d}")

    def hook(idx, pred_hw, batch, j):
        folder, name = meta(idx)
        out_dir = os.path.join(config.save_dir, folder)
        os.makedirs(out_dir, exist_ok=True)
        if config.save_pred:
            vis = colorize(pred_hw, vmin=float(pred_hw.min()), vmax=float(pred_hw.max()))
            PILImage.fromarray(vis).save(os.path.join(out_dir, f"{name}_pred.png"))
        if config.save_rgb:
            if "image_u8" in batch:
                rgb = np.asarray(batch["image_u8"][j])
            else:
                rgb = np.clip(unnormalize(sample_image_f32(
                    {k: v[j] for k, v in batch.items() if k in ("image", "image_u8")})) * 255.0,
                    0, 255).astype(np.uint8)
            PILImage.fromarray(rgb).save(os.path.join(out_dir, f"{name}_rgb.png"))
        if config.save_error_map:
            gt = np.asarray(batch["depth"][j, ..., 0])
            err = np.abs(pred_hw - gt)
            # invalid gt rendered white (colorize's -1 convention)
            err[(gt <= config.min_depth) | (gt >= config.max_depth)] = -1
            valid = err >= 0
            vmax = float(err[valid].max()) if valid.any() else 1.0
            vis = colorize(err, vmin=0.0, vmax=max(vmax, 1e-6))
            PILImage.fromarray(vis).save(os.path.join(out_dir, f"{name}_error.png"))

    return hook


def artifact_eval_steps(config, loader, artifact_path: str, device="cuda"):
    """(eval_step, metric_step) backed by an exported serving artifact: the
    metric sweep runs through the program that will serve (weights inside),
    not through live weights (root ``evaluate_all.py:87-135``).

    The artifact's input is raw uint8 RGB (what a deployed client sends);
    float-sourced eval images (synthetic) are quantized to uint8 at the
    boundary, as a client would send them. The metric valid mask follows
    the artifact's post-processing protocol (``manifest['protocol']``), so
    the prediction and its mask stay the matched pair of
    ``steps.make_eval_step`` and ``make_metric_step``. Raises ``ValueError``
    where the eval set's zone geometry is not the artifact's, or its batch
    size not exported; ``ServingModel`` raises where ``device`` is not the
    artifact's.

    Under ``--spatial_shards`` the sweep's grid checks each batch
    (``parallel/spatial.py::shard_batch_spatial``, the same errors as the
    root driver's) and the artifact runs on the grid's root: the root
    driver's metrics, on one device (ROADMAP.md §C)."""
    from .serve import ServingModel
    from .serve.export import geometry_dict

    m = ServingModel(artifact_path, device)
    man_geo = m.manifest.get("geometry")
    if man_geo is not None:
        # the artifact bakes its zone geometry in; a dataset whose geometry
        # differs (measured ZJUL5 rig against the config grid, or a
        # zone_type ablation) would mis-place every zone
        live = getattr(getattr(loader, "dataset", None), "scale_geoms", None)
        if live is None:
            live = model_geometries(config, "online_eval")
        if geometry_dict(live) != man_geo["scales"]:
            raise ValueError(
                f"artifact zone geometry ({man_geo['source']}, "
                f"{man_geo['zone_num']}x{man_geo['zone_num']}) does not match "
                "the eval dataset's geometry: export again with the matching "
                "--test_dataset/zone flags (python -m cfpnet_torch.export_serving reads "
                "measured ZJUL5 rects when --test_dataset zjuL5)")
    bs = getattr(loader, "batch_size", 1)
    if bs not in m.batch_sizes:
        raise ValueError(
            f"artifact exports batch sizes {m.batch_sizes}; evaluation uses "
            f"--eval_bs {bs}: export again with it or change --eval_bs")
    protocol = m.manifest.get("protocol", "validate")
    mean, std = (torch.as_tensor(a, device=m.device) for a in (IMAGENET_MEAN, IMAGENET_STD))

    def eval_step(batch, grid=None):
        if grid is not None:
            # one exported program for one device: the batch is checked
            # against the grid as a spatial sweep places it (the JAX sweep
            # partitions the exported program itself), and the program runs
            # on the whole batch on the grid's root
            spatial.shard_batch_spatial(batch, grid)
            batch = {k: v.to(grid.root) for k, v in batch.items()}
        if "image_u8" in batch:
            img = batch["image_u8"]
        else:
            raw = batch["image"] * std + mean
            img = torch.clamp(torch.round(raw * 255.0), 0, 255).to(torch.uint8)
        pred = m.call(img, batch["hist_data"].to(torch.float32), batch["mask"])
        return pred[..., None], None

    return eval_step, make_metric_step(config, protocol=protocol)


def weight_files(config) -> List[Tuple[int, str]]:
    """(epoch, path) of each weights file of the sweep (root ``:207-216``)."""
    weights_dir = os.path.join("weights", config.name)
    if config.selected_epoch != "-1":
        return [(0, os.path.join(weights_dir, config.selected_epoch))]
    names = sorted(os.listdir(weights_dir)) if os.path.isdir(weights_dir) else []
    out = []
    for ep in range(config.epochs):
        mine = [n for n in names if n.startswith(f"{ep}_")]
        if mine:
            out.append((ep, os.path.join(weights_dir, mine[0])))
    return out


def write_reports(config, rows) -> Optional[Tuple[str, str]]:
    """``results[_nyu].csv`` and ``.xlsx`` under ``save_dir`` (root
    ``write_reports``); returns their paths. In a process group only rank 0
    writes; the others return None."""
    from .utils.xlsx import write_xlsx

    if mesh.rank() != 0:
        return None
    os.makedirs(config.save_dir, exist_ok=True)
    suffix = "_nyu" if "nyu" in config.test_dataset else ""
    csv_path = os.path.join(config.save_dir, f"results{suffix}.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["epoch"] + METRICS)
        w.writerows(rows)
    print(f"wrote {csv_path}")
    xlsx = os.path.join(config.save_dir, f"results{suffix}.xlsx")
    write_xlsx(xlsx, [["epoch"] + METRICS] + rows)
    print(f"wrote {xlsx}")
    return csv_path, xlsx


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """The sweep; returns the rows as written (``rows``), each epoch's
    unrounded metrics (``metrics``) and weights file (``weights``), and the
    report paths (``reports``)."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    config = parse_config(rest).replace(mode="online_eval")
    require_deltar(config, "the ToF sweep (evaluate_all)")
    device = torch.device(args.device)
    owns_group = config.multihost and not mesh.is_distributed()
    if config.multihost:
        device = mesh.rank_device(device)
        mesh.maybe_initialize_distributed(config, device)
    try:
        return sweep(eval_dataset_config(config), device)
    finally:
        if owns_group:
            torch.distributed.destroy_process_group()


def sweep(config, device) -> Dict[str, object]:
    """``main``'s sweep of the eval set ``config`` names, on ``device``."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    dataset = make_dataset(config, "online_eval")
    hook = make_save_hook(config, dataset)
    if config.serving_artifact:
        return artifact_main(config, dataset, hook, device)

    model = make_model(config, device=device)
    if config.shard_eval and mesh.world_size() > 1:
        steps = make_eval_steps(model, config, make_loader(config, "online_eval",
                                                           dataset=dataset, device=device),
                                protocol="evaluate_all")

        def eval_fn(per_image_hook=None):
            return evaluate_sharded(model, config, dataset, protocol="evaluate_all",
                                    steps=steps, per_image_hook=per_image_hook, device=device)
    else:
        eval_fn = make_grouped_eval(model, config, dataset, protocol="evaluate_all",
                                    device=device)

    rows, unrounded = [], []
    files = weight_files(config)
    for ep, path in files:
        model.load_state_dict(weights.load_reference_checkpoint(path), strict=True)
        results = eval_fn(per_image_hook=hook)
        unrounded.append(dict(results))
        results = {k: round(v, 3) for k, v in results.items()}
        print(f"Metrics: {results}")
        print(",".join(str(results[m]) for m in METRICS))
        rows.append([ep] + [results[m] for m in METRICS])
    return dict(rows=rows, metrics=unrounded, weights=[path for _, path in files],
                reports=write_reports(config, rows))


def artifact_main(config, dataset, hook, device) -> Dict[str, object]:
    """``--serving_artifact``: one sweep through the artifact, one row whose
    epoch is ``artifact``, no weights file read (root ``:182-193``)."""
    loader = make_loader(config, "online_eval", dataset=dataset, device=device)
    steps = artifact_eval_steps(config, loader, config.serving_artifact, device)
    results = evaluate(None, config, loader, steps=steps, per_image_hook=hook)
    unrounded = dict(results)
    results = {k: round(v, 3) for k, v in results.items()}
    print(f"Metrics (serving artifact): {results}")
    print(",".join(str(results[m]) for m in METRICS))
    rows = [["artifact"] + [results[m] for m in METRICS]]
    return dict(rows=rows, metrics=[unrounded], weights=[], reports=write_reports(config, rows))


if __name__ == "__main__":
    main()
