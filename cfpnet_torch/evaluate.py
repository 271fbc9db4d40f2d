"""Evaluation entry point of the port.

    python -m cfpnet_torch.evaluate @configs/train_cfpnet_combine1.txt \\
        [--test_dataset zjuL5|nyu|synthetic] [--device cpu] [--weight_path W] \\
        [--eval_bs N] [--synthetic_length N] [--time_iters N]

Port of the ``evaluate_all.py`` protocol (``make_eval_step`` /
``make_metric_step`` with protocol 'evaluate_all', per-image metrics
averaged image-weighted) for one weights file, at the native resolution,
through ``train/loop.py::make_grouped_eval`` (one eval step per rig of a
mixed-rig ZJUL5 set), over the set that ``--test_dataset`` chooses as the
root ``evaluate_all.py`` chooses it (``evaluate_all.py::
eval_dataset_config``): zjuL5, the default, under ``zju_overrides``
(data/ZJUL5, 256 bins, 16 samples a zone, depth 1e-3..10), else synthetic
or nyu. NYU and ZJUL5 need Pillow and h5py and their files on disk. The
epoch sweep and its reports are ``python -m cfpnet_torch.evaluate_all``. Then the bs=1 latency of ``evaluate_time.py``, twice:
``latency_ms_bs1`` of the forward captured in a CUDA graph (replays between
CUDA events, ``evaluate_time.graphed_latency_ms``) and beside it
``latency_ms_bs1_eager``, ``--time_iters`` eager forwards each timed with
CUDA events, trimmed mean ``sorted[1:-2]``
(``evaluate_time.eager_latency_ms``). Latency is measured on the card only;
on the CPU it is reported as not measured. The metrics run eagerly: their
last batch may be partial.

Weights: ``--weight_path`` is a reference-trained ``Deltar`` checkpoint or
a weights file of the port's training loop (``weights/{name}/...``; both
through ``weights.load_reference_checkpoint``). Without it the model carries the
deterministic shape-derived weights of the golden tests
(``weights.deterministic_state_dict``), which is enough to run the path and
not to give meaningful depth.

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import torch

from . import weights
from .config import parse_config
from .data.datasets import collate, make_dataset, sample_image_f32
from .evaluate_all import METRICS, eval_dataset_config
from .evaluate_time import eager_latency_ms, graphed_latency_ms
from .models.deltar import make_model, model_geometries, require_deltar
from .train.loop import make_grouped_eval
from .train.steps import batch_to_device


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--time_iters", type=int, default=100)
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    config = eval_dataset_config(parse_config(rest).replace(mode="online_eval"))
    require_deltar(config, "evaluate")
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    model = make_model(config, device=device)
    if config.weight_path:
        sd = weights.load_reference_checkpoint(config.weight_path)
    else:
        sd = weights.deterministic_state_dict(config)
    model.load_state_dict(sd, strict=True)
    dataset = make_dataset(config, "online_eval")
    groups = getattr(dataset, "geometry_groups", None)
    geoms = groups[0][0] if groups else model_geometries(config, "online_eval")

    results = make_grouped_eval(model, config, dataset, protocol="evaluate_all",
                                device=device)()
    out: Dict[str, object] = {"metrics": results, "images": len(dataset),
                              "eval_bs": config.eval_bs, "device": str(device)}
    print("Metrics: " + json.dumps({k: round(results[k], 3) for k in METRICS}))
    print(",".join(str(round(results[k], 3)) for k in METRICS))

    if device.type == "cuda" and args.time_iters > 0:
        sample = dataset[0]
        batch = batch_to_device(collate([dict(sample, image=sample_image_f32(sample))]), device)
        inputs = (batch["image"], batch["hist_data"], batch["mask"])
        out["latency_ms_bs1"] = graphed_latency_ms(model, inputs, geoms, config,
                                                   args.time_iters)
        out["latency_ms_bs1_eager"] = eager_latency_ms(model, inputs, geoms, args.time_iters)
        out["gpu"] = torch.cuda.get_device_name(device)
        print(f"bs=1 forward: {out['latency_ms_bs1']:.3f} ms in a CUDA graph, "
              f"{out['latency_ms_bs1_eager']:.3f} ms eager ({out['gpu']}, "
              f"{args.time_iters} timed forwards each)")
    else:
        why = "no CUDA device" if device.type != "cuda" else "--time_iters 0"
        print(f"bs=1 forward latency: not measured ({why})")
    return out


if __name__ == "__main__":
    main()
