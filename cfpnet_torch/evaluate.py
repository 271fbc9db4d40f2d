"""Evaluation entry point of the port.

    python -m cfpnet_torch.evaluate @configs/train_cfpnet_combine1.txt \\
        --dataset synthetic [--device cpu] [--weight_path ref.pt] \\
        [--eval_bs N] [--synthetic_length N] [--time_iters N]

Port of the ``evaluate_all.py`` protocol (``make_eval_step`` /
``make_metric_step`` with protocol 'evaluate_all', per-image metrics
averaged image-weighted) over the dataset that ``--dataset`` names, at the
native resolution, plus the bs=1 latency of ``evaluate_time.py``: a warmup,
then ``--time_iters`` forwards each timed with CUDA events, reported as the
trimmed mean ``sorted[1:-2]`` (evaluate_time.py:150-164). Latency is
measured on the card only; on the CPU it is reported as not measured.

Weights: ``--weight_path`` is a reference-trained ``Deltar`` checkpoint
(``weights.load_reference_checkpoint``). Without it the model carries the
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

import numpy as np
import torch

from . import weights
from .config import parse_config
from .data.datasets import collate, make_dataset
from .models.deltar import make_model, model_geometries
from .train.steps import batch_to_device, evaluate

METRICS = ["a1", "a2", "a3", "abs_rel", "rmse", "log_10", "rmse_log", "silog", "sq_rel"]


def timed_forward(model, batch, geoms, iters: int, warmup: int = 5) -> float:
    """Trimmed-mean milliseconds of one forward on ``batch``, CUDA events
    around each call."""
    times = []
    with torch.no_grad():
        for i in range(warmup + iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model(batch["image"], batch["hist_data"], batch["mask"], geoms)
            end.record()
            end.synchronize()
            if i >= warmup:
                times.append(start.elapsed_time(end))
    times.sort()
    trimmed = times[1:-2] if len(times) > 3 else times
    return float(np.mean(trimmed))


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--time_iters", type=int, default=100)
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    config = parse_config(rest).replace(mode="online_eval")
    config = config.replace(dataset_eval=config.dataset)
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
    geoms = model_geometries(config, "online_eval")
    dataset = make_dataset(config, "online_eval")

    results = evaluate(model, config, dataset, geoms, protocol="evaluate_all",
                       batch_size=config.eval_bs, device=device)
    out: Dict[str, object] = {"metrics": results, "images": len(dataset),
                              "eval_bs": config.eval_bs, "device": str(device)}
    print("Metrics: " + json.dumps({k: round(results[k], 3) for k in METRICS}))
    print(",".join(str(round(results[k], 3)) for k in METRICS))

    if device.type == "cuda" and args.time_iters > 0:
        batch = batch_to_device(collate([dataset[0]]), device)
        ms = timed_forward(model, batch, geoms, args.time_iters)
        out["latency_ms_bs1"] = ms
        out["gpu"] = torch.cuda.get_device_name(device)
        print(f"bs=1 forward: {ms:.3f} ms ({out['gpu']}, trimmed mean of "
              f"{args.time_iters} CUDA-event timings)")
    else:
        why = "no CUDA device" if device.type != "cuda" else "--time_iters 0"
        print(f"bs=1 forward latency: not measured ({why})")
    return out


if __name__ == "__main__":
    main()
