"""Headline benchmark of the port: frames/s of the 480x640 eval forward,
bf16 (the headline, as the root's) and f32.

    python -m cfpnet_torch.bench [--iters N] [--peak_tflops T]
    python -m cfpnet_torch.bench --smoke

Port of the root ``bench.py``'s keys. Prints ONE JSON line:

- ``metric`` ``frames_per_sec_per_chip_480x640_bs1``, ``value``, ``unit``,
  ``dtype`` "bfloat16": the bs=1 forward in bf16 (the model and inputs cast
  as ``evaluate_time.timed_forward`` casts them, ``--compute_dtype
  bfloat16``) captured in a CUDA graph, as the root headline
  (``bench.py:215-228``).
- ``latency_ms_bs1`` (graphed), ``latency_ms_bs1_eager`` and
  ``throughput_fps_bs8`` (graphed) in bf16, and the same in f32 under
  ``latency_ms_bs1_f32``, ``latency_ms_bs1_f32_eager``,
  ``throughput_fps_bs8_f32`` and ``fps_bs1_f32``, by the protocols of
  ``evaluate_time`` (``--iters`` forwards at bs=1, a quarter as many at
  bs=8, as the root ``bench.py``).
- ``flops_g_fwd`` (``evaluate_time.forward_flops`` at bs=1; the count is
  exactly linear in the batch, so bs=8 does 8 times as much, and the same
  in either dtype), ``tfps_bs1``, ``tfps_bs8``, ``tfps_bs1_f32`` and
  ``tfps_bs8_f32``, and ``mfu_bs1``, ``mfu_bs8``, ``mfu_bs1_f32``,
  ``mfu_bs8_f32`` against the card's dense bf16 peak
  (``peak_bf16_tflops``, as the root ``bench.py::peak_bf16_tflops`` takes
  the TPU's), from ``PEAK_BF16_TFLOPS`` by the name torch reports or
  ``--peak_tflops``.
- The train step (``evaluate_time.timed_train_step`` at
  ``evaluate_time.train_config``: bs 16 at 416x544, ``--train_iters``
  steps; a CUDA graph from the second step), as the root ``bench.py``'s train keys (``:248-256``):
  ``train_ms_bs16``, ``train_img_s``, ``tfps_train`` and ``mfu_train`` of
  the bf16 step, ``train_dtype`` "bfloat16", and the same of the f32 step
  under ``train_ms_bs16_f32``, ``train_img_s_f32``, ``tfps_train_f32``
  and ``mfu_train_f32`` (``train_fields``); ``flops_g_train_step``
  (``evaluate_time.flops_train``, the same in either dtype).
- ``gpu`` and ``power_limit`` from ``nvidia-smi``, ``iters``, ``timing``.
- ``skipped``: what the port cannot measure yet.

There is no ``vs_baseline``: the root one divides by an assumed figure.
``--smoke`` runs the tiny model on the CPU, eagerly and on the host clock
(at most 8 timed forwards), under a metric name of its own ending in
``_smoke`` (the root's
``BENCH_SMOKE=1``). Without ``--smoke`` it needs a card and fails without
one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import List, Optional

import torch

from . import evaluate_time
from .config import Config
from .models.deltar import model_geometries

# dense bf16 tensor-core TFLOP/s by the device name torch reports (NVIDIA's
# data sheets, without sparsity)
PEAK_BF16_TFLOPS = {"H100 80GB HBM3": 989.4, "H100 SXM": 989.4, "H100 PCIe": 756.5}
THROUGHPUT_BS = 8
SKIPPED = ["CPU anchor (the reference model on the same host; not ported)"]
# (suffix of the keys, compute dtype) of the forward's and the train step's
# timings; the headline first
DTYPES = (("", torch.bfloat16), ("_f32", torch.float32))


def production_config() -> Config:
    """The production model (configs/train_cfpnet_combine1.txt topology), as
    the root ``bench.py`` builds it."""
    return Config(n_bins=256, attention_layer=["hist2image", "combine1", "image",
                                               "hist2image", "combine1", "image"],
                  change_embedding=True, sample_uniform=True, zone_sample_num=16,
                  dataset_eval="synthetic").replace(mode="online_eval")


def smoke_config() -> Config:
    """The tiny model at 64x96 (the root ``__graft_entry__._tiny_config``)."""
    return Config(n_bins=16, native_height=64, native_width=96, eval_zone_num_cfg=2,
                  eval_patch_px=16, attention_layer=["hist2image", "combine1", "image"],
                  change_embedding=True, sample_uniform=True, dataset_eval="synthetic",
                  tiny_model=True).replace(mode="online_eval")


def peak_bf16_tflops(name: str) -> Optional[float]:
    for key, peak in PEAK_BF16_TFLOPS.items():
        if key in name:
            return peak
    return None


def train_fields(batch_size: int, ms: float, flops: float, sfx: str) -> dict:
    """The train keys of one compute dtype (suffix ``sfx``, as ``DTYPES``):
    ms a step at ``batch_size``, images/s and TFLOP/s."""
    return {f"train_ms_bs{batch_size}{sfx}": ms,
            f"train_img_s{sfx}": batch_size * 1000.0 / ms,
            f"tfps_train{sfx}": flops / ms / 1e9}


def smoke_main(iters: int) -> dict:
    config = smoke_config()
    ms = evaluate_time.timed_forward(config, niters=iters, graphed=False, device="cpu")
    return {"metric": "frames_per_sec_tiny_cpu_bs1_f32_smoke", "value": 1000.0 / ms,
            "unit": "frames/s", "latency_ms_bs1_f32_eager": ms,
            "flops_g_fwd": evaluate_time.forward_flops(config) / 1e9, "device": "cpu",
            "timing": "eager, host clock", "iters": iters, "smoke": True}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--train_iters", type=int, default=40,
                    help="timed train steps (the root BENCH_TRAIN_ITERS)")
    ap.add_argument("--peak_tflops", type=float, default=None,
                    help="the card's dense bf16 peak, where PEAK_BF16_TFLOPS lacks it")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    if args.smoke:
        print(json.dumps(smoke_main(min(args.iters, 8))), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("cfpnet_torch.bench: no CUDA device (use --smoke on the CPU)", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu, power_limit = (s.strip() for s in subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0].split(","))
    config = production_config()
    geoms = model_geometries(config, "online_eval")
    flops = evaluate_time.forward_flops(config)
    bs8_iters = max(4, args.iters // 4)
    out = {"metric": "frames_per_sec_per_chip_480x640_bs1", "unit": "frames/s",
           "dtype": "bfloat16", "flops_g_fwd": flops / 1e9}
    for sfx, dtype in DTYPES:
        model = evaluate_time.load_model(config, dtype=dtype)
        inputs = evaluate_time.eval_batch(config, 1, dtype=dtype)[0]
        ms1 = evaluate_time.graphed_latency_ms(model, inputs, geoms, config, args.iters)
        ms1_eager = evaluate_time.eager_latency_ms(model, inputs, geoms, args.iters)
        ms8 = evaluate_time.graphed_latency_ms(
            model, evaluate_time.eval_batch(config, THROUGHPUT_BS, dtype=dtype)[0], geoms,
            config, bs8_iters)
        fps8 = THROUGHPUT_BS * 1000.0 / ms8
        out.update({f"latency_ms_bs1{sfx}": ms1, f"latency_ms_bs1{sfx}_eager": ms1_eager,
                    f"throughput_fps_bs{THROUGHPUT_BS}{sfx}": fps8,
                    f"tfps_bs1{sfx}": flops / ms1 / 1e9,
                    f"tfps_bs{THROUGHPUT_BS}{sfx}": flops * fps8 / 1e12})
        del model
    out["value"] = 1000.0 / out["latency_ms_bs1"]
    out["fps_bs1_f32"] = 1000.0 / out["latency_ms_bs1_f32"]
    tcfg = evaluate_time.train_config(config)
    flops_t = evaluate_time.flops_train(tcfg)
    out.update(train_dtype="bfloat16", flops_g_train_step=flops_t / 1e9)
    for sfx, dtype in DTYPES:
        ms_t = evaluate_time.timed_train_step(tcfg, niters=args.train_iters,
                                              compute_dtype=dtype)
        out.update(train_fields(tcfg.bs, ms_t, flops_t, sfx))
    skipped = list(SKIPPED)
    peak = args.peak_tflops or peak_bf16_tflops(torch.cuda.get_device_name(0))
    if peak:
        out["peak_bf16_tflops"] = peak
        for sfx, _ in DTYPES:
            out[f"mfu_bs1{sfx}"] = out[f"tfps_bs1{sfx}"] / peak
            out[f"mfu_bs{THROUGHPUT_BS}{sfx}"] = out[f"tfps_bs{THROUGHPUT_BS}{sfx}"] / peak
            out[f"mfu_train{sfx}"] = out[f"tfps_train{sfx}"] / peak
    else:
        skipped.append(f"mfu (no bf16 peak known for {gpu}; pass --peak_tflops)")
    out.update(gpu=gpu, power_limit=power_limit,
               iters=dict(bs1=args.iters, bs8=bs8_iters, train=args.train_iters),
               timing=("CUDA graph: K replays between CUDA events, trimmed mean over "
                       "repetitions (evaluate_time.graphed_latency_ms); eager: CUDA events "
                       "around each forward, trimmed mean sorted[1:-2]; train: K eager steps "
                       "between CUDA events (evaluate_time.timed_train_step), bf16 then "
                       "f32"),
               skipped=skipped)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
