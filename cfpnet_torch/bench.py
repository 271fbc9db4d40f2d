"""Headline benchmark of the port: frames/s of the 480x640 eval forward, f32.

    python -m cfpnet_torch.bench [--iters N] [--peak_tflops T]
    python -m cfpnet_torch.bench --smoke

Port of the root ``bench.py``'s f32 keys. Prints ONE JSON line:

- ``metric`` ``frames_per_sec_per_chip_480x640_bs1_f32``, ``value``,
  ``unit``: the bs=1 forward captured in a CUDA graph. The JAX headline is
  bf16, which the port does not have yet (ROADMAP §A item 4), so the name
  differs: a consumer keyed on that headline never reads an f32 number.
- ``latency_ms_bs1_f32`` (graphed), ``latency_ms_bs1_f32_eager`` and
  ``throughput_fps_bs8_f32`` (graphed), by the protocols of
  ``evaluate_time`` (``--iters`` forwards at bs=1, a quarter as many at
  bs=8, as the root ``bench.py``).
- ``flops_g_fwd`` (``evaluate_time.forward_flops`` at bs=1; the count is
  exactly linear in the batch, so bs=8 does 8 times as much),
  ``tfps_bs1_f32`` and ``tfps_bs8_f32``, and ``mfu_bs1_f32``,
  ``mfu_bs8_f32`` against the card's dense bf16 peak (``peak_bf16_tflops``,
  as the root ``bench.py::peak_bf16_tflops`` takes the TPU's), from
  ``PEAK_BF16_TFLOPS`` by the name torch reports or ``--peak_tflops``.
- The train step (``evaluate_time.timed_train_step`` at
  ``evaluate_time.train_config``: bs 16 at 416x544, ``--train_iters``
  steps, eager), as the root ``bench.py``'s train keys:
  ``train_ms_bs16``, ``train_img_s``, ``flops_g_train_step``
  (``evaluate_time.flops_train``), ``tfps_train``, ``mfu_train`` and
  ``train_dtype`` ("float32").
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
SKIPPED = ["bf16 keys (not ported: ROADMAP.md §A item 4)",
           "CPU anchor (the reference model on the same host; not ported)"]


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
    model = evaluate_time.load_model(config)
    geoms = model_geometries(config, "online_eval")

    inputs = evaluate_time.make_inputs(config, 1)
    ms1 = evaluate_time.graphed_latency_ms(model, inputs, geoms, config, args.iters)
    ms1_eager = evaluate_time.eager_latency_ms(model, inputs, geoms, args.iters)
    bs8_iters = max(4, args.iters // 4)
    ms8 = evaluate_time.graphed_latency_ms(
        model, evaluate_time.make_inputs(config, THROUGHPUT_BS), geoms, config, bs8_iters)
    fps8 = THROUGHPUT_BS * 1000.0 / ms8

    flops = evaluate_time.forward_flops(config)
    out = {"metric": "frames_per_sec_per_chip_480x640_bs1_f32", "value": 1000.0 / ms1,
           "unit": "frames/s", "latency_ms_bs1_f32": ms1, "latency_ms_bs1_f32_eager": ms1_eager,
           f"throughput_fps_bs{THROUGHPUT_BS}_f32": fps8, "flops_g_fwd": flops / 1e9,
           "tfps_bs1_f32": flops / ms1 / 1e9,
           f"tfps_bs{THROUGHPUT_BS}_f32": flops * fps8 / 1e12}
    tcfg = evaluate_time.train_config(config)
    ms_t = evaluate_time.timed_train_step(tcfg, niters=args.train_iters)
    flops_t = evaluate_time.flops_train(tcfg)
    out.update({f"train_ms_bs{tcfg.bs}": ms_t, "train_img_s": tcfg.bs * 1000.0 / ms_t,
                "train_dtype": "float32", "flops_g_train_step": flops_t / 1e9,
                "tfps_train": flops_t / ms_t / 1e9})
    skipped = list(SKIPPED)
    peak = args.peak_tflops or peak_bf16_tflops(torch.cuda.get_device_name(0))
    if peak:
        out["peak_bf16_tflops"] = peak
        out["mfu_bs1_f32"] = out["tfps_bs1_f32"] / peak
        out[f"mfu_bs{THROUGHPUT_BS}_f32"] = out[f"tfps_bs{THROUGHPUT_BS}_f32"] / peak
        out["mfu_train"] = out["tfps_train"] / peak
    else:
        skipped.append(f"mfu (no bf16 peak known for {gpu}; pass --peak_tflops)")
    out.update(gpu=gpu, power_limit=power_limit, dtype="float32",
               iters=dict(bs1=args.iters, bs8=bs8_iters, train=args.train_iters),
               timing=("CUDA graph: K replays between CUDA events, trimmed mean over "
                       "repetitions (evaluate_time.graphed_latency_ms); eager: CUDA events "
                       "around each forward, trimmed mean sorted[1:-2]; train: K eager steps "
                       "between CUDA events (evaluate_time.timed_train_step)"),
               skipped=skipped)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
