#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); exits nonzero without them.
Imports nothing of JAX or of the JAX package. Phases, each printing one JSON
line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: compiles every kernel of ``cfpnet_torch/csrc`` from source and
   reports each kernel's registers, spills and static shared bytes from
   ptxas (``ptxas_report``); fails if a kernel of the bf16 fused layer
   (``fused_loftr_bf16.cu``) spills.
3. kernels: at every shape the production eval forward gives each kernel,
   holds the kernel against its plain PyTorch version on the same inputs
   (f32, TF32 off; max |kernel - plain| <= 1e-4 * max |plain|, the sums run
   in another order) and times kernel, plain version, the library call
   where one exists, against the card's bound for the same work. The fused
   LoFTR layer is checked at its nine shapes on numpy-seeded inputs and
   weights (std 0.1, as tests/test_pallas_loftr.py) and also timed as the
   layer ran before it existed (``unfused_ms``: the module path with cuBLAS
   linears, the attention kernel and torch LayerNorm), split by pass
   (``summary_ms``, ``rows_ms``: torch.profiler over back-to-back calls, by
   device kernel name; the row pass starts before the summary pass ends, so
   the two overlap) and held against a second bound, its operations at the
   3xTF32 tensor-core rate (``bound_tc_ms``, 495/3 TFLOP/s). Each dwconv
   line carries its launch plan (``kernels/dwconv.py::launch_plan``: tile,
   threads, blocks, blocks resident an SM, waves of the grid over the 132
   SMs, shared bytes a block). Each attention line carries its launch plan
   (``kernels/linear_attention.py::launch_plan``: cluster size, cluster sums
   g, key tile, keys and slices a summary block, query tile, blocks and
   waves of each pass, shared bytes) and the device kernels of one call by
   name (torch.profiler). Attention is still checked at all twelve shapes;
   nine of them now run inside the fused layer, so they count no calls per
   forward. Then again at every shape of the bs=8 forward and of the bs=16
   train step's forward at 416x544 (``mode`` "train"), where only the
   kernel is timed (its error within the same bound).
4. gradients: at the train step's shapes, each kernel's gradients against
   autograd of its plain version within the same bound (``check_gradients``:
   dq, dk, dv; dwconv's dx, dW, db, at one batch row where k = 31; the fused
   layer's dx, dsource, wq, w1), with the backward's time: dwconv's dx (the
   forward kernel on the rotated taps), dW (PyTorch's call, from NCHW
   copies as the port makes it, and on the channels-last views, which
   PyTorch hands to cuDNN) and db apart; the attention and
   LoFTR backwards (autograd of the plain version, recomputed). Then the
   same in bf16 for the bf16 train step: each bf16 variant at every shape
   of the bs=16 train step's forward against its bf16 plain version within
   ``BF16_TOL`` (``check_kernels_bf16``, mode "train", with the share of
   elements that differ, ms and bound), and its bf16 gradients against
   autograd of the bf16 plain version within ``BF16_TOL`` x max |plain|,
   with dx, dW and db timed apart.
5. slice: the production model (configs/train_cfpnet_combine1.txt
   topology) at 480x640, bs=1, with the golden tests' deterministic
   weights, against ``tests/golden/full_forward.npz`` at that test's
   tolerance (rtol 5e-4, atol 5e-5); the launch counts of that forward must
   be 6 attention, 6 depthwise-conv and 18 fused-LoFTR launches.
6. graph: the forward captured in a CUDA graph (``cfpnet_torch.graphs``).
   At bs=1 the replay equals the eager forward bit for bit and matches the
   golden, and 20 replays on changed inputs each equal their eager forward;
   at bs=8, on 8 synthetic samples, an eager pass launches 6/6/18, the
   replay equals the eager forward bit for bit and each row matches the
   bs=1 forward of its sample (rtol 5e-4, atol 5e-5).
7. entry: ``cfpnet_torch.evaluate --test_dataset synthetic`` on 4
   synthetic images at bs=1 and bs=2; metrics must be finite; prints the
   bs=1 latency in a CUDA graph and eager.
8. profile: device time of one bs=1 forward by kernel (torch.profiler),
   eager and replayed, its kernel launches and the device's busy share of
   each latency; the host-to-device copies and ``cudaStreamSynchronize``
   calls of one warmed eager forward, which must be 0 and 0.
9. train: one production train step at bs 2 (416x544, the deterministic
   weights, ``golden_train_batch``) against the JAX package's step in
   ``tests/golden/torch_port_train_step.npz`` (``train_golden_errors``,
   within ``TRAIN_GOLDEN_TOL``), launching 6 attention, 6 + 6 dwconv and 18
   fused-LoFTR kernels; then the production step at bs 16
   (``train_step_phase``): falling losses over 10 steps on one batch, the
   launch counts of a step, ms a step and images/s, peak memory, and one
   profiled step by kernel and by kind with the device's busy share. Then
   the bf16 step (``--compute_dtype bfloat16``): one step at bs 2 against
   the same float64 golden within ``TRAIN_GOLDEN_TOL_BF16``, its 6 / 6 + 6
   / 18 launches all on bf16 tensors; the bs-16 bf16 step as above beside
   the f32 one (its casts counted), after which every parameter, both
   AdamW moments and every running statistic are still float32.
10. loop: the training loop (``train/loop.py::run_training``) at the bs
    16 train configuration on 48 synthetic samples, 2 epochs of 3 steps,
    validation (48 eval images) and checkpoints every epoch, in a temporary
    working directory (``loop_phase``): finite losses, the checkpoint and
    weights files, the nine metrics in the JSONL; each step's launches
    (6 / 12 / 18) and the run's; one profiled loop step with no copy to the
    host and no stream sync, its batch copied from pinned memory; the last
    checkpoint loaded back bit for bit; a resume from the epoch-0
    checkpoint against the uninterrupted run (same batches, offsets and
    rates; losses and parameters within 4x the spread of two uninterrupted
    runs). Prints loop ms a step and images/s beside phase 9's bare step,
    the wait on the loader's queue, validation and checkpoint seconds and
    bytes, and the ToF path. Then one epoch of ``run_training`` in bf16
    (``loop_bf16_phase``): finite losses, the steps' launches on bf16 and
    the validation's on float32, finite metrics, float32 weights and
    moments in the files.
11. bf16 (``bf16_phase``): ``--compute_dtype bfloat16`` through the eval
    forward. Each kernel's bf16 variant against its bf16 plain version at
    every bs=1 and bs=8 main-path shape (max |kernel - plain| <=
    ``BF16_TOL`` = 2^-7 * max |plain|, one bf16 ulp at the top of the
    range), with the share of elements that differ and the ms a call
    against its bound (``kernel_shape_bf16`` lines; the fused layer's also
    split by pass, ``summary_ms`` and ``rows_ms``, with its launch plan
    from ``kernels/fused_loftr.py::launch_plan``); the production model
    cast to bf16 on the golden's inputs: one eager forward launches
    6 / 6 / 18 kernels, all on bf16 tensors (the wrappers count by dtype),
    and its prediction stays within tests/test_bf16.py's drift budget of
    the f32 golden (median rel < 0.06, median abs < 0.08); its graph at
    bs=1 and bs=8 replays bit for bit equal to the eager bf16 forward;
    ``cfpnet_torch.evaluate_time --compute_dtype bfloat16`` graphed and
    eager (``BF16_ITERS`` forwards); one replay of the f32 and of the bf16
    graph profiled by kind (``by_kind``) with the busy share.
12. sweep (``sweep_phase``): ``cfpnet_torch.evaluate_all --test_dataset
    synthetic`` over the two epochs' weights phase 10's loop wrote, on 8
    images: a CSV of two finite rows, the .xlsx, the launches of 16 f32
    forwards.
13. bench: ``cfpnet_torch.bench`` at ``BENCH_ITERS`` forward and
    ``BENCH_TRAIN_ITERS`` train iterations prints its line (bf16 headline
    keys and f32 ones; the train keys of the bf16 step, ``train_dtype``
    "bfloat16", and of the f32 step under ``_f32``).
14. train options (``train_options_phase``, run after phase 10, beside
    whose loop it reports): ``--device_pipeline``'s transform
    (``data/tof_sim_device.py``) on one raw bs-16 batch at 416x544 on the
    production train geometry: its device ms (CUDA events), its device
    kernels, no copy to the host and no sync, the host producer's ms a
    batch with and without the option, ``get_hist`` on the card against
    the host's ``tof_sim.get_hist`` and the transform on the card against
    itself on the CPU with the same draws; one bf16 ``--device_pipeline``
    epoch of ``run_training`` (launch counters set to 0 before it and read
    after: 6 / 12 / 18 a step on bf16, the validation's on f32; loop ms
    a step, loader waits and producer ms beside phase 10's) and its resume
    from the epoch-0 checkpoint, bit for bit under deterministic
    algorithms; the
    bs-16 step with ``--grad_accum 2`` and ``4`` and with ``--remat`` in
    f32 and bf16 beside the plain step (ms, peak memory, launches), and
    the remat step bit for bit the plain one under deterministic
    algorithms; a planted NaN under ``--debug_nans`` raising
    ``FloatingPointError``.
15. serving (``serving_phase``, run after phase 12): the production model on
    the deterministic weights exported (``cfpnet_torch/serve``) in bf16 at
    bs 1 and 8 and in f32 at bs 1 into a temporary directory, each reloaded
    by a fresh ``ServingModel``: each program calls the custom ops
    ``cfpnet::linear_attention`` / ``dwconv2d`` / ``fused_loftr`` 6 / 6 / 18
    times; one eager call of its module (launch counters set to 0 just
    before, read just after) launches 6 / 6 / 18 kernels on its dtype; a
    profiled replay of the bs=1 serving graph runs the kernels' device
    functions (``SERVING_DEVICE_KERNELS``); ``predict`` equals the live eval
    step bit for bit at bs=1 and bs=8; the bs=1 program holds the golden
    (``serving_golden``: f32 at its tolerance, bf16 within ``BF16_DRIFT``);
    3 rows padded into the bs=8 program equal the live padded step and, in
    tolerance, their own bs=1 predictions. Prints export seconds and bytes,
    the serving replay's ms against the live graph's in each dtype, bs=8
    images/s, and one HTTP run (8 clients x 16 bs=1 requests, 2 ms window:
    requests/s, p50/p99 ms, batches and rows).
16. selfsup (``selfsup_phase``, run after phase 15): the self-supervised
    variant (``--selfsup``, ``cfpnet_torch/train/selfsup.py``) on the
    production model. One step at bs 2 (``golden_selfsup_batch``, the
    deterministic depth and pose weights) against the JAX package's step in
    ``tests/golden/torch_port_selfsup_step.npz`` (the four loss terms and
    ``golden_errors``' classes, PoseNet's as ``pose``; within
    ``SELFSUP_GOLDEN_TOL``), launching 6 attention, 6 + 6 dwconv and 18
    fused-LoFTR kernels; the bs-16 step on synthetic pairs
    (``selfsup_step_check``): finite terms, the launch counts of one step
    (6 / 12 / 18, all float32), ms a step and images/s, peak memory, one
    profiled step by kind and beside it the objective alone (PoseNet, warp,
    SSIM, smoothness and zone terms, forward and backward); and one epoch
    of ``run_selfsup_training`` (``selfsup_loop_check``: 2 steps, 16
    validation images, the ``selfsup_val`` line, the ``best`` depth weights
    loaded back bit for bit, the run's launches).
17. multi_process (``multi_process_phase``, run after phase 16): data
    parallelism (``cfpnet_torch/parallel``). A process group of one over
    NCCL: the golden step bit for bit the same step with no group, and
    within ``TRAIN_GOLDEN_TOL`` of the golden. Two processes on the one
    card over gloo (``dp_rank``, spawned by ``parallel/launch.py``; NCCL
    refuses two processes on one card): the golden step as 1 + 1 rows
    within ``TRAIN_GOLDEN_TOL``, both processes' weights and buffers equal
    bit for bit after it, 6 / 12 / 18 launches a step in each; the f32
    step at global bs 16 (8 + 8): ms a step, its all-reduces (calls,
    bytes, ms), peak memory of each process; ``evaluate_sharded`` over 8
    synthetic images equal on both and within ``DP_EVAL_RTOL`` of one
    process's ``evaluate``. ``predict_sharded`` on the one card equals
    ``predict`` bit for bit on phase 15's bf16 artifact. A process that
    fails, or outlasts ``DP_TIMEOUT``, fails the script.
18. spatial (``spatial_phase``, run after phase 17): ``--spatial_shards``
    (``cfpnet_torch/parallel/spatial.py``) on a 1 x 2 grid of the one card
    (``["cuda:0"] * 2``). The f32 eval forward at bs 2, 480x640: within
    ``TOL`` of the one-device forward, its first row against the golden;
    the bf16 forward within ``BF16_DRIFT``; 6 / 6 / 18 launches a forward;
    the golden train step on the grid within ``TRAIN_GOLDEN_TOL`` (6 / 12 /
    18 launches); the bs-16 step at 416x544 on the grid: ms a step beside
    phase 9's, launches, peak memory; the card beside the numbers.
19. configs (``configs_phase``, run after phase 18): the DELTAR baseline
    (``configs/train_deltar_baseline.txt``, ``--attention_layer hist2image
    image hist2image image``) at 480x640 on the deterministic weights: the
    f32 bs=1 forward eager and replayed from its CUDA graph against
    ``tests/golden/torch_port_baseline_forward.npz`` (rtol 5e-4, atol
    5e-5), 0 / 0 / 18 launches; the bf16 forward within ``BF16_DRIFT`` of
    that golden, 0 / 0 / 18 on bf16; ``evaluate_time``'s replay ms in f32
    and bf16; ``evaluate`` on 2 synthetic images; one bs-16 step at 416x544
    (losses, 0 / 0 / 18 launches, ms, peak memory). The production
    configuration with ``--attention_layer hist2image new_cross combine_2
    image cvxt_2`` (``FUSION_NAMES``): the f32 forward eager and replayed
    against ``tests/golden/torch_port_fusion_names_forward.npz``, 9 / 12 / 9
    launches, replay ms. Masked attention and a masked LoFTR layer at the
    1/4 scale's hist2image shape in f32 and bf16 against the CPU in float64
    (``MASKED_TOL``), launching nothing, the same calls unmasked launching
    their kernels (``masked_calls``). ``cfpnet_torch.demo.predict`` on the
    synthetic frame against the phase's own eager forward, resized
    (``demo_check``).

Then the kernel table as one JSON line (each row also carries its
kernel's per-forward ms and bound, and its worst error over max |plain|,
at bs=8: ``ms_bs8``, ``bound_ms_bs8``, ``max_rel_err_bs8``; in the train
step's forward: ``ms_train``, ``bound_ms_train``, ``max_rel_err_train``; its
backward: ``backward_ms_train``, ``grad_max_rel_err_train``, for dwconv
``dx_ms_train``, ``dw_library_ms_train``; and its launches in one train
step, ``launches_train_step``; and in the loop phase's uninterrupted run,
``launches_loop``; in phase 14's bf16 ``--device_pipeline`` run,
``launches_device_pipeline_loop``; in phase 15's eager call of each bs=1
serving program, ``launches_serving`` by dtype; in phase 16's bs-16
self-supervised step, ``launches_selfsup_step``; in phase 17's bs-16
step of each of the two processes (8 rows each), ``launches_two_rank_step``;
in phase 18's forward and bs-16 step on the grid, ``launches_spatial_forward``
and ``launches_spatial_step``; in phase 19's baseline forward and step and
fusion-names forward, ``launches_configs``;
from the bf16 phase, per
bs=1 forward, ``card_ms_bf16``,
``bound_ms_bf16`` (bytes at 2 a value; operations at the f32 rate, or the
dense bf16 tensor-core rate for the fused layer's bf16 products),
``library_ms_bf16`` (dwconv: cuDNN in bf16; else null), ``bound_by_bf16``,
``max_rel_err_bf16`` and ``differ_share_bf16`` over the bs=1 and bs=8
shapes, ``card_ms_bs8_bf16``, ``bound_ms_bs8_bf16`` and the bf16 forward's
``launches_bf16``; for the fused layer also its bf16 source,
``source_bf16``, and its passes, ``summary_ms_bf16``, ``rows_ms_bf16``,
``summary_ms_bs8_bf16``, ``rows_ms_bs8_bf16``); in the bf16 train step
(``bf16_train_fields``) ``ms_train_bf16``, ``bound_ms_train_bf16``,
``max_rel_err_train_bf16``, ``differ_share_train_bf16``,
``backward_ms_train_bf16``, ``grad_max_rel_err_train_bf16``, for dwconv
``dx_ms_train_bf16``, ``dw_library_ms_train_bf16``, ``db_ms_train_bf16``,
and ``launches_train_step_bf16``), and last the ``ok`` line. Each phase's
line carries ``at_s``, the seconds since the script started.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_FULL = os.path.join(ROOT, "tests", "golden", "full_forward.npz")
# one production train step of the JAX package in float64 on the CPU, bs 2 at
# 416x544 (tests/test_torch_port_train.py::write_train_golden)
GOLDEN_TRAIN = os.path.join(ROOT, "tests", "golden", "torch_port_train_step.npz")
GOLDEN_TRAIN_BS = 2
GOLDEN_TRAIN_SEED = 5  # the step's seed: its crop offsets
GOLDEN_TRAIN_TOTAL_STEPS = 1000  # the OneCycle length (the root timed_train_step's)
# one self-supervised step of the JAX package (--selfsup) in float64 on the
# CPU, the same shape, seed and OneCycle length, deterministic depth and pose
# weights (tests/test_torch_port_selfsup.py::write_selfsup_golden)
GOLDEN_SELFSUP = os.path.join(ROOT, "tests", "golden", "torch_port_selfsup_step.npz")
# golden_errors' limits: 4 times the larger error of the same comparison on
# the CPU in float32, the port's step and the JAX package's own float32 step
# against the float64 golden (``python tests/test_torch_port_train.py
# --tolerance``). On the deterministic weights at bs 2 the step is
# ill-conditioned in float32 upstream of the BatchNorms (flax's fast
# variance cancels where a channel's mean dwarfs its spread): the JAX
# package's own float32 gradients are 15% off in norm there ("trunk"), while
# the loss, the head and the running statistics hold to 1e-7..1e-2. The
# medians are 10 to 1000 times smaller than the largest errors.
TRAIN_GOLDEN_TOL = dict(
    loss=9.6e-7, stat=0.023, stat_median=3.6e-6, zero_grad_norm=1.3e-6,
    zero_grad_norm_median=2.8e-10, head_grad_norm=1.5e-5, head_grad_norm_median=1.7e-6,
    head_grad_sum=2.5e-6, head_grad_sum_median=6.5e-7, head_grad_at=4.2e-4,
    head_grad_at_median=1.5e-6, head_param_at=5.1e-4, head_param_at_median=7.7e-5,
    trunk_grad_norm=0.59, trunk_grad_norm_median=0.063, trunk_grad_sum=0.15,
    trunk_grad_sum_median=0.0035, trunk_grad_at=2.6, trunk_grad_at_median=0.18,
    trunk_param_at=0.29, trunk_param_at_median=0.005)
# The bf16 step's limits against the same float64 golden, by the same rule:
# 4 times the larger error of the port's bf16 step and the JAX package's own
# bf16 step on the CPU (each op rounded to its dtype). The JAX package's own
# bf16 step is as far from the float64 golden as the port's: its worst trunk
# gradient is 7.7 times its norm off (the port's 8.5), an entry of a trunk
# parameter steps against the golden's sign (``trunk_param_at`` 2: two
# learning rates), and a running statistic is 0.37 of its step off (the
# port's 0.29). So the largest errors in bf16 are those of the step itself,
# and wide: a step that left a class where it started (statistics frozen,
# trunk gradients zeroed, trunk parameters unmoved) reads about 1 in them.
# The medians hold those classes: 0.17-0.20 in the trunk's gradient norms,
# 0.11-0.12 in its parameters, 0.006-0.007 in the statistics, against about
# 1 for a class left unchanged (tests/test_torch_port_train.py).
TRAIN_GOLDEN_TOL_BF16 = dict(
    loss=0.0051, stat=1.5, stat_median=0.027, zero_grad_norm=0.29,
    zero_grad_norm_median=2.2e-5, head_grad_norm=1.2, head_grad_norm_median=0.036,
    head_grad_sum=0.079, head_grad_sum_median=0.0071, head_grad_at=2.3,
    head_grad_at_median=0.023, head_param_at=5.1e-4, head_param_at_median=7.9e-5,
    trunk_grad_norm=35, trunk_grad_norm_median=0.81, trunk_grad_sum=2.8,
    trunk_grad_sum_median=0.05, trunk_grad_at=70, trunk_grad_at_median=3.4,
    trunk_param_at=8.1, trunk_param_at_median=0.49)
PROD_CONFIG = os.path.join(ROOT, "configs", "train_cfpnet_combine1.txt")
# phase 19: the DELTAR baseline configuration, and the production one with the
# fusion layer names no shipped configuration uses, each (golden, config
# arguments) against the JAX package's f32 forward on the CPU
# (tests/test_torch_port_configs.py::write_golden; the weights and inputs of
# full_forward.npz), and the kernels' launches of one forward
BASELINE_CONFIG = os.path.join(ROOT, "configs", "train_deltar_baseline.txt")
FUSION_NAMES = ("hist2image", "new_cross", "combine_2", "image", "cvxt_2")
CONFIG_GOLDENS = {
    "baseline": (os.path.join(ROOT, "tests", "golden", "torch_port_baseline_forward.npz"),
                 (f"@{BASELINE_CONFIG}",)),
    "fusion_names": (os.path.join(ROOT, "tests", "golden", "torch_port_fusion_names_forward.npz"),
                     (f"@{PROD_CONFIG}", "--attention_layer") + FUSION_NAMES),
}
CONFIG_LAUNCHES = {
    "baseline": {"linear_attention": 0, "dwconv": 0, "fused_loftr": 18},
    # a scale: new_cross 1 + combine_2 2 attention; combine_2 2 + cvxt_2 2
    # dwconv; hist2image 1 + image 2 fused LoFTR
    "fusion_names": {"linear_attention": 9, "dwconv": 12, "fused_loftr": 9},
}
TOL = 1e-4  # max |kernel - plain| / max |plain|
# published H100 SXM peaks: HBM bytes/s, f32 flop/s outside the tensor cores,
# the TF32 tensor-core rate over three (a 3xTF32 product is three TF32 ones),
# and the dense bf16 tensor-core rate (bf16 x bf16 products, f32 sums)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_TF32_3X = PEAK_TF32 / 3
PEAK_BF16 = 989.4e12
BF16_TOL = 2.0 ** -7  # bf16 phase: max |kernel - plain| / max |plain|, one bf16 ulp at the top
# the bf16 forward's drift from the f32 golden: tests/test_bf16.py's budget
BF16_DRIFT = dict(median_rel=0.06, median_abs=0.08)
SEED = 117010053
BENCH_ITERS = 40  # cfpnet_torch.bench --iters in phase 10 (its default is 500)
BENCH_TRAIN_ITERS = 10  # and its --train_iters (its default is 40)
BF16_ITERS = 50  # cfpnet_torch.evaluate_time --niters in the bf16 phase (its default is 500)


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started (``at_s``)."""
    if "phase" in obj:
        obj = dict(obj, at_s=time.perf_counter() - T0)
    print(json.dumps(obj), flush=True)


def device_ms(fn, reps: int = 20, trials: int = 5) -> float:
    """Median device milliseconds of one ``fn()``: CUDA events around
    ``reps`` back-to-back calls, queued behind a spin kernel so the host's
    enqueue time is not measured, after a warmup."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        torch.cuda._sleep(50_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return float(np.median(out))


def bound_fields(nbytes: float, flops: float, peak_flops: float = PEAK_F32):
    """The least time for the work: bytes over the memory rate and operations
    over ``peak_flops`` (the f32 rate outside the tensor cores unless
    given), in ms, and the larger of the two."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def kernel_split(fn, calls: int = 10, attempts: int = 5, expect=()):
    """The device kernels of one ``fn()`` call by name: ``{name: {"launches":
    per call, "ms": device ms per call}}``, from torch.profiler (CUPTI) over
    ``calls`` back-to-back calls of ``fn``. A profiler session now and then
    records no device event at all, or none of one of ``fn``'s kernels; such
    a session (one without a kernel whose name holds each string of
    ``expect``) is run again, up to ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        split = {e.key: dict(launches=e.count / calls, ms=e.self_device_time_total / 1e3 / calls)
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA and e.count}
        if split and all(any(e in name for name in split) for e in expect):
            return split
    raise AssertionError(f"the profiler saw no device kernel, or none of one of {list(expect)}, "
                         f"in {attempts} sessions: {sorted(split)}")


def pass_split(fn):
    """Device ms per call of the fused LoFTR layer's two device kernels
    (``summary_kernel``, ``rows_kernel``; ``bf16_...`` in bf16), by kernel
    name: the mean over the launches the profiler recorded, each call
    launching each pass once (a session now and then records only some of
    its calls, or none of one pass: ``kernel_split`` runs it again)."""
    split = dict(summary_ms=0.0, rows_ms=0.0)
    for name, k in kernel_split(fn, expect=("summary_kernel", "rows_kernel")).items():
        for key in split:
            if key.replace("_ms", "_kernel") in name:
                split[key] += k["ms"] / k["launches"]
    if not all(split.values()):
        raise AssertionError(f"the profiler saw no summary or row kernel: {split}")
    return split


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")


def _kernel_name(mangled: str) -> str:
    """``name<template arguments>`` of a mangled kernel (the length-prefixed
    identifier that ends in ``_kernel``; integers, ``float``, ``bf16``), else
    ``mangled``."""
    for p in range(len(mangled)):  # every start of a length, "5413" holding "13"
        m = re.match(r"\d+", mangled[p:])
        if m is None:
            continue
        end = p + m.end()
        name = mangled[end:end + int(m.group())]
        rest = mangled[end + len(name):]
        if not (name.endswith("_kernel") and rest.startswith("I")):
            continue
        args, i = [], 1
        while i < len(rest) and rest[i] != "E":
            if rest.startswith("Li", i):
                j = rest.index("E", i)
                args.append(rest[i + 2:j])
                i = j + 1
            elif rest[i] == "f":
                args.append("float")
                i += 1
            elif rest[i].isdigit():
                n = re.match(r"\d+", rest[i:]).group()
                ident = rest[i + len(n):i + len(n) + int(n)]
                args.append("bf16" if ident == "__nv_bfloat16" else ident)
                i += len(n) + int(n)
            else:
                break
        return f"{name}<{','.join(args)}>"
    return mangled


def ptxas_report(log: str):
    """Each kernel of an ``nvcc -Xptxas -v`` log: its name (with integer
    template arguments, e.g. ``bf16_rows_kernel<128,16,32,2>``), registers,
    spill bytes (stores and loads), stack frame and static shared bytes."""
    out, entry = [], None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            entry = dict(kernel=_kernel_name(m.group(1)), registers=None, spill_stores=0,
                         spill_loads=0, stack=0, smem=0)
            out.append(entry)
        elif entry is not None and "spill stores" in line:
            n = [int(v) for v in re.findall(r"(\d+) bytes", line)]
            entry.update(stack=n[0], spill_stores=n[1], spill_loads=n[2])
        elif entry is not None and "Used" in line and "registers" in line:
            entry["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            entry["smem"] = int(smem.group(1)) if smem else 0
    return out


def production_config():
    """The production model (configs/train_cfpnet_combine1.txt topology):
    ``cfpnet_torch.bench.production_config``, the configuration of
    tests/test_golden.py::test_golden_forward_production_size."""
    from cfpnet_torch.bench import production_config

    return production_config()


def main_path_shapes(config, geoms, batch: int = 1, mode: str = "online_eval"):
    """(attention, dwconv, LoFTR layer) shapes of one forward in ``mode``
    ("online_eval": the native size; "train": the input size), with the
    number of calls at each: attention (N, L, S, H, D), dwconv (B, H, W, C,
    k), LoFTR layer (N, L, S, C, H). The attention inside a LoFTR layer is
    listed with 0 calls: the fused kernel computes it. The Twins window
    follows the native size at every mode (``models/fusion.py``)."""
    from cfpnet_torch.models.transformer import twins_window_size

    att, dw, loftr = {}, {}, {}

    def add(d, key, n=1):
        d[key] = d.get(key, 0) + n

    def add_loftr(N, L, S, C, H):
        add(loftr, (N, L, S, C, H))
        add(att, (N, L, S, H, C // H), 0)

    nh, nw = config.image_size_for(mode)
    for scale, C, k in ((16, 128, 7), (8, 64, 15), (4, 32, 31)):
        g = geoms[scale]
        H, W = nh // scale, nw // scale
        ws = twins_window_size(config.native_height // scale, config.native_width // scale)
        for name in config.attention_layer:
            if name == "hist2image":
                add_loftr(batch * g.zone_num ** 2, g.p1 * g.p2, config.zone_sample_num, C, 4)
            elif name == "combine1":
                add(att, (batch, H * W, g.num_inside, 4, C // 4))
                add(dw, (batch, H, W, C, k))
            elif name == "image":
                add_loftr(batch * -(-H // ws) * -(-W // ws), ws * ws, ws * ws, C, 8)
                add_loftr(batch, H * W, (H // ws) * (W // ws), C, 8)
            else:
                raise NotImplementedError(name)
    return att, dw, loftr


def check_kernels(config, geoms, batch: int = 1, full: bool = True, mode: str = "online_eval"):
    """Phase 3: every kernel at every main-path shape of a forward in
    ``mode`` at ``batch`` against its plain version; returns one line a
    shape. With ``full`` each line also times the plain version and the
    library call and splits the call by device kernel (torch.profiler);
    without it, only the kernel is timed."""
    from cfpnet_torch.kernels import dwconv, fused_loftr, linear_attention
    from cfpnet_torch.models.transformer import LoFTREncoderLayer
    from cfpnet_torch.ops.attention import linear_attention as att_plain
    from cfpnet_torch.ops.dwconv import depthwise_conv2d as dw_plain
    from cfpnet_torch.ops.loftr import loftr_apply

    att_shapes, dw_shapes, loftr_shapes = main_path_shapes(config, geoms, batch, mode)
    gen = torch.Generator(device="cuda").manual_seed(SEED + batch - 1)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    def checked(name, shape, got, ref):
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        if not (err <= TOL * scale):
            raise AssertionError(f"{name} {shape} at bs={batch}: max err {err} > {TOL} * {scale}")
        return dict(max_abs_err=err, max_abs_plain=scale)

    per_shape = []
    for (N, L, S, H, D), calls in sorted(att_shapes.items()):
        q, k, v = randn(N, L, H, D), randn(N, S, H, D), randn(N, S, H, D)
        line = checked("linear_attention", (N, L, S, H, D),
                       linear_attention.linear_attention(q, k, v), att_plain(q, k, v))
        C = H * D
        nbytes = 4 * (2 * N * L * C + 2 * N * S * C)
        flops = N * H * (2 * S * D * D + S * D + 2 * L * D * D + 2 * L * D)
        plan = linear_attention.launch_plan(N, L, S, H, D)
        line.update(
            plan={key: plan[key] for key in (
                "cl", "g", "tk", "chunk", "slices", "sum_threads", "sum_blocks", "sum_smem",
                "tl", "apply_threads", "apply_blocks", "apply_blocks_per_sm", "apply_waves",
                "apply_smem")},
            ms=device_ms(lambda: linear_attention.linear_attention(q, k, v)),
            **bound_fields(nbytes, flops))
        if full:
            split = kernel_split(lambda: linear_attention.linear_attention(q, k, v),
                                 expect=("attention_sum_kernel", "attention_apply_kernel"))
            line.update(
                device_kernels_a_call=sum(s["launches"] for s in split.values()),
                device_kernels={name.replace("(anonymous namespace)::", "").split("(")[0]: s
                                for name, s in split.items()},
                plain_ms=device_ms(lambda: att_plain(q, k, v)), library_ms=None)
        per_shape.append(dict(kernel="linear_attention", shape=dict(N=N, L=L, S=S, H=H, D=D),
                              calls=calls, **line))
    for (B, H, W, C, kk), calls in sorted(dw_shapes.items()):
        x, w, bias = randn(B, H, W, C), 0.05 * randn(C, 1, kk, kk), randn(C)
        line = checked("dwconv", (B, H, W, C, kk), dwconv.depthwise_conv2d(x, w, bias),
                       dw_plain(x, w, bias))
        nbytes = 4 * (2 * B * H * W * C + C * kk * kk + C)
        flops = 2 * kk * kk * B * H * W * C
        plan = dwconv.launch_plan(B, H, W, C, kk)
        line.update(
            plan={key: plan[key] for key in ("tile", "threads", "blocks", "blocks_per_sm",
                                             "waves", "smem_bytes")},
            ms=device_ms(lambda: dwconv.depthwise_conv2d(x, w, bias)),
            **bound_fields(nbytes, flops))
        if full:
            x_nchw = x.permute(0, 3, 1, 2)  # the same memory, as cuDNN's channels-last input
            line.update(
                plain_ms=device_ms(lambda: dw_plain(x, w, bias), reps=2, trials=3),
                library_ms=device_ms(lambda: F.conv2d(x_nchw, w, bias, padding=kk // 2,
                                                      groups=C)))
        per_shape.append(dict(kernel="dwconv", shape=dict(B=B, H=H, W=W, C=C, k=kk),
                              calls=calls, **line))
    rng = np.random.default_rng(SEED + batch - 1)
    for (N, L, S, C, H), calls in sorted(loftr_shapes.items()):
        def normal(*shape, mean=0.0, std=1.0):
            a = (mean + std * rng.standard_normal(shape)).astype(np.float32)
            return torch.from_numpy(a).cuda()

        x, src = normal(N, L, C), normal(N, S, C)
        layer = LoFTREncoderLayer(C, H).cuda()
        for name, w in layer.named_parameters():
            w.data.copy_(normal(*w.shape, mean=1.0 if name.endswith("norm1.weight")
                                or name.endswith("norm2.weight") else 0.0, std=0.1))
        p = layer.loftr_params()
        with torch.no_grad():
            line = checked("fused_loftr", (N, L, S, C, H), fused_loftr.fused_loftr(x, src, p, H),
                           loftr_apply(x, src, p, H))
            D = C // H
            nbytes = 4 * (2 * N * L * C + N * S * C + 10 * C * C + 4 * C)
            flops = 2 * (N * L * 8 * C * C + N * S * 2 * C * C + N * H * (S + L) * D * D)
            line.update(ms=device_ms(lambda: fused_loftr.fused_loftr(x, src, p, H)),
                        **bound_fields(nbytes, flops),
                        bound_tc_ms=max(nbytes / PEAK_BYTES, flops / PEAK_TF32_3X) * 1e3)
            if full:
                line.update(**pass_split(lambda: fused_loftr.fused_loftr(x, src, p, H)),
                            plain_ms=device_ms(lambda: loftr_apply(x, src, p, H)),
                            unfused_ms=device_ms(lambda: layer.modules_forward(x, src)),
                            library_ms=None)
        per_shape.append(dict(kernel="fused_loftr", shape=dict(N=N, L=L, S=S, C=C, H=H),
                              calls=calls, **line))
    for r in per_shape:
        emit(dict(phase="kernel_shape", batch=batch, mode=mode, **r))
    return per_shape


def check_gradients(config, geoms, batch: int, dtype=torch.float32):
    """Phase 4: each kernel's gradients at every train-step shape (``mode``
    "train") held against autograd of its plain version on the same inputs,
    each within ``TOL`` of its max |plain| (in bf16 ``BF16_TOL``, the
    gradients in bf16 as the inputs): dq, dk, dv of the attention calls
    (the kernel's backward is that autograd, recomputed from the saved
    inputs); dx, dW, db of dwconv (dx: the forward kernel on the rotated
    taps; dW: PyTorch's depthwise weight gradient), against the plain twin
    at one batch row where k = 31 (its autograd is 961 full-size passes);
    dx, dsource, wq and w1 of the fused LoFTR layer. Each line also times
    the backward at the full batch: for dwconv dx, dW (from NCHW copies, as
    the port calls it, copies included, and also on the channels-last
    views, which PyTorch hands to cuDNN) and db apart, against the bounds
    of their work, and cuDNN's forward on the same inputs."""
    from cfpnet_torch.kernels import dwconv, fused_loftr, linear_attention
    from cfpnet_torch.kernels.dtypes import dtype_name
    from cfpnet_torch.models.transformer import LoFTREncoderLayer
    from cfpnet_torch.ops.attention import linear_attention as att_plain
    from cfpnet_torch.ops.dwconv import depthwise_conv2d as dw_plain
    from cfpnet_torch.ops.loftr import loftr_apply

    tol, esize = (TOL, 4) if dtype == torch.float32 else (BF16_TOL, 2)
    att_shapes, dw_shapes, loftr_shapes = main_path_shapes(config, geoms, batch, "train")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 100)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device="cuda", generator=gen)).to(
            dtype).requires_grad_()

    def held(name, shape, got, ref):
        torch.cuda.synchronize()
        out = {}
        for key, a, b in zip(name.split(","), got, ref):
            if a.dtype != dtype or b.dtype != dtype:
                raise AssertionError(f"gradient {key} at {shape}: {a.dtype}, plain {b.dtype}")
            a, b = a.float(), b.float()
            err, top = float((a - b).abs().max()), float(b.abs().max())
            if not (err <= tol * top):
                raise AssertionError(f"gradient {key} at {shape} ({dtype}): max err {err} > "
                                     f"{tol} * {top}")
            out[key] = err / top
        return out

    lines = []
    for (N, L, S, H, D), calls in sorted(att_shapes.items()):
        if not calls:
            continue
        ins = [randn(N, L, H, D), randn(N, S, H, D), randn(N, S, H, D)]
        g = torch.randn(N, L, H, D, device="cuda", generator=gen).to(dtype)
        got = torch.autograd.grad(linear_attention.linear_attention(*ins), ins, g)
        ref = torch.autograd.grad(att_plain(*ins), ins, g)
        lines.append(dict(kernel="linear_attention", shape=dict(N=N, L=L, S=S, H=H, D=D),
                          calls=calls, max_rel_err=held("dq,dk,dv", (N, L, S, H, D), got, ref),
                          backward_ms=device_ms(lambda: torch.autograd.grad(
                              att_plain(*ins), ins, g), reps=5, trials=3)))
    for (B, H, W, C, k), calls in sorted(dw_shapes.items()):
        x, w, b = randn(B, H, W, C), randn(C, 1, k, k, scale=0.05), randn(C)
        g = torch.randn(B, H, W, C, device="cuda", generator=gen).to(dtype)
        rows = 1 if k == 31 else B
        ins = [x[:rows].detach().requires_grad_(), w, b]
        got = torch.autograd.grad(dwconv.depthwise_conv2d(*ins), ins, g[:rows])
        ref = torch.autograd.grad(dw_plain(*ins), ins, g[:rows])
        errs = held("dx,dW,db", (rows, H, W, C, k), got, ref)
        wflip = w.detach().flip(-1, -2)
        xd = x.detach()
        x_nchw, g_nchw = xd.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        nbytes = esize * (2 * B * H * W * C + C * k * k)
        flops = 2 * k * k * B * H * W * C
        line = dict(
            kernel="dwconv", shape=dict(B=B, H=H, W=W, C=C, k=k), calls=calls,
            checked_rows=rows, max_rel_err=errs,
            dx_ms=device_ms(lambda: dwconv.depthwise_conv2d(g, wflip)),
            dw_ms=device_ms(lambda: torch.nn.grad.conv2d_weight(
                x_nchw.contiguous(), w.shape, g_nchw.contiguous(), padding=k // 2, groups=C),
                reps=5, trials=3),
            db_ms=device_ms(lambda: g.sum((0, 1, 2))),
            dw_channels_last_ms=device_ms(lambda: torch.nn.grad.conv2d_weight(
                x_nchw, w.shape, g_nchw, padding=k // 2, groups=C), reps=2, trials=3),
            library_conv_ms=device_ms(lambda: F.conv2d(x_nchw, w.detach(), b.detach(),
                                                       padding=k // 2, groups=C)),
            dx_bound=bound_fields(nbytes, flops), dw_bound=bound_fields(nbytes, flops))
        lines.append(line)
    rng = np.random.default_rng(SEED + 100)
    for (N, L, S, C, H), calls in sorted(loftr_shapes.items()):
        def normal(*shape, mean=0.0, std=1.0):
            a = (mean + std * rng.standard_normal(shape)).astype(np.float32)
            return torch.from_numpy(a).cuda().to(dtype)

        x, src = normal(N, L, C).requires_grad_(), normal(N, S, C).requires_grad_()
        layer = LoFTREncoderLayer(C, H).cuda().to(dtype)
        with torch.no_grad():
            for name, w in layer.named_parameters():
                w.copy_(normal(*w.shape, mean=1.0 if name.endswith(("norm1.weight",
                                                                     "norm2.weight")) else 0.0,
                               std=0.1))
        p = layer.loftr_params()
        g = normal(N, L, C)
        ins = [x, src, p.wq, p.w1]
        got = torch.autograd.grad(fused_loftr.fused_loftr(x, src, p, H), ins, g)
        ref = torch.autograd.grad(loftr_apply(x, src, p, H), ins, g)
        everything = [x, src, *p]
        lines.append(dict(kernel="fused_loftr", shape=dict(N=N, L=L, S=S, C=C, H=H),
                          calls=calls,
                          max_rel_err=held("dx,dsource,dwq,dw1", (N, L, S, C, H), got, ref),
                          backward_ms=device_ms(lambda: torch.autograd.grad(
                              loftr_apply(x, src, p, H), everything, g), reps=5, trials=3)))
    for r in lines:
        emit(dict(phase="kernel_gradient", batch=batch, dtype=dtype_name(dtype), **r))
    return lines


KERNEL_META = {
    "linear_attention": ("cfpnet_torch/csrc/linear_attention.cu",
                         "cfpnet_tpu/ops/pallas_attention.py:109"),
    "dwconv": ("cfpnet_torch/csrc/dwconv.cu", "cfpnet_tpu/ops/pallas_dwconv.py:41"),
    "fused_loftr": ("cfpnet_torch/csrc/fused_loftr.cu", "cfpnet_tpu/ops/pallas_loftr.py:156"),
}


def kernel_rows(per_shape, per_shape_bs8, per_shape_train, gradients):
    """The kernel table: per kernel, the sums over a bs=1 forward of the
    phase-3 lines (calls x per-call value), and beside them the kernel's ms,
    bound and error at bs=8 (``*_bs8``) and in a bs=16 train step's forward
    (``*_train``), and the train step's backward from the phase-4 lines:
    its ms (``backward_ms_train``; for dwconv dx, dW and db,
    ``dx_ms_train``, ``dw_library_ms_train``) and its worst gradient error
    over max |plain| (``grad_max_rel_err_train``)."""
    rows = []
    for name, (source, replaces) in KERNEL_META.items():
        def per_forward(lines, key):
            mine = [r for r in lines if r["kernel"] == name]
            if any(r[key] is None for r in mine):
                return None
            return sum(r["calls"] * r[key] for r in mine)

        def worst(lines):
            return max(r["max_abs_err"] / r["max_abs_plain"] for r in lines
                       if r["kernel"] == name)

        extra = {}
        if name == "fused_loftr":
            extra = {key: per_forward(per_shape, key)
                     for key in ("summary_ms", "rows_ms", "unfused_ms", "bound_tc_ms")}
        mine = [r for r in gradients if r["kernel"] == name]
        if name == "dwconv":
            extra.update(dx_ms_train=per_forward(gradients, "dx_ms"),
                         dw_library_ms_train=per_forward(gradients, "dw_ms"),
                         dw_library_channels_last_ms_train=per_forward(gradients,
                                                                       "dw_channels_last_ms"),
                         db_ms_train=per_forward(gradients, "db_ms"))
            extra["backward_ms_train"] = (extra["dx_ms_train"] + extra["dw_library_ms_train"]
                                          + extra["db_ms_train"])
        else:
            extra["backward_ms_train"] = per_forward(gradients, "backward_ms")
        extra["grad_max_rel_err_train"] = max(max(r["max_rel_err"].values()) for r in mine)
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=None,
            max_abs_err=max(r["max_abs_err"] for r in per_shape if r["kernel"] == name),
            ms=per_forward(per_shape, "ms"), plain_ms=per_forward(per_shape, "plain_ms"),
            bound_ms=per_forward(per_shape, "bound_ms"),
            bound_by=("bytes" if per_forward(per_shape, "bytes_ms")
                      >= per_forward(per_shape, "ops_ms") else "operations"),
            library_ms=per_forward(per_shape, "library_ms"),
            calls_per_forward=sum(r["calls"] for r in per_shape if r["kernel"] == name),
            **extra,
            ms_bs8=per_forward(per_shape_bs8, "ms"),
            bound_ms_bs8=per_forward(per_shape_bs8, "bound_ms"),
            max_rel_err_bs8=worst(per_shape_bs8),
            ms_train=per_forward(per_shape_train, "ms"),
            bound_ms_train=per_forward(per_shape_train, "bound_ms"),
            max_rel_err_train=worst(per_shape_train)))
    return rows


def bf16_train_fields(name, lines, gradients):
    """A kernel row's bf16 train columns: in a bs=16 bf16 train step's
    forward (``check_kernels_bf16`` at mode "train"; calls x per-call
    value) the kernel's ms, bound, worst error over max |plain| and share
    of elements that differ; its backward from the bf16 phase-4 lines
    (``backward_ms_train_bf16``; for dwconv dx, dW and db,
    ``dx_ms_train_bf16``, ``dw_library_ms_train_bf16``,
    ``db_ms_train_bf16``) and its worst gradient error over max |plain|."""
    def per_step(ls, key):
        return sum(r["calls"] * r[key] for r in ls if r["kernel"] == name)

    mine = [r for r in lines if r["kernel"] == name]
    out = dict(ms_train_bf16=per_step(lines, "ms"),
               bound_ms_train_bf16=per_step(lines, "bound_ms"),
               bound_by_train_bf16=("bytes" if per_step(lines, "bytes_ms")
                                    >= per_step(lines, "ops_ms") else "operations"),
               max_rel_err_train_bf16=max(r["max_abs_err"] / r["max_abs_plain"] for r in mine),
               differ_share_train_bf16=max(r["differ_share"] for r in mine))
    if name == "dwconv":
        parts = dict(dx_ms_train_bf16="dx_ms", dw_library_ms_train_bf16="dw_ms",
                     db_ms_train_bf16="db_ms")
        out.update({key: per_step(gradients, part) for key, part in parts.items()})
        out["backward_ms_train_bf16"] = sum(out[key] for key in parts)
    else:
        out["backward_ms_train_bf16"] = per_step(gradients, "backward_ms")
    out["grad_max_rel_err_train_bf16"] = max(max(r["max_rel_err"].values()) for r in gradients
                                             if r["kernel"] == name)
    return out


def golden_train_config():
    """The production model at the train step's shape (bs 16 at 416x544 in
    ``evaluate_time.train_config``), at bs ``GOLDEN_TRAIN_BS``."""
    from cfpnet_torch.evaluate_time import train_config

    return train_config(production_config()).replace(bs=GOLDEN_TRAIN_BS)


def golden_train_batch(config):
    """The golden step's batch, numpy, from formulas (no RNG): the golden
    forward's image and histograms (``weights.det_leaf``), a smooth depth
    with invalid pixels, one zone in seven without signal."""
    from cfpnet_torch import weights

    B, h, w = config.bs, config.input_height, config.input_width
    Z = config.train_zone_num ** 2
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    depth = np.stack([1.0 + 1.5 * np.sin(yy / (37.0 + 5 * b)) ** 2
                      + 1.2 * np.cos(xx / (53.0 - 7 * b)) ** 2 for b in range(B)])
    depth[:, (yy.astype(int) * 7 + xx.astype(int) * 13) % 50 == 0] = 0.0
    return dict(image=weights.det_leaf("img", (B, h, w, 3)),
                depth=depth[..., None].astype(np.float32),
                hist_data=np.abs(weights.det_leaf("hist", (B, Z, config.zone_sample_num))) * 20,
                mask=(np.arange(B * Z) % 7 != 3).reshape(B, Z))


def golden_crop_offsets(config, seed: int):
    """The crop offsets the train step draws at ``seed``: its generator's
    draws in the decoder's order of scales (16, 8, 4)."""
    from cfpnet_torch.models.fusion import crop_offsets
    from cfpnet_torch.train.steps import step_generator

    gen = step_generator(seed)
    h, w = config.input_height, config.input_width
    nh, nw = config.native_height, config.native_width
    return [crop_offsets(h // s, w // s, nh // s, nw // s, gen) for s in (16, 8, 4)]


def leaf_indices(n: int):
    """The fixed flat indices of a leaf at which the golden keeps entries."""
    return np.unique(np.linspace(0, n - 1, min(16, n)).round().astype(np.int64))


def golden_record(model, loss, prefix: str = ""):
    """What the golden keeps of a step just taken (``GOLDEN_TRAIN``'s keys):
    the loss; per parameter its gradient's sum and norm, its gradient and
    its value after the step at ``leaf_indices``; every BatchNorm running
    statistic. ``prefix`` goes before each parameter's name."""
    rec = {"loss": float(loss)}
    for k, p in model.named_parameters():
        g = p.grad.detach().double().cpu().numpy().ravel()
        idx = leaf_indices(g.size)
        k = prefix + k
        rec.update({"grad_sum:" + k: g.sum(), "grad_norm:" + k: np.linalg.norm(g),
                    "grad_at:" + k: g[idx],
                    "param_at:" + k: p.detach().double().cpu().numpy().ravel()[idx]})
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            rec["stat:" + prefix + k] = v.double().cpu().numpy()
    return rec


def golden_errors(got, ref, start=None, terms=("loss",)):
    """Errors of a step's record ``got`` against ``ref`` (both with the
    golden's keys), each the largest over the parameters of a class:
    ``head`` (``depth_head``, ``conv_out``: downstream of every
    BatchNorm), ``pose`` (the self-supervised variant's PoseNet, names
    ``pose.*``), ``trunk`` (the rest), and ``zero`` (those whose reference
    gradient is zero in exact arithmetic, a norm below 1e-12 of the global
    one: a conv bias before a train-mode BatchNorm). ``start`` is the
    state_dict the step started from by the record's names (default: the
    deterministic weights of ``golden_train_config``):

    - each of ``terms`` (the loss, and the self-supervised step's loss
      terms): |value - value_ref| / |value_ref|;
    - ``<class>_grad_norm``: a gradient's norm, relative;
    - ``<class>_grad_sum``: its sum, over its norm times sqrt(size) (the
      most the sum can be);
    - ``<class>_grad_at``: its entries at ``leaf_indices``, over its RMS
      (norm over sqrt(size));
    - ``<class>_param_at``: the parameter after the step at those entries,
      over the step's learning rate for it, where the reference gradient is
      at least the RMS (there the first Adam step's direction
      g / (|g| + eps) is the gradient's sign);
    - ``zero_grad_norm``: the gradient's norm over the global norm;
    - ``stat``: a running statistic after the step, over the largest change
      the step made to it (0.1 of the batch statistic; 0.9 of the old value
      is exact).

    Each of these but ``loss`` also comes as ``<key>_median``, the median
    of the same values (a value a parameter for a norm or a sum, a value an
    entry or a channel for the rest) where the key itself is their largest:
    one ill-conditioned entry sets the largest, while a step that leaves a
    class unchanged (a running statistic frozen, a gradient zeroed, a
    parameter unmoved) reads about 1 in the median.
    """
    from cfpnet_torch import weights
    from cfpnet_torch.train.optim import LR_SCALE, onecycle_schedules, param_group_labels

    config = golden_train_config()
    if start is None:
        start = weights.deterministic_state_dict(config)
    names = [k.split(":", 1)[1] for k in ref.keys() if k.startswith("grad_norm:")]
    labels = param_group_labels(names, config.hist_encoder_10x)
    lr0 = onecycle_schedules(config.lr, GOLDEN_TRAIN_TOTAL_STEPS, config.div_factor,
                             config.final_div_factor)[0](0)
    global_norm = np.sqrt(sum(float(ref["grad_norm:" + k]) ** 2 for k in names))
    values = {}

    def worst(key, value):
        values.setdefault(key, []).append(np.atleast_1d(np.asarray(value, np.float64)))

    for k in names:
        norm, n = float(ref["grad_norm:" + k]), start[k].numel()
        if norm <= 1e-12 * global_norm:
            worst("zero_grad_norm", float(got["grad_norm:" + k]) / global_norm)
            continue
        cls = ("pose" if k.startswith("pose.") else
               "head" if k.startswith(("depth_head.", "conv_out.")) else "trunk")
        rms = norm / np.sqrt(n)
        g_ref = ref["grad_at:" + k]
        worst(cls + "_grad_norm", abs(float(got["grad_norm:" + k]) - norm) / norm)
        worst(cls + "_grad_sum", abs(float(got["grad_sum:" + k]) - float(ref["grad_sum:" + k]))
              / (norm * np.sqrt(n)))
        worst(cls + "_grad_at", np.abs(got["grad_at:" + k] - g_ref) / rms)
        clear = np.abs(g_ref) >= rms
        if clear.any():
            lr = float(np.float32(lr0 * np.float32(LR_SCALE[labels[k]])))
            worst(cls + "_param_at",
                  np.abs(got["param_at:" + k] - ref["param_at:" + k])[clear] / lr)
    for k in ref.keys():
        if k.startswith("stat:"):
            moved = np.abs(ref[k] - 0.9 * start[k[5:]].double().numpy()).max()
            worst("stat", np.abs(got[k] - ref[k]) / moved)
    errs = {t: abs(float(got[t]) - float(ref[t])) / abs(float(ref[t])) for t in terms}
    for key, parts in values.items():
        every = np.concatenate(parts)
        errs[key], errs[key + "_median"] = float(every.max()), float(np.median(every))
    return errs


def train_golden_errors(device="cuda", compute_dtype="float32"):
    """One step of the port's train step (``train/steps.py``) in
    ``compute_dtype`` on ``golden_train_batch`` with the deterministic
    weights and the golden's crop offsets, against ``GOLDEN_TRAIN``
    (``golden_errors``; the golden is float64 in either case). Returns (the
    errors, the launch counts of the step, the loss)."""
    model, loss, launches = golden_train_step(device, compute_dtype)
    return golden_errors(golden_record(model, loss), np.load(GOLDEN_TRAIN)), launches, float(loss)


def golden_train_step(device="cuda", compute_dtype="float32", rows=lambda batch: batch,
                      grid=None):
    """``train_golden_errors``' step: (the model after it, the loss, the
    launch counts of the step). ``rows`` takes the golden batch to the rows
    the step runs on (a data-parallel process's: ``mesh.shard_batch``);
    ``grid`` is a spatial grid the step runs on (``parallel/spatial.py``)."""
    from cfpnet_torch import kernels, weights
    from cfpnet_torch.models import fusion
    from cfpnet_torch.models.deltar import make_model, model_geometries
    from cfpnet_torch.train import steps

    ref = np.load(GOLDEN_TRAIN)
    config = golden_train_config().replace(compute_dtype=compute_dtype)
    model = make_model(config, device=device)
    model.load_state_dict(weights.deterministic_state_dict(config), strict=True)
    geoms = model_geometries(config, "train")
    state = steps.create_train_state(model, config, GOLDEN_TRAIN_TOTAL_STEPS)
    train_step = steps.make_train_step(model, config, geoms, grid)
    batch = rows({k: torch.from_numpy(v).to(device)
                  for k, v in golden_train_batch(config).items()})
    offsets = [tuple(o) for o in ref["crop_offsets"].tolist()]
    if offsets != golden_crop_offsets(config, GOLDEN_TRAIN_SEED):
        print("chip_smoke: this torch's generator draws other crop offsets than the golden's; "
              "the golden's are used", file=sys.stderr)
    pinned = iter(offsets)
    real = fusion.crop_offsets
    fusion.crop_offsets = lambda *args: next(pinned)
    try:
        kernels.reset_launches()
        loss = train_step(state, batch, GOLDEN_TRAIN_SEED)
        if device != "cpu":
            torch.cuda.synchronize()
        launches = {k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels.KERNELS}
    finally:
        fusion.crop_offsets = real
    if next(pinned, None) is not None:
        raise AssertionError("the step drew fewer crop offsets than the golden holds")
    return model, loss, launches


def golden_selfsup_config():
    """The golden self-supervised step's configuration: the production model
    at the train step's shape, bs ``GOLDEN_TRAIN_BS``, ``--selfsup``."""
    return golden_train_config().replace(selfsup=True, dataset="synthetic")


def golden_selfsup_batch(config):
    """The golden self-supervised step's batch, numpy, from formulas (no
    RNG): ``golden_train_batch``'s histograms and mask; a smooth textured
    target frame in 0..1 (``image_raw``, normalized into ``image``); the
    source frame, the target rolled by (2, -3) px; the synthetic pairs'
    intrinsics (``data/datasets.py::SyntheticPairDataset``); zone means
    1.1 times the zone means of ``golden_train_batch``'s depth."""
    from cfpnet_torch.data.datasets import NYU_K, normalize_image
    from cfpnet_torch.data.geometry import geometry_for

    base = golden_train_batch(config)
    B, h, w = config.bs, config.input_height, config.input_width
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    raw = np.stack([np.stack([0.5 + 0.2 * np.sin(yy / (9.0 + 2 * b + c))
                              * np.cos(xx / (13.0 - b + 2 * c)) + 0.1 * np.sin((xx + yy) / 5.0)
                              for c in range(3)], -1) for b in range(B)]).astype(np.float32)
    fx = float(NYU_K[0])
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], np.float32)
    g = geometry_for(config, "train")
    zn, ph, pw = g.zone_num, g.patch_px_h, g.patch_px_w
    region = base["depth"][:, g.sy_px:g.sy_px + zn * ph, g.sx_px:g.sx_px + zn * pw, 0]
    zones = region.reshape(B, zn, ph, zn, pw).transpose(0, 1, 3, 2, 4).reshape(B, zn * zn, -1)
    return dict(image=normalize_image(raw).astype(np.float32), image_raw=raw,
                src_raw=np.roll(raw, (2, -3), axis=(1, 2)),
                hist_data=base["hist_data"], mask=base["mask"],
                zone_mu=(1.1 * zones.mean(-1)).astype(np.float32),
                K=np.broadcast_to(K, (B, 3, 3)).copy(),
                K_inv=np.broadcast_to(np.linalg.inv(K).astype(np.float32), (B, 3, 3)).copy())


def selfsup_golden_record(joint, terms):
    """``golden_record`` of a self-supervised step: the depth model's
    entries under their own names, PoseNet's under ``pose.*``, and the four
    loss terms."""
    from cfpnet_torch.train.selfsup import LOSS_TERMS

    rec = golden_record(joint.depth, terms["loss"])
    rec.update(golden_record(joint.pose, terms["loss"], prefix="pose."))
    rec.update({k: float(terms[k]) for k in LOSS_TERMS})
    return rec


def selfsup_golden_start(config):
    """The deterministic joint weights by the record's names."""
    from cfpnet_torch import weights

    return {k[len("depth."):] if k.startswith("depth.") else k: v
            for k, v in weights.deterministic_selfsup_state_dict(config).items()}


def selfsup_golden_errors(device="cuda"):
    """One step of the port's self-supervised step
    (``train/selfsup.py``) on ``golden_selfsup_batch`` with the
    deterministic depth and pose weights and the golden's crop offsets,
    against ``GOLDEN_SELFSUP`` (``golden_errors`` with the four loss
    terms). Returns (the errors, the launch counts of the step, the
    terms)."""
    from cfpnet_torch import kernels, weights
    from cfpnet_torch.data.geometry import geometry_for
    from cfpnet_torch.models import fusion
    from cfpnet_torch.models.deltar import make_model, model_geometries
    from cfpnet_torch.models.posenet import PoseNet
    from cfpnet_torch.train import selfsup

    ref = np.load(GOLDEN_SELFSUP)
    config = golden_selfsup_config()
    model = make_model(config, device=device)
    state = selfsup.create_selfsup_state(model, config, GOLDEN_TRAIN_TOTAL_STEPS,
                                         PoseNet().to(device))
    state.model.load_state_dict(weights.deterministic_selfsup_state_dict(config), strict=True)
    step = selfsup.make_selfsup_train_step(state, config, model_geometries(config, "train"),
                                           geometry_for(config, "train"))
    batch = {k: torch.from_numpy(v).to(device) for k, v in golden_selfsup_batch(config).items()}
    offsets = [tuple(o) for o in ref["crop_offsets"].tolist()]
    if offsets != golden_crop_offsets(config, GOLDEN_TRAIN_SEED):
        print("chip_smoke: this torch's generator draws other crop offsets than the selfsup "
              "golden's; the golden's are used", file=sys.stderr)
    pinned = iter(offsets)
    real = fusion.crop_offsets
    fusion.crop_offsets = lambda *args: next(pinned)
    try:
        kernels.reset_launches()
        terms = step(state, batch, GOLDEN_TRAIN_SEED)
        if device != "cpu":
            torch.cuda.synchronize()
        launches = {k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels.KERNELS}
    finally:
        fusion.crop_offsets = real
    if next(pinned, None) is not None:
        raise AssertionError("the selfsup step drew fewer crop offsets than the golden holds")
    errs = golden_errors(selfsup_golden_record(state.model, terms), ref,
                         selfsup_golden_start(config), terms=selfsup.LOSS_TERMS)
    return errs, launches, {k: float(v) for k, v in terms.items()}


def golden_diffs(bin_edges, pred, golden: str = GOLDEN_FULL):
    """Max abs differences of a bs=1 forward's outputs from ``golden``
    (default ``tests/golden/full_forward.npz``); raises outside that test's
    tolerance (rtol 5e-4, atol 5e-5)."""
    ref = np.load(golden)
    got = dict(pred_slice=pred.cpu().numpy()[0, ::16, ::16, 0],
               bin_edges16=bin_edges.cpu().numpy()[0, ::16],
               pred_mean=pred.mean().cpu().numpy()[None])
    diffs = {}
    for key, val in got.items():
        np.testing.assert_allclose(val, ref[key], rtol=5e-4, atol=5e-5,
                                   err_msg=f"{os.path.basename(golden)}: mismatch in {key}")
        diffs[key] = float(np.abs(val - ref[key]).max())
    return diffs


def eager_launches(model, args, geoms):
    """The kernels' launch counts of one eager forward (all 0 on the CPU,
    where the wrappers run their plain versions)."""
    from cfpnet_torch import kernels

    kernels.reset_launches()
    with torch.no_grad():
        out = model(*args, geoms)
    if out[1].is_cuda:
        torch.cuda.synchronize()
    return out, launch_counts()


def check_launches(launches, batch):
    if launches != {"linear_attention": 6, "dwconv": 6, "fused_loftr": 18}:
        raise AssertionError(f"the bs={batch} forward launched {launches}, expected 6 "
                             "attention, 6 dwconv and 18 fused LoFTR launches")


def same_outputs(got, want, what):
    """Raises unless the forward outputs ``got`` equal ``want`` bit for bit."""
    for name, a, b in zip(("bin_edges", "pred", "prob"), got, want):
        if not torch.equal(a, b):
            diff = float((a - b).abs().max()) / float(b.abs().max())
            raise AssertionError(f"{what}: {name} differs from the eager forward "
                                 f"(max |diff| / max |eager| = {diff})")


def graph_phase(model, config, geoms, args):
    """Phase 5: the forward captured in a CUDA graph at bs=1 and bs=8.

    bs=1: the replay equals the eager forward bit for bit and matches the
    golden; 20 replays with changed inputs each equal their eager forward.
    bs=8 on 8 synthetic samples: an eager pass still launches 6/6/18, the
    replay equals the eager bs=8 forward bit for bit, and each row matches
    the bs=1 forward of its sample (rtol 5e-4, atol 5e-5: the convolutions'
    algorithms and sums change with the batch)."""
    from cfpnet_torch.data.datasets import SyntheticDataset, collate
    from cfpnet_torch.graphs import CapturedForward

    captured = CapturedForward(model, geoms, 1, config)
    got = [t.clone() for t in captured(*args)[:3]]
    with torch.no_grad():
        eager = model(*args, geoms)
    same_outputs(got, eager, "bs=1 replay")
    golden = golden_diffs(got[0], got[1])
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    img, hist, mask = args
    for i in range(20):
        changed = (img + 0.1 * torch.randn(img.shape, device="cuda", generator=gen),
                   hist * (1.0 + 0.1 * i), torch.rand(mask.shape, device="cuda",
                                                      generator=gen) > 0.1 * (i % 4))
        got = [t.clone() for t in captured(*changed)[:3]]
        with torch.no_grad():
            eager = model(*changed, geoms)
        same_outputs(got, eager, f"bs=1 replay {i} on changed inputs")
    del captured

    dataset = SyntheticDataset(config, "online_eval", 8)
    samples = [dataset[i] for i in range(8)]
    batch = collate(samples)
    args8 = tuple(torch.from_numpy(batch[k]).cuda() for k in ("image", "hist_data", "mask"))
    eager8, launches8 = eager_launches(model, args8, geoms)
    check_launches(launches8, 8)
    captured = CapturedForward(model, geoms, 8, config)
    got8 = captured(*args8)
    same_outputs(got8, eager8, "bs=8 replay")
    rows = {}
    with torch.no_grad():
        for i in range(8):
            one = model(*(a[i:i + 1] for a in args8), geoms)
            for name, a, b in zip(("bin_edges", "pred", "prob"), got8, one):
                np.testing.assert_allclose(a[i:i + 1].cpu().numpy(), b.cpu().numpy(),
                                           rtol=5e-4, atol=5e-5,
                                           err_msg=f"bs=8 row {i} {name} against bs=1")
                rows[name] = max(rows.get(name, 0.0), float((a[i:i + 1] - b).abs().max()))
    del captured
    return dict(phase="graph", bs1_replay_equals_eager=True, replays_on_changed_inputs=20,
                golden_max_abs_diff=golden, bs8_launches_eager=launches8,
                bs8_replay_equals_eager=True, bs8_rows_max_abs_diff_vs_bs1=rows)


def device_events(fn):
    """torch.profiler over one ``fn()`` and a synchronize: the events of the
    run, summed by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.key_averages()


class HostWaits:
    """Context manager that counts the host's copies and waits in its body:
    copies from the host to the device (``h2d``; of them from pageable
    memory, ``h2d_pageable``) and from the device to the host (``d2h``,
    ``.item()`` included) at the aten level, on the calling thread; the
    profiler's ``Memcpy HtoD`` / ``Memcpy DtoH`` device events (a short
    profile does not always receive them); the stream and event
    synchronizations the profiler sees (``syncs``), and apart its device
    synchronizations (``device_syncs``), among them the one this counter
    makes at the end to collect the device events. Results in ``counts``
    after exit."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_flatten

        counts = self.counts = dict(h2d=0, h2d_pageable=0, d2h=0)

        class Copies(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
                name = func.name()
                if name.startswith(("aten::_to_copy", "aten::copy_")):
                    if (any(t.device.type == "cpu" for t in ins)
                            and out.device.type == "cuda"):
                        counts["h2d"] += 1
                        counts["h2d_pageable"] += any(t.device.type == "cpu" and not t.is_pinned()
                                                      for t in ins)
                    if (any(t.device.type == "cuda" for t in ins)
                            and out.device.type == "cpu"):
                        counts["d2h"] += 1
                elif name.startswith("aten::_local_scalar_dense") and ins[0].is_cuda:
                    counts["d2h"] += 1
                return out

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.mode = Copies()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        events = self.prof.key_averages()

        def n(key):
            return sum(e.count for e in events if e.key == key)

        self.counts.update(
            profiler_h2d=sum(e.count for e in events if "HtoD" in e.key),
            profiler_d2h=sum(e.count for e in events if "DtoH" in e.key),
            syncs=n("cudaStreamSynchronize") + n("cudaEventSynchronize"),
            device_syncs=n("cudaDeviceSynchronize"))
        self.events = events
        return False


def host_waits(fn):
    """(copies from the host to the device, ``cudaStreamSynchronize`` calls)
    of one ``fn()``: the copies counted at the aten level (a copy of a CPU
    tensor into a CUDA one) and by the profiler's ``Memcpy HtoD`` device
    events; the syncs by the profiler (``HostWaits``)."""
    with HostWaits() as w:
        fn()
    return dict(aten=w.counts["h2d"], profiler=w.counts["profiler_h2d"]), w.counts["syncs"]


def busy(events, latency_ms: float):
    """Device time, launches and busy share of a profiled forward."""
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in device)
    if total_us <= 0:
        return dict(device_ms="not measured (the profiler saw no device time)")
    top = sorted(device, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    return dict(device_ms=total_us / 1e3, kernel_launches=sum(e.count for e in device),
                latency_ms=latency_ms, busy_share=total_us / 1e3 / latency_ms,
                top=[dict(name=e.key[:80], calls=e.count, ms=e.self_device_time_total / 1e3)
                     for e in top])


def profile_phase(model, config, geoms, args, entry):
    """Phase 7: where the time of the bs=1 forward goes on the device,
    eager and replayed, against the entry point's latencies; the host's
    copies and stream syncs in one warmed eager forward, which must be none
    (a copy of a host array to the card is the positive control: the
    counter sees its copy and its sync)."""
    from cfpnet_torch.graphs import CapturedForward

    with torch.no_grad():
        for _ in range(3):
            model(*args, geoms)
        torch.cuda.synchronize()
        eager = device_events(lambda: model(*args, geoms))
        copies, syncs = host_waits(lambda: model(*args, geoms))
    control = host_waits(lambda: torch.as_tensor(np.ones(4), device="cuda"))
    captured = CapturedForward(model, geoms, 1, config)
    captured(*args)
    replay = device_events(captured.replay)
    del captured
    return dict(phase="profile", host_to_device_copies=copies, stream_syncs=syncs,
                control_copies_syncs=control,
                eager=busy(eager, entry["latency_ms_bs1_eager"]),
                replay=busy(replay, entry["latency_ms_bs1"]))


def check_host_waits(profile):
    """Raises unless the counters saw the control's copy and sync and the
    warmed eager forward made neither."""
    copies, syncs = profile["control_copies_syncs"]
    if copies["aten"] < 1 or syncs < 1:
        raise AssertionError(f"the counters did not see a host copy and its sync: {copies}, "
                             f"{syncs}")
    if any(profile["host_to_device_copies"].values()) or profile["stream_syncs"]:
        raise AssertionError(f"a warmed eager forward made {profile['host_to_device_copies']} "
                             f"host-to-device copies and {profile['stream_syncs']} stream syncs")


TRAIN_LAUNCHES = {"linear_attention": 6, "dwconv": 12, "fused_loftr": 18}
EVAL_LAUNCHES = {"linear_attention": 6, "dwconv": 6, "fused_loftr": 18}
EVAL_METRICS = ("a1", "a2", "a3", "abs_rel", "rmse", "log_10", "rmse_log", "silog", "sq_rel")
# the kernels of a profiled train step, by kind (device kernel names)
KINDS = (("ported kernels", ("attention_sum_kernel", "attention_apply_kernel", "dwconv_kernel",
                             "summary_kernel", "rows_kernel")),
         ("optimizer (foreach)", ("multi_tensor_apply",)),
         ("large-kernel dW (torch's depthwise weight gradient)",
          ("conv_depthwise2d_grad_weight",)),
         ("cuDNN weight gradients", ("wgrad",)),
         ("cuDNN data gradients", ("dgrad",)),
         ("cuDNN forward convolutions", ("fprop", "conv", "implicit_gemm", "winograd")),
         ("matrix products", ("gemm", "gemv", "cutlass")),
         ("elementwise and reductions", ("elementwise", "reduce", "Reduce", "softmax",
                                         "cat", "index", "fill", "copy")))


def by_kind(events):
    """Device ms and launches of a profiled run, summed by ``KINDS``."""
    out = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = next((k for k, keys in KINDS if any(key in e.key for key in keys)), "other")
        d = out.setdefault(kind, dict(ms=0.0, launches=0))
        d["ms"] += e.self_device_time_total / 1e3
        d["launches"] += e.count
    return out


def train_step_phase(config, steps_timed: int = 10):
    """Phase 9: the production train step (``train/steps.py``) at
    ``config``'s shape (bs 16 at 416x544) and compute dtype, eager, on one
    synthetic batch and the deterministic weights: 10 steps whose losses
    must be finite and fall; the launch counts of one step (6 attention,
    6 + 6 dwconv, 18 fused LoFTR), every one on the compute dtype;
    ``steps_timed`` steps between CUDA events
    (``evaluate_time.train_latency_ms``, K = 5); one profiled step, with its
    casts (``aten::_to_copy`` calls); the peak of allocated memory; and
    after the steps every parameter, both AdamW moments and every running
    statistic still float32."""
    from cfpnet_torch import kernels, weights
    from cfpnet_torch.evaluate_time import make_train_batch, train_latency_ms
    from cfpnet_torch.models.deltar import make_model, model_geometries
    from cfpnet_torch.train import steps

    model = make_model(config, device="cuda")
    model.load_state_dict(weights.deterministic_state_dict(config), strict=True)
    geoms = model_geometries(config, "train")
    state = steps.create_train_state(model, config, GOLDEN_TRAIN_TOTAL_STEPS)
    train_step = steps.make_train_step(model, config, geoms)
    batch = make_train_batch(config, config.bs)
    seeds = iter(range(config.seed, config.seed + 10 ** 6))
    torch.cuda.reset_peak_memory_stats()
    losses = [float(train_step(state, batch, next(seeds))) for _ in range(10)]
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"train losses on one repeated batch: {losses}")
    kernels.reset_launches()
    train_step(state, batch, next(seeds))
    torch.cuda.synchronize()
    launches, by_dtype = launch_counts(), launches_by_dtype()
    if launches != TRAIN_LAUNCHES or any(d != {config.compute_dtype: launches[k]}
                                         for k, d in by_dtype.items()):
        raise AssertionError(f"a {config.compute_dtype} train step launched {by_dtype}, "
                             f"expected {TRAIN_LAUNCHES} on {config.compute_dtype}")
    ms = train_latency_ms(lambda: train_step(state, batch, next(seeds)), steps_timed, 5)
    events = device_events(lambda: train_step(state, batch, next(seeds)))
    held = [t.dtype for t in (*model.parameters(), *model.buffers(), *state.tx.mu.values(),
                              *state.tx.nu.values())]
    if set(held) != {torch.float32}:
        raise AssertionError(f"after {config.compute_dtype} steps the state holds {set(held)}")
    return dict(phase="train_step", batch=config.bs, dtype=config.compute_dtype,
                size=[config.input_height, config.input_width], ms_a_step=ms,
                images_a_s=config.bs * 1000.0 / ms, steps_timed=steps_timed,
                losses_first_10=losses, launches_a_step=launches, launches_by_dtype=by_dtype,
                casts_a_step=sum(e.count for e in events if e.key == "aten::_to_copy"),
                state_float32_entries=len(held),
                max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                profiled_step=busy(events, ms), profiled_step_by_kind=by_kind(events))


LOOP_EPOCHS = 2
LOOP_SAMPLES = 48  # synthetic train samples: 3 steps an epoch at bs 16; 48 eval images
LOOP_PROFILED_STEP = 1  # the profiled loop step: epoch 0's second (no log point)


def loop_config(config):
    """The loop phase's run: the production train step's configuration
    (``evaluate_time.train_config``) on ``LOOP_SAMPLES`` synthetic samples,
    ``LOOP_EPOCHS`` epochs, validation and checkpoints every epoch."""
    return config.replace(dataset="synthetic", dataset_eval="synthetic",
                          synthetic_length=LOOP_SAMPLES, epochs=LOOP_EPOCHS, validate_every=1,
                          name="chip_smoke_loop", save_dir="results/chip_smoke_loop",
                          no_logging=False, resume="", eval_bs=1)


def launch_counts():
    from cfpnet_torch import kernels

    return {k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels.KERNELS}


class LoopProbe:
    """``run_training``'s ``step_context``: each step's kernel launches (the
    counters' difference across it, no reset), and ``HostWaits`` over step
    ``LOOP_PROFILED_STEP``, the fetch of its batch included."""

    def __init__(self, cuda: bool = True):
        self.launches, self.waits, self.cuda = {}, None, cuda

    @contextlib.contextmanager
    def __call__(self, step):
        before = launch_counts()
        if step == LOOP_PROFILED_STEP and self.cuda:
            with HostWaits() as w:
                yield
            self.waits = w
        else:
            yield
        after = launch_counts()
        self.launches[step] = {k: after[k] - before[k] for k in after}


def loop_run(cfg, init, trace, probe=None, device="cuda"):
    """One ``run_training`` from the deterministic weights; returns (state,
    the JSONL lines, seconds)."""
    from cfpnet_torch.train.loop import run_training

    t0 = time.perf_counter()
    state = run_training(cfg, device=device, init_state_dict=init, trace=trace,
                         step_context=probe or (lambda step: contextlib.nullcontext()))
    seconds = time.perf_counter() - t0
    with open(os.path.join(cfg.save_dir, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    os.remove(os.path.join(cfg.save_dir, "train_log.jsonl"))
    return state, log, seconds


@contextlib.contextmanager
def deterministic_algorithms():
    """PyTorch's deterministic algorithms (warning, not raising, where an op
    has none: the bit-for-bit comparison they serve is the check), cuDNN's
    deterministic algorithms and no autotuning, and the cuBLAS workspace
    setting that PyTorch asks for with them. Yields the list of warnings
    raised meanwhile."""
    import warnings

    old = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
           os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old[2], old[3]
        if old[4] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = old[4]


def zeroed_moments(src: str, dst: str) -> None:
    """A copy of checkpoint ``src`` at ``dst`` with every group's moments
    set to 0: a resume that lost the optimizer's state (the resume check's
    planted fault)."""
    ckpt = torch.load(src, map_location="cpu", weights_only=True)
    for group in ckpt["opt_state"].values():
        for key in ("mu", "nu"):
            for v in group[key].values():
                v.zero_()
    torch.save(ckpt, dst)


def flat_state(state):
    """Parameters, statistics, moments and count of a ``TrainState``, on
    the CPU."""
    out = {"model." + k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    for g, gs in state.tx.state_dict().items():
        for key in ("mu", "nu"):
            out.update({f"{g}.{key}.{k}": v.detach().cpu() for k, v in gs[key].items()})
    return out, state.step


def params_diff(a, b):
    """max |a - b| over every parameter of two ``TrainState``s."""
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    return max(float((pa[k] - pb[k]).detach().abs().max()) for k in pa)


def state_differs(a, b):
    """The entries of two ``flat_state``s that are not equal bit for bit
    (the count included)."""
    (fa, sa), (fb, sb) = flat_state(a), flat_state(b)
    out = [k for k in fa if k not in fb or not torch.equal(fa[k], fb[k])]
    return out + (["step"] if sa != sb else []) + sorted(set(fb) - set(fa))


def loop_phase(config, bare_images_a_s: float, device="cuda", keep_weights=None):
    """Phase 10: ``train/loop.py::run_training`` on the card, at the
    production train step's configuration (``loop_config``) with the
    deterministic weights, in a temporary working directory removed after.

    - Run A (uninterrupted, the launch counters set to 0 before it and read
      after): finite losses; ``checkpoints/{name}/{0,1}_{rmse}``, ``best``
      and ``weights/{name}/...``; JSONL ``val`` lines with the nine metrics;
      each step launches ``TRAIN_LAUNCHES``, the run as a whole the steps'
      and the validation forwards' kernels; step ``LOOP_PROFILED_STEP``
      makes no device-to-host copy and no stream or event sync, and its
      host-to-device copies come from pinned memory (positive control: an
      ``.item()``). The last checkpoint loads back bit for bit.
    - The resume, under ``deterministic_algorithms`` (the default ones,
      cuDNN's weight gradients among them, are not bitwise repeatable):
      run D, uninterrupted; run R, resumed from D's epoch-0 checkpoint,
      whose epoch 1 takes A's and D's batch indices, zone offsets and
      learning rates, and equals D bit for bit in its losses and its final
      parameters, statistics, moments and step; and run C, the planted
      fault, resumed from that checkpoint with its moments zeroed, which
      must differ from D.

    Prints loop ms a step and images/s (epoch 1, no profiler) beside the
    bare step's images/s from phase 9, the consumer's wait for each step's
    batch and the producer's time for each batch, validation seconds,
    checkpoint bytes and seconds to save and load, and the ToF path.
    ``device="cpu"`` runs the same checks but the host's waits, which need
    the card (a dry run at a tiny size). ``keep_weights``: a directory
    that gets a copy of run A's ``weights/{name}`` (for the sweep phase)."""
    import shutil
    import tempfile

    from cfpnet_torch import kernels, weights
    from cfpnet_torch.data import native
    from cfpnet_torch.models.deltar import make_model
    from cfpnet_torch.train import checkpoint, steps

    cfg = loop_config(config)
    init = weights.deterministic_state_dict(cfg)
    here = os.getcwd()
    work = tempfile.mkdtemp(prefix="chip_smoke_loop_", dir=ROOT)
    os.chdir(work)
    try:
        cuda = torch.device(device).type == "cuda"
        control_waits = HostWaits() if cuda else None
        if cuda:
            with control_waits:
                float(torch.ones(2, device="cuda").sum())
            if control_waits.counts["d2h"] < 1 or control_waits.counts["syncs"] < 1:
                raise AssertionError(f"the counters did not see an .item(): "
                                     f"{control_waits.counts}")

        probe, trace_a = LoopProbe(cuda), []
        kernels.reset_launches()
        state_a, log_a, seconds_a = loop_run(cfg, init, trace_a, probe, device)
        total = launch_counts()
        losses_a = [float(t["loss"]) for t in trace_a]
        if len(trace_a) != LOOP_EPOCHS * LOOP_SAMPLES // cfg.bs or not all(
                math.isfinite(v) for v in losses_a):
            raise AssertionError(f"loop losses {losses_a}")
        bad = {t["step"]: probe.launches[t["step"]] for t in trace_a
               if probe.launches[t["step"]] != TRAIN_LAUNCHES}
        if bad:
            raise AssertionError(f"loop steps launched {bad}, expected {TRAIN_LAUNCHES}")
        vals = [line for line in log_a if line["kind"] == "val"]
        epochs = [line for line in log_a if line["kind"] == "epoch"]
        if [v["epoch"] for v in vals] != list(range(LOOP_EPOCHS)) or not all(
                len(set(v) & set(EVAL_METRICS)) == 9 and all(math.isfinite(v[k])
                                                             for k in EVAL_METRICS)
                for v in vals):
            raise AssertionError(f"val lines {vals}")
        eval_images = LOOP_EPOCHS * min(LOOP_SAMPLES, 64)
        want = {k: len(trace_a) * TRAIN_LAUNCHES[k] + eval_images * EVAL_LAUNCHES[k]
                for k in TRAIN_LAUNCHES}
        if total != want:
            raise AssertionError(f"the loop launched {total}, expected {want}")
        names = {f"{v['epoch']}_{v['rmse']:.3f}" for v in vals} | {"best"}
        for d in (f"checkpoints/{cfg.name}", f"weights/{cfg.name}"):
            if set(os.listdir(d)) != names:
                raise AssertionError(f"{d} holds {sorted(os.listdir(d))}, expected {names}")
        waits = probe.waits.counts if cuda else {}
        if cuda and (waits["d2h"] or waits["profiler_d2h"] or waits["syncs"]
                     or waits["h2d_pageable"]):
            raise AssertionError(f"loop step {LOOP_PROFILED_STEP} waited on the host: {waits}")

        # the last checkpoint loads back bit for bit
        last = f"checkpoints/{cfg.name}/{vals[-1]['epoch']}_{vals[-1]['rmse']:.3f}"
        fresh = steps.create_train_state(make_model(cfg, device=device), cfg, len(trace_a))
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        sync()
        t0 = time.perf_counter()
        _, next_epoch, best = checkpoint.load_checkpoint(last, fresh)
        sync()
        load_s = time.perf_counter() - t0
        differ = state_differs(fresh, state_a)
        if (differ or next_epoch != LOOP_EPOCHS
                or best != float(np.float32(min(v["rmse"] for v in vals[:-1])))):
            raise AssertionError(f"{last} loads back other values: {differ[:5]}, next epoch "
                                 f"{next_epoch}, best {best}")
        del fresh

        # the resume, bit for bit under deterministic algorithms, with a
        # planted fault that the comparison must see
        keys = ("epoch", "step", "zone_offset", "lr", "indices")
        with deterministic_algorithms() as caught:
            trace_d = []
            cfg_d = cfg.replace(name=cfg.name + "_d", save_dir=cfg.save_dir + "_d")
            state_d, log_d, seconds_d = loop_run(cfg_d, init, trace_d, device=device)
            val_d = next(line for line in log_d if line["kind"] == "val")
            ckpt0 = f"checkpoints/{cfg_d.name}/0_{val_d['rmse']:.3f}"
            trace_r = []
            state_r, log_r, seconds_r = loop_run(
                cfg.replace(name=cfg.name + "_r", save_dir=cfg.save_dir + "_r", resume=ckpt0),
                init, trace_r, device=device)
            control = os.path.join(work, "zeroed_moments")
            zeroed_moments(ckpt0, control)
            trace_c = []
            state_c, log_c, seconds_c = loop_run(
                cfg.replace(name=cfg.name + "_c", save_dir=cfg.save_dir + "_c", resume=control),
                init, trace_c, device=device)
        tail = [t for t in trace_d if t["epoch"] == LOOP_EPOCHS - 1]
        if ([{k: t[k] for k in keys} for t in trace_d] != [{k: t[k] for k in keys}
                                                            for t in trace_a]
                or [{k: t[k] for k in keys} for t in trace_r] != [{k: t[k] for k in keys}
                                                                   for t in tail]):
            raise AssertionError("the resumed epoch took other batches, offsets or rates")
        loss_differs = [t["step"] for t, u in zip(trace_r, tail)
                        if not torch.equal(t["loss"], u["loss"])]
        differs = state_differs(state_r, state_d)
        if loss_differs or differs:
            raise AssertionError(f"the resumed run is not the uninterrupted one bit for bit: "
                                 f"losses of steps {loss_differs}, state {differs[:5]} "
                                 f"({len(differs)} entries); warnings {caught[:3]}")
        control_differs = state_differs(state_c, state_d)
        if keep_weights:
            shutil.copytree(f"weights/{cfg.name}", os.path.join(keep_weights, "weights", cfg.name))
        if not control_differs:
            raise AssertionError("a resume with zeroed moments equals the uninterrupted run: "
                                 "the resume check cannot see a lost optimizer state")
        sizes = {d: {f: os.path.getsize(os.path.join(d, f)) for f in sorted(os.listdir(d))}
                 for d in (f"checkpoints/{cfg.name}", f"weights/{cfg.name}")}
        last_epoch = epochs[-1]
        ms = last_epoch["train_s"] * 1e3 / last_epoch["steps"]
        more = {name: [line for line in log if line["kind"] == "epoch"]
                for name, log in (("d", log_d), ("resumed", log_r), ("control", log_c))}
        return dict(
            phase="loop", batch=cfg.bs, size=[cfg.input_height, cfg.input_width],
            samples=LOOP_SAMPLES, epochs=LOOP_EPOCHS,
            eval_images_a_validation=min(LOOP_SAMPLES, 64),
            tof_path=native.active(), loop_ms_a_step=ms, loop_images_a_s=cfg.bs * 1e3 / ms,
            bare_step_images_a_s=bare_images_a_s,
            loader_wait_ms_a_step=sum(last_epoch["loader_wait_ms"]) / last_epoch["steps"],
            loader_wait_ms_each_step=[e["loader_wait_ms"] for e in epochs],
            producer_ms_each_batch=[e["producer_ms"] for e in epochs],
            epochs_logged=dict(a=epochs, **more), validation_s=[e["val_s"] for e in epochs],
            checkpoint_save_s=[e["checkpoint_s"] for e in epochs], checkpoint_load_s=load_s,
            checkpoint_bytes=sizes,
            run_s=dict(a=seconds_a, d=seconds_d, resumed=seconds_r, control=seconds_c),
            losses=losses_a, launches_run=total,
            launches_a_step={t["step"]: probe.launches[t["step"]] for t in trace_a},
            profiled_step_waits=waits, control_item_waits=control_waits and control_waits.counts,
            profiled_step=busy(probe.waits.events, ms) if cuda else None,
            resume=dict(checkpoint=os.path.basename(ckpt0), equal_batches_offsets_rates=True,
                        loaded_state_bit_equal=True, resumed_bit_equal_deterministic=True,
                        deterministic_warnings=sorted({str(w.message)[:200] for w in caught}),
                        control_zeroed_moments=dict(
                            entries_differing=len(control_differs),
                            params_max_abs=params_diff(state_c, state_d)),
                        default_algorithms_vs_deterministic_params_max_abs=params_diff(
                            state_a, state_d)))
    finally:
        os.chdir(here)
        shutil.rmtree(work, ignore_errors=True)


def loop_bf16_phase(config):
    """Phase 10, bf16: ``run_training`` with ``--compute_dtype bfloat16`` at
    the loop phase's configuration, one epoch of 3 steps on the synthetic
    set, in a temporary working directory: finite losses; each step's
    kernels all on bf16 tensors, the validation's all on float32 (the
    float32 masters, as the JAX loop's eval steps cast nothing); finite
    validation metrics; float32 weights in the weights file and float32
    weights and moments in the checkpoint."""
    import shutil
    import tempfile

    from cfpnet_torch import kernels, weights

    cfg = loop_config(config).replace(epochs=1, compute_dtype="bfloat16",
                                      name="chip_smoke_loop_bf16",
                                      save_dir="results/chip_smoke_loop_bf16")
    init = weights.deterministic_state_dict(cfg)
    here = os.getcwd()
    work = tempfile.mkdtemp(prefix="chip_smoke_loop_", dir=ROOT)
    os.chdir(work)
    try:
        trace = []
        kernels.reset_launches()
        state, log, seconds = loop_run(cfg, init, trace)
        by_dtype = launches_by_dtype()
        losses = [float(t["loss"]) for t in trace]
        if len(losses) != LOOP_SAMPLES // cfg.bs or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"bf16 loop losses {losses}")
        eval_images = min(LOOP_SAMPLES, 64)
        want = {k: {"bfloat16": len(trace) * TRAIN_LAUNCHES[k],
                    "float32": eval_images * EVAL_LAUNCHES[k]} for k in TRAIN_LAUNCHES}
        if by_dtype != want:
            raise AssertionError(f"the bf16 loop launched {by_dtype}, expected {want}")
        (val,) = [line for line in log if line["kind"] == "val"]
        (epoch,) = [line for line in log if line["kind"] == "epoch"]
        if not all(math.isfinite(val[k]) for k in EVAL_METRICS):
            raise AssertionError(f"bf16 loop validation {val}")
        name = f"0_{val['rmse']:.3f}"
        held = set()
        for kind in ("weights", "checkpoints"):
            files = sorted(os.listdir(f"{kind}/{cfg.name}"))
            if files != sorted([name, "best"]):
                raise AssertionError(f"{kind}/{cfg.name} holds {files}")
        for f in (name, "best"):
            held |= {v.dtype for v in torch.load(f"weights/{cfg.name}/{f}", map_location="cpu",
                                                 weights_only=True).values()}
            ckpt = torch.load(f"checkpoints/{cfg.name}/{f}", map_location="cpu",
                              weights_only=True)
            held |= {v.dtype for v in ckpt["model"].values()}
            held |= {v.dtype for g in ckpt["opt_state"].values() for key in ("mu", "nu")
                     for v in g[key].values()}
        if held != {torch.float32}:
            raise AssertionError(f"the bf16 loop's files hold {held}")
        ms = epoch["train_s"] * 1e3 / epoch["steps"]
        return dict(phase="loop_bf16", batch=cfg.bs, samples=LOOP_SAMPLES, epochs=1,
                    losses=losses, launches_by_dtype=by_dtype, val=val,
                    files_dtypes=sorted(str(d) for d in held), loop_ms_a_step=ms,
                    loop_images_a_s=cfg.bs * 1e3 / ms,
                    loader_wait_ms_each_step=epoch["loader_wait_ms"],
                    validation_s=epoch["val_s"], run_s=seconds)
    finally:
        os.chdir(here)
        shutil.rmtree(work, ignore_errors=True)


# phase 14: the train options of the one-card driver
PIPELINE_REPS = 20  # device_preprocess calls timed between CUDA events, after 3 warm ones
OPTION_STEPS_TIMED = 2  # bs-16 steps timed for each train option, after one warm step


def producer_ms(cfg, device_pipeline: bool):
    """The loader's seconds to make each bs-16 batch of the loop phase's
    synthetic train set (decode, ToF simulation where the host does it,
    collate, pin), with or without ``--device_pipeline``, as ms; and the
    first batch, on the card."""
    from cfpnet_torch.data.datasets import SyntheticDataset
    from cfpnet_torch.data.pipeline import DataLoader

    c = cfg.replace(device_pipeline=device_pipeline)
    loader = DataLoader(SyntheticDataset(c, "train", LOOP_SAMPLES), c.bs, shuffle=True,
                        drop_last=True, seed=c.seed, device="cuda")
    batches = [b for b in loader]
    torch.cuda.synchronize()
    return [1e3 * s for s in loader.produce_s], batches[0]


def device_preprocess_check(tconfig):
    """``data/tof_sim_device.py`` on one raw bs-16 batch at 416x544 on the
    production train geometry: its device ms (CUDA events), its device
    kernels (torch.profiler), no copy to the host and no sync; the
    producer's ms a batch with and without ``--device_pipeline``; on the
    batch's depth maps, ``get_hist`` on the card against the host's
    ``tof_sim.get_hist`` (mask equal, (mu, sigma) within 1e-5 relative),
    and the whole transform on the card against itself on the CPU with the
    same draws (depth and mask equal, points and image within 1e-5 of their
    largest value: the card sums the moments in another order)."""
    from cfpnet_torch.data import tof_sim
    from cfpnet_torch.data.geometry import geometry_for
    from cfpnet_torch.data.tof_sim_device import (device_preprocess, draw_augmentations,
                                                  get_hist, preprocess_batch)
    from cfpnet_torch.train.loop import prep_generator

    cfg = loop_config(tconfig)
    host_ms, _ = producer_ms(cfg, False)
    raw_ms, raw = producer_ms(cfg, True)
    if set(raw) != {"image_raw", "depth"}:
        raise AssertionError(f"a --device_pipeline batch holds {sorted(raw)}")
    geom = geometry_for(cfg, "train")
    steps = iter(range(10 ** 6))

    def prep():
        return preprocess_batch(raw, cfg, geom, prep_generator(cfg.seed, next(steps), "cuda"))

    for _ in range(3):
        out = prep()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(PIPELINE_REPS):
        out = prep()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / PIPELINE_REPS
    events = device_events(prep)
    with HostWaits() as waits:
        prep()
    if waits.counts["d2h"] or waits.counts["syncs"] or waits.counts["h2d_pageable"]:
        raise AssertionError(f"device_preprocess waited on the host: {waits.counts}")
    B, H, W = raw["depth"].shape[:3]
    Z = geom.zone_num ** 2
    want = dict(image=(B, H, W, 3), depth=(B, H, W, 1), hist_data=(B, Z, cfg.zone_sample_num),
                mask=(B, Z))
    if any(tuple(out[k].shape) != s for k, s in want.items()) or not all(
            torch.isfinite(out[k]).all() for k in ("image", "hist_data")):
        raise AssertionError(f"device_preprocess gave "
                             f"{ {k: tuple(v.shape) for k, v in out.items()} }")

    # get_hist on the card against the host's on the same depth maps
    depth = raw["depth"][..., 0]
    fh, mask = get_hist(depth, geom, cfg.simu_max_distance)
    host = [tof_sim.get_hist(d, geom, cfg.simu_max_distance) for d in depth.cpu().numpy()]
    hfh = np.stack([h[0] for h in host])
    hmask = np.stack([h[2] for h in host])
    fh, mask = fh.cpu().numpy(), mask.cpu().numpy()
    # np.allclose's rule at rtol 1e-5, atol 1e-6, as tests/test_torch_port_device_pipeline.py
    over = float(np.max(np.abs(fh - hfh) - 1e-5 * np.abs(hfh)))
    if not np.array_equal(mask, hmask) or over > 1e-6:
        raise AssertionError(f"get_hist on the card against the host: masks equal "
                             f"{np.array_equal(mask, hmask)}, max |diff| - 1e-5 |host| {over}")

    # the transform on the card against itself on the CPU, same inputs and draws
    draws = draw_augmentations(prep_generator(cfg.seed, 0, "cuda"), B, Z, cfg)
    kw = dict(max_distance=cfg.simu_max_distance, zone_sample_num=cfg.zone_sample_num,
              drop_hist=cfg.drop_hist, noise_prob=cfg.noise_prob, noise_mean=cfg.noise_mean,
              noise_sigma=cfg.noise_sigma, sample_uniform=cfg.sample_uniform)
    card = device_preprocess(raw["image_raw"], depth, draws, geom, **kw)
    cpu = device_preprocess(raw["image_raw"].cpu(), depth.cpu(),
                            {k: v.cpu() for k, v in draws.items()}, geom, **kw)
    rel = {k: float((card[k].cpu() - cpu[k]).abs().max() / cpu[k].abs().max())
           for k in ("image", "hist_data")}
    same = {k: bool(torch.equal(card[k].cpu(), cpu[k])) for k in ("depth", "mask")}
    if not all(same.values()) or max(rel.values()) > 1e-5:
        raise AssertionError(f"device_preprocess on the card against the CPU: equal {same}, "
                             f"max rel {rel}")
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    return dict(batch=B, size=[H, W], zones=Z, image_raw_dtype=str(raw["image_raw"].dtype),
                ms=ms, reps=PIPELINE_REPS, device_kernels=sum(e.count for e in device),
                profiled_device_ms=sum(e.self_device_time_total for e in device) / 1e3,
                host_waits=waits.counts, producer_ms_host_pipeline=host_ms,
                producer_ms_device_pipeline=raw_ms,
                get_hist_vs_host=dict(masks_equal=True, max_abs=float(np.max(np.abs(fh - hfh))),
                                      valid_zones=int(mask.sum()), zones=int(mask.size)),
                card_vs_cpu=dict(equal=same, max_rel=rel))


def loop_device_pipeline_check(tconfig, loop):
    """``run_training`` with ``--compute_dtype bfloat16 --device_pipeline``
    at the loop phase's configuration: run A (one epoch, no profiler; the
    launch counters set to 0 before it and read after: each step 6 / 12 /
    18 on bf16 tensors, the validation's on float32), then under
    ``deterministic_algorithms`` run D (two epochs) and run R resumed from
    D's epoch-0 checkpoint, equal to D bit for bit in its losses and final
    state. Loop ms a step, the producer's ms and the loader's waits beside
    phase 10's (its run A's, epochs 0 and 1; each epoch's first step waits
    for the loader in both). The transform's own host waits are
    ``device_preprocess_check``'s, phase 10's a loop step's."""
    import shutil
    import tempfile

    from cfpnet_torch import kernels, weights

    cfg = loop_config(tconfig).replace(compute_dtype="bfloat16", device_pipeline=True,
                                       name="chip_smoke_dp", save_dir="results/chip_smoke_dp")
    init = weights.deterministic_state_dict(cfg)
    here = os.getcwd()
    work = tempfile.mkdtemp(prefix="chip_smoke_dp_", dir=ROOT)
    os.chdir(work)
    try:
        probe, trace_a = LoopProbe(cuda=False), []
        kernels.reset_launches()
        state_a, log_a, seconds_a = loop_run(cfg.replace(epochs=1), init, trace_a, probe)
        total, by_dtype = launch_counts(), launches_by_dtype()
        losses = [float(t["loss"]) for t in trace_a]
        if len(losses) != LOOP_SAMPLES // cfg.bs or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"device-pipeline loop losses {losses}")
        bad = {t["step"]: probe.launches[t["step"]] for t in trace_a
               if probe.launches[t["step"]] != TRAIN_LAUNCHES}
        eval_images = min(LOOP_SAMPLES, 64)
        want = {k: {"bfloat16": len(trace_a) * TRAIN_LAUNCHES[k],
                    "float32": eval_images * EVAL_LAUNCHES[k]} for k in TRAIN_LAUNCHES}
        if bad or by_dtype != want:
            raise AssertionError(f"device-pipeline loop launched {by_dtype} (steps off: {bad}), "
                                 f"expected {want}")
        del state_a
        with deterministic_algorithms() as caught:
            trace_d, trace_r = [], []
            cfg_d = cfg.replace(name=cfg.name + "_d", save_dir=cfg.save_dir + "_d")
            state_d, log_d, seconds_d = loop_run(cfg_d, init, trace_d)
            val_d = next(line for line in log_d if line["kind"] == "val")
            ckpt0 = f"checkpoints/{cfg_d.name}/0_{val_d['rmse']:.3f}"
            state_r, log_r, seconds_r = loop_run(
                cfg.replace(name=cfg.name + "_r", save_dir=cfg.save_dir + "_r", resume=ckpt0),
                init, trace_r)
        tail = [t for t in trace_d if t["epoch"] == LOOP_EPOCHS - 1]
        loss_differs = [t["step"] for t, u in zip(trace_r, tail)
                        if t["indices"] != u["indices"] or not torch.equal(t["loss"], u["loss"])]
        differs = state_differs(state_r, state_d)
        if len(trace_r) != len(tail) or loss_differs or differs:
            raise AssertionError(f"the resumed device-pipeline run is not the uninterrupted one "
                                 f"bit for bit: steps {loss_differs}, state {differs[:5]} "
                                 f"({len(differs)} entries); warnings {caught[:3]}")
        (epoch,) = [line for line in log_a if line["kind"] == "epoch"]
        ms = epoch["train_s"] * 1e3 / epoch["steps"]
        return dict(batch=cfg.bs, samples=LOOP_SAMPLES, dtype=cfg.compute_dtype, losses=losses,
                    launches_run=total, launches_by_dtype=by_dtype,
                    launches_a_step={t["step"]: probe.launches[t["step"]] for t in trace_a},
                    loop_ms_a_step=ms, loop_ms_a_step_phase10_f32=loop["loop_ms_a_step"],
                    loader_wait_ms_each_step=epoch["loader_wait_ms"],
                    loader_wait_ms_each_step_phase10=loop["loader_wait_ms_each_step"],
                    producer_ms_each_batch=epoch["producer_ms"],
                    producer_ms_each_batch_phase10=loop["producer_ms_each_batch"],
                    run_s=dict(a=seconds_a, d=seconds_d, resumed=seconds_r),
                    resume=dict(checkpoint=os.path.basename(ckpt0), steps=len(trace_r),
                                resumed_bit_equal_deterministic=True,
                                deterministic_warnings=sorted({str(w.message)[:200]
                                                               for w in caught})))
    finally:
        os.chdir(here)
        shutil.rmtree(work, ignore_errors=True)


def step_options_check(tconfig):
    """The bs-16 step (416x544, deterministic weights, one synthetic batch)
    plain, with ``--grad_accum 2`` and ``4`` and with ``--remat``, in f32
    and bf16: ms a step (``OPTION_STEPS_TIMED`` steps between CUDA events
    after one warm step; a loss that is not finite raises), the peak of
    allocated memory, the launches of the warm step. Then, under
    ``deterministic_algorithms``, one remat step against one plain step
    from the same weights in each dtype: loss, every gradient and every
    running statistic bit for bit."""
    from cfpnet_torch import kernels, weights
    from cfpnet_torch.evaluate_time import make_train_batch, train_latency_ms
    from cfpnet_torch.models.deltar import make_model, model_geometries
    from cfpnet_torch.train import steps

    init = weights.deterministic_state_dict(tconfig)
    model = make_model(tconfig, device="cuda")
    geoms = model_geometries(tconfig, "train")
    batch = make_train_batch(tconfig, tconfig.bs)
    seeds = iter(range(tconfig.seed, tconfig.seed + 10 ** 6))
    out = {}
    for dtype in ("float32", "bfloat16"):
        for name, option in (("plain", {}), ("grad_accum_2", dict(grad_accum=2)),
                             ("grad_accum_4", dict(grad_accum=4)), ("remat", dict(remat=True))):
            cfg = tconfig.replace(compute_dtype=dtype, **option)
            model.load_state_dict(init, strict=True)
            model.remat = cfg.remat
            state = steps.create_train_state(model, cfg, GOLDEN_TRAIN_TOTAL_STEPS)
            step = steps.make_train_step(model, cfg, geoms)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            kernels.reset_launches()
            first = float(step(state, batch, next(seeds)))
            launches = launch_counts()
            ms = train_latency_ms(lambda: step(state, batch, next(seeds)), OPTION_STEPS_TIMED,
                                  OPTION_STEPS_TIMED)
            accum = cfg.grad_accum
            if not math.isfinite(first) or launches != {k: accum * v
                                                        for k, v in TRAIN_LAUNCHES.items()}:
                raise AssertionError(f"{dtype} {name}: first loss {first}, launches {launches}")
            out[f"{name}_{dtype}"] = dict(
                ms_a_step=ms, first_loss=first, launches_a_step=launches,
                max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                allocated_before_gib=base / 2 ** 30)
            del state, step
    model.remat = False

    def one_step(cfg, remat):
        model.load_state_dict(init, strict=True)
        model.remat = remat
        state = steps.create_train_state(model, cfg, GOLDEN_TRAIN_TOTAL_STEPS)
        loss = steps.make_train_step(model, cfg, geoms)(state, batch, tconfig.seed)
        grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
        stats = {k: v.detach().clone() for k, v in model.named_buffers()}
        return loss, grads, stats

    equal = {}
    with deterministic_algorithms() as caught:
        for dtype in ("float32", "bfloat16"):
            cfg = tconfig.replace(compute_dtype=dtype)
            plain, remat = one_step(cfg, False), one_step(cfg.replace(remat=True), True)
            differ = [k for k in plain[1] if not torch.equal(plain[1][k], remat[1][k])]
            differ += [k for k in plain[2] if not torch.equal(plain[2][k], remat[2][k])]
            if not torch.equal(plain[0], remat[0]) or differ:
                raise AssertionError(f"{dtype}: the remat step is not the plain one bit for bit: "
                                     f"loss {float(plain[0])} / {float(remat[0])}, "
                                     f"{differ[:5]} ({len(differ)} entries)")
            equal[dtype] = dict(loss=float(plain[0]), gradients=len(plain[1]),
                                statistics=len(plain[2]), bit_equal=True)
    model.remat = False
    del model
    return dict(steps=out, remat_equals_plain=equal,
                deterministic_warnings=sorted({str(w.message)[:200] for w in caught}))


def debug_nans_check(tconfig):
    """``--debug_nans`` on the card: a bs-2 step on a batch with a planted
    NaN, in anomaly mode, through ``train/loop.py::debug_nans_step``,
    raises ``FloatingPointError`` naming the step; the same batch without
    the NaN passes."""
    from cfpnet_torch import weights
    from cfpnet_torch.evaluate_time import make_train_batch
    from cfpnet_torch.models.deltar import make_model, model_geometries
    from cfpnet_torch.train import steps
    from cfpnet_torch.train.loop import debug_nans_step

    cfg = tconfig.replace(bs=2, debug_nans=True)
    model = make_model(cfg, device="cuda")
    model.load_state_dict(weights.deterministic_state_dict(cfg), strict=True)
    state = steps.create_train_state(model, cfg, GOLDEN_TRAIN_TOTAL_STEPS)
    step = debug_nans_step(steps.make_train_step(model, cfg, model_geometries(cfg, "train")))
    batch = make_train_batch(cfg, 2)
    with torch.autograd.set_detect_anomaly(True):
        clean = float(step(state, batch, cfg.seed))
        batch["image"][0, 0, 0, 0] = float("nan")
        try:
            step(state, batch, cfg.seed + 1)
        except FloatingPointError as e:
            message = str(e)
        else:
            raise AssertionError("--debug_nans let a planted NaN through")
    if "step 1" not in message:
        raise AssertionError(f"--debug_nans named another step: {message[:200]}")
    return dict(clean_loss=clean, raised="FloatingPointError", message=message[:160])


def train_options_phase(tconfig, loop):
    """Phase 14: ``--device_pipeline``, ``--grad_accum``, ``--remat`` and
    ``--debug_nans`` on the card (``device_preprocess_check``,
    ``loop_device_pipeline_check``, ``step_options_check``,
    ``debug_nans_check``)."""
    t0 = time.perf_counter()
    out = dict(phase="train_options", device_preprocess=device_preprocess_check(tconfig))
    out["loop_device_pipeline"] = loop_device_pipeline_check(tconfig, loop)
    out["step_options"] = step_options_check(tconfig)
    out["debug_nans"] = debug_nans_check(tconfig)
    out["seconds"] = time.perf_counter() - t0
    return out


def check_kernels_bf16(config, geoms, batch: int, mode: str = "online_eval"):
    """The bf16 phase's kernels: each bf16 variant at every main-path shape
    of the forward in ``mode`` at ``batch`` (the eval forward, or the bf16
    train step's forward at "train") against its plain version in bf16 on the
    same bf16 inputs (both round at the Pallas kernel's points; their f32
    sums run in another order, so a value may land one bf16 ulp apart:
    max |kernel - plain| <= ``BF16_TOL`` * max |plain|), with the share of
    elements that differ at all, and the kernel's ms a call against its
    bound: the bytes at 2 a value over the memory rate, the operations over
    the f32 rate (attention, dwconv: f32 arithmetic on the CUDA cores) or
    the dense bf16 tensor-core rate (the fused layer: its products are
    bf16 x bf16 with f32 sums, whatever instruction the kernel issues);
    for dwconv also one cuDNN call on the same bf16 inputs (``F.conv2d``
    with groups=C: f32 sums, the output rounded once), timed only. At the
    train shapes the cuDNN call and the fused layer's split by pass are
    left out (``library_ms`` None): phase 4 times cuDNN there."""
    from cfpnet_torch.kernels import dwconv, fused_loftr, linear_attention
    from cfpnet_torch.models.transformer import LoFTREncoderLayer
    from cfpnet_torch.ops.attention import linear_attention as att_plain
    from cfpnet_torch.ops.dwconv import depthwise_conv2d as dw_plain
    from cfpnet_torch.ops.loftr import loftr_apply

    att_shapes, dw_shapes, loftr_shapes = main_path_shapes(config, geoms, batch, mode)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 200 + batch)
    bf16 = torch.bfloat16
    full = mode != "train"

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device="cuda", generator=gen)).to(bf16)

    def held(name, shape, got, ref):
        torch.cuda.synchronize()
        if got.dtype != bf16 or ref.dtype != bf16:
            raise AssertionError(f"{name} {shape}: got {got.dtype}, plain {ref.dtype}")
        g, r = got.float(), ref.float()
        err, top = float((g - r).abs().max()), float(r.abs().max())
        if not (err <= BF16_TOL * top):
            raise AssertionError(f"bf16 {name} {shape} at bs={batch}: max err {err} > "
                                 f"{BF16_TOL} * {top}")
        return dict(max_abs_err=err, max_abs_plain=top, differ_share=float((g != r).float().mean()))

    lines = []
    for (N, L, S, H, D), calls in sorted(att_shapes.items()):
        q, k, v = randn(N, L, H, D), randn(N, S, H, D), randn(N, S, H, D)
        line = held("linear_attention", (N, L, S, H, D),
                    linear_attention.linear_attention(q, k, v), att_plain(q, k, v))
        C = H * D
        line.update(ms=device_ms(lambda: linear_attention.linear_attention(q, k, v)),
                    **bound_fields(2 * (2 * N * L * C + 2 * N * S * C),
                                   N * H * (2 * S * D * D + S * D + 2 * L * D * D + 2 * L * D)),
                    library_ms=None)
        lines.append(dict(kernel="linear_attention", shape=dict(N=N, L=L, S=S, H=H, D=D),
                          calls=calls, **line))
    for (B, H, W, C, kk), calls in sorted(dw_shapes.items()):
        x, w, b = randn(B, H, W, C), randn(C, 1, kk, kk, scale=0.05), randn(C)
        line = held("dwconv", (B, H, W, C, kk), dwconv.depthwise_conv2d(x, w, b), dw_plain(x, w, b))
        x_nchw = x.permute(0, 3, 1, 2)  # the same memory, as cuDNN's channels-last input
        line.update(ms=device_ms(lambda: dwconv.depthwise_conv2d(x, w, b)),
                    **bound_fields(2 * (2 * B * H * W * C + C * kk * kk + C),
                                   2 * kk * kk * B * H * W * C),
                    library_ms=device_ms(lambda: F.conv2d(x_nchw, w, b, padding=kk // 2,
                                                          groups=C)) if full else None)
        lines.append(dict(kernel="dwconv", shape=dict(B=B, H=H, W=W, C=C, k=kk), calls=calls,
                          **line))
    rng = np.random.default_rng(SEED + 200 + batch)
    for (N, L, S, C, H), calls in sorted(loftr_shapes.items()):
        def normal(*shape, mean=0.0, std=1.0):
            a = (mean + std * rng.standard_normal(shape)).astype(np.float32)
            return torch.from_numpy(a).cuda()

        x, src = normal(N, L, C).to(bf16), normal(N, S, C).to(bf16)
        layer = LoFTREncoderLayer(C, H).cuda()
        for name, w in layer.named_parameters():
            w.data.copy_(normal(*w.shape, mean=1.0 if name.endswith(("norm1.weight",
                                                                     "norm2.weight")) else 0.0,
                                std=0.1))
        p = layer.to(bf16).loftr_params()
        D = C // H
        with torch.no_grad():
            line = held("fused_loftr", (N, L, S, C, H), fused_loftr.fused_loftr(x, src, p, H),
                        loftr_apply(x, src, p, H))
            plan = fused_loftr.launch_plan(N, L, S, C, H, bf16)
            line.update(ms=device_ms(lambda: fused_loftr.fused_loftr(x, src, p, H)),
                        **(pass_split(lambda: fused_loftr.fused_loftr(x, src, p, H))
                           if full else {}),
                        plan={key: plan[key] for key in (
                            "tm", "cl", "units", "rounds", "blocks_per_sm", "smem", "sum_split",
                            "sum_groups", "sum_blocks", "sum_smem")},
                        **bound_fields(2 * (2 * N * L * C + N * S * C + 10 * C * C + 4 * C),
                                       2 * (N * L * 8 * C * C + N * S * 2 * C * C
                                            + N * H * (S + L) * D * D), PEAK_BF16),
                        library_ms=None)
        lines.append(dict(kernel="fused_loftr", shape=dict(N=N, L=L, S=S, C=C, H=H),
                          calls=calls, **line))
    for r in lines:
        emit(dict(phase="kernel_shape_bf16", batch=batch, mode=mode, **r))
    return lines


def bf16_row_fields(name, lines, lines_bs8):
    """A kernel row's bf16 columns: per bs=1 forward (calls x per-call value)
    the card's ms, the bound and the library call's ms (None where there is
    none), and the worst error and differing share over the bs=1 and bs=8
    shapes; at bs=8 the ms and the bound."""
    def per_forward(ls, key):
        return sum(r["calls"] * r[key] for r in ls if r["kernel"] == name)

    mine = [r for r in lines + lines_bs8 if r["kernel"] == name]
    library = [r["library_ms"] for r in lines if r["kernel"] == name]
    extra = {}
    if name == "fused_loftr":  # its own bf16 source, and the two passes per forward
        extra = dict(source_bf16="cfpnet_torch/csrc/fused_loftr_bf16.cu",
                     **{f"{key}_bf16": per_forward(lines, key)
                        for key in ("summary_ms", "rows_ms")},
                     **{f"{key}_bs8_bf16": per_forward(lines_bs8, key)
                        for key in ("summary_ms", "rows_ms")})
    return dict(card_ms_bf16=per_forward(lines, "ms"), bound_ms_bf16=per_forward(lines, "bound_ms"),
                library_ms_bf16=(per_forward(lines, "library_ms")
                                 if None not in library else None),
                bound_by_bf16=("bytes" if per_forward(lines, "bytes_ms")
                               >= per_forward(lines, "ops_ms") else "operations"),
                max_rel_err_bf16=max(r["max_abs_err"] / r["max_abs_plain"] for r in mine),
                differ_share_bf16=max(r["differ_share"] for r in mine),
                card_ms_bs8_bf16=per_forward(lines_bs8, "ms"),
                bound_ms_bs8_bf16=per_forward(lines_bs8, "bound_ms"), **extra)


def bf16_drift(pred, golden: str = GOLDEN_FULL):
    """Median relative and absolute distance of a bs=1 prediction from the
    f32 ``golden`` (default ``tests/golden/full_forward.npz``; its
    every-16th-pixel slice), as ``tests/test_bf16.py`` measures bf16 against
    f32: |pred - golden| / (|golden| + 1e-2). Raises beyond ``BF16_DRIFT``."""
    ref = np.load(golden)["pred_slice"]
    got = pred.float().cpu().numpy()[0, ::16, ::16, 0]
    err = np.abs(got - ref)
    out = dict(median_rel=float(np.median(err / (np.abs(ref) + 1e-2))),
               median_abs=float(np.median(err)), max_abs=float(err.max()),
               finite=bool(np.isfinite(got).all()))
    if not (out["finite"] and all(out[k] < v for k, v in BF16_DRIFT.items())):
        raise AssertionError(f"bf16 forward against the f32 golden: {out}, budget {BF16_DRIFT}")
    return out


def launches_by_dtype():
    from cfpnet_torch import kernels

    return {k.__name__.rsplit(".", 1)[-1]: dict(k.launches_by_dtype) for k in kernels.KERNELS}


def bf16_phase(config, geoms, args, f32_replay_ms):
    """Phase 11: ``--compute_dtype bfloat16`` through the eval forward.

    - The bf16 kernels against their bf16 plain versions at every bs=1 and
      bs=8 main-path shape (``check_kernels_bf16``).
    - The production model cast to bf16 (``cast_to_compute_dtype``) on the
      golden's inputs cast to bf16: one eager forward with the launch
      counters set to 0 just before it launches 6 attention, 6 dwconv and
      18 fused-LoFTR kernels, every one on bf16 tensors (counted by dtype);
      its prediction within ``BF16_DRIFT`` of the f32 golden.
    - The bf16 forward captured in a CUDA graph at bs=1 (the golden inputs)
      and bs=8 (8 synthetic samples): each replay equals the eager bf16
      forward bit for bit.
    - ``cfpnet_torch.evaluate_time --compute_dtype bfloat16``, graphed and
      eager.
    - One replay of the f32 and of the bf16 graph at bs=1 profiled, device
      ms by kind (``by_kind``) and busy share against the replay's ms."""
    from cfpnet_torch import evaluate_time, kernels, weights
    from cfpnet_torch.data.datasets import SyntheticDataset, collate
    from cfpnet_torch.graphs import CapturedForward
    from cfpnet_torch.models.deltar import cast_to_compute_dtype, make_model

    bf16 = torch.bfloat16
    lines = check_kernels_bf16(config, geoms, 1)
    lines_bs8 = check_kernels_bf16(config, geoms, 8)

    sd = weights.deterministic_state_dict(config)
    model = make_model(config, device="cuda")
    model.load_state_dict(sd, strict=True)
    cast_to_compute_dtype(model, bf16)
    img, hist, mask = args
    args16 = (img.to(bf16), hist.to(bf16), mask)
    kernels.reset_launches()
    (bin_edges, pred, prob, _), launches = eager_launches(model, args16, geoms)
    by_dtype = launches_by_dtype()
    check_launches(launches, 1)
    if any(set(d) != {"bfloat16"} for d in by_dtype.values()):
        raise AssertionError(f"the bf16 forward launched kernels on other dtypes: {by_dtype}")
    drift = bf16_drift(pred)

    captured = CapturedForward(model, geoms, 1, config)
    got = [t.clone() for t in captured(*args16)[:3]]
    same_outputs(got, (bin_edges, pred, prob), "bf16 bs=1 replay")
    replay16 = device_events(captured.replay)
    del captured
    dataset = SyntheticDataset(config, "online_eval", 8)
    batch = collate([dataset[i] for i in range(8)])
    args8 = (torch.from_numpy(batch["image"]).cuda().to(bf16),
             torch.from_numpy(batch["hist_data"]).cuda().to(bf16),
             torch.from_numpy(batch["mask"]).cuda())
    eager8, launches8 = eager_launches(model, args8, geoms)
    check_launches(launches8, 8)
    captured = CapturedForward(model, geoms, 8, config)
    same_outputs(captured(*args8), eager8, "bf16 bs=8 replay")
    del captured, model

    model32 = make_model(config, device="cuda")
    model32.load_state_dict(sd, strict=True)
    captured = CapturedForward(model32, geoms, 1, config)
    captured(*args)
    replay32 = device_events(captured.replay)
    del captured, model32

    entry = {}
    for mode in ("graphed", "eager"):
        out = evaluate_time.main([f"@{PROD_CONFIG}", "--compute_dtype", "bfloat16",
                                  "--test_dataset", "synthetic", "--niters", str(BF16_ITERS)]
                                 + (["--eager"] if mode == "eager" else []))
        if out["dtype"] != "bfloat16" or not (out["latency_ms_bs1"] > 0):
            raise AssertionError(f"evaluate_time --compute_dtype bfloat16 ({mode}): {out}")
        entry[mode] = out["latency_ms_bs1"]
    return dict(phase="bf16", kernels_bs1=len(lines), kernels_bs8=len(lines_bs8),
                launches=launches, launches_by_dtype=by_dtype, launches_bs8=launches8,
                drift_vs_f32_golden=drift, budget=BF16_DRIFT, bs1_replay_equals_eager=True,
                bs8_replay_equals_eager=True,
                evaluate_time_ms_bs1=entry, evaluate_time_niters=BF16_ITERS,
                replay_bf16=busy(replay16, entry["graphed"]),
                replay_f32=busy(replay32, f32_replay_ms),
                replay_by_kind=dict(bfloat16=by_kind(replay16), float32=by_kind(replay32))
                ), lines, lines_bs8


def sweep_phase(work: str):
    """Phase 12: ``python -m cfpnet_torch.evaluate_all`` in ``work``, which
    holds ``weights/chip_smoke_loop`` from the loop phase (two epochs and
    ``best``), on 8 synthetic images: two CSV rows of finite metrics, the
    launches of 2 x 8 eval forwards, and the .xlsx beside the CSV; the two
    rows come from two files whose weights differ, and their unrounded
    metrics differ too."""
    import csv
    import shutil

    from cfpnet_torch import evaluate_all, kernels, weights

    here = os.getcwd()
    os.chdir(work)
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = evaluate_all.main([f"@{PROD_CONFIG}", "--test_dataset", "synthetic",
                                 "--synthetic_length", "8", "--epochs", str(LOOP_EPOCHS),
                                 "--name", "chip_smoke_loop", "--save_dir", "results"])
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        with open(out["reports"][0]) as f:
            table = list(csv.reader(f))
        if (table[0] != ["epoch"] + list(EVAL_METRICS) or len(table) != 1 + LOOP_EPOCHS
                or not all(math.isfinite(float(v)) for row in table[1:] for v in row)
                or not os.path.getsize(out["reports"][1])):
            raise AssertionError(f"evaluate_all wrote {table}")
        want = {k: LOOP_EPOCHS * 8 * v for k, v in EVAL_LAUNCHES.items()}
        if launches != want:
            raise AssertionError(f"the sweep launched {launches}, expected {want}")
        first, second = (weights.load_reference_checkpoint(f) for f in out["weights"])
        changed = sum(not torch.equal(first[k], second[k]) for k in first)
        if len(set(out["weights"])) != LOOP_EPOCHS or not changed:
            raise AssertionError(f"the sweep read {out['weights']}, {changed} tensors apart")
        if out["metrics"][0] == out["metrics"][1]:
            raise AssertionError(f"both epochs' unrounded metrics are {out['metrics'][0]}")
        return dict(phase="sweep", rows=table[1:], metrics=out["metrics"],
                    weights=out["weights"], tensors_changed=changed, seconds=seconds,
                    launches=launches)
    finally:
        os.chdir(here)
        shutil.rmtree(work, ignore_errors=True)


# phase 15: serving
SERVING_ARTIFACTS = (("bfloat16", (1, 8)), ("float32", (1,)))
SERVING_OPS = {"cfpnet::linear_attention": 6, "cfpnet::dwconv2d": 6, "cfpnet::fused_loftr": 18}
# device kernels of one replay of the bs=1 serving graph, by name
SERVING_DEVICE_KERNELS = {"attention_sum_kernel": 6, "attention_apply_kernel": 6,
                          "dwconv_kernel": 6, "summary_kernel": 18, "rows_kernel": 18}
SERVING_ITERS = 200  # replays timed for each graph (K = 50 a repetition)
HTTP_CLIENTS = 8
HTTP_REQUESTS = 16  # bs=1 requests a client


def quantize(image: np.ndarray) -> np.ndarray:
    """A normalized f32 image as the uint8 image nearest it, as
    ``evaluate_all.artifact_eval_steps`` quantizes one at the serving
    boundary."""
    from cfpnet_torch.data.datasets import IMAGENET_MEAN, IMAGENET_STD

    return np.clip(np.round((image * IMAGENET_STD + IMAGENET_MEAN) * 255.0), 0,
                   255).astype(np.uint8)


def normalized_image_node(gm):
    """The node of an exported serving graph that holds the normalized f32
    image: ``image_u8`` -> to(f32) -> / 255 -> - mean -> / std
    (``train/steps.py::normalize_image_u8``)."""
    node = next(n for n in gm.graph.nodes if n.op == "placeholder" and n.name == "image_u8")
    for want in ("aten.to.dtype", "aten.div.Tensor", "aten.sub.Tensor", "aten.div.Tensor"):
        node = next(u for u in node.users if str(u.target) == want)
    return node


def artifact_on_float_image(gm, image: torch.Tensor, hist: torch.Tensor, mask: torch.Tensor):
    """The half-resolution prediction [h, w] (float64, on the host) of an
    exported bs=1 serving graph run on a normalized f32 image that no uint8
    image gives: the graph runs node by node (``torch.fx.Interpreter``) with
    its normalized-image node (``normalized_image_node``) replaced by
    ``image``, and the model's prediction is recovered from the graph's
    output, its align-corners upsample to the input size, by least squares
    through the two interpolation matrices (both of full column rank). The
    graph's clamp to the eval bounds must not have acted."""
    from cfpnet_torch.ops.interp import _interp_matrix

    node = normalized_image_node(gm)

    class Substituted(torch.fx.Interpreter):
        def run_node(self, n):
            return image if n is node else super().run_node(n)

    placeholder = torch.zeros(image.shape, dtype=torch.uint8, device=image.device)
    with torch.no_grad():
        out = Substituted(gm).run(placeholder, hist, mask)
    depth = (out[0] if isinstance(out, (tuple, list)) else out)[0].double().cpu().numpy()
    H, W = depth.shape
    h, w = H // 2, W // 2
    mh, mw = _interp_matrix(h, H), _interp_matrix(w, W)
    return np.linalg.pinv(mh) @ depth @ np.linalg.pinv(mw).T


def serving_golden(gm, args, dtype: str):
    """The golden of the bs=1 forward (``tests/golden/full_forward.npz``)
    held by an exported serving graph on the golden's own inputs
    (``artifact_on_float_image``): in float32 its every-16th-pixel slice and
    mean within the golden's tolerance (rtol 5e-4, atol 5e-5), in bfloat16
    within ``BF16_DRIFT`` of the f32 golden (``bf16_drift``)."""
    img, hist, mask = args
    pred = artifact_on_float_image(gm, img, hist, mask)
    if dtype == "bfloat16":
        return bf16_drift(torch.from_numpy(pred)[None, :, :, None])
    ref = np.load(GOLDEN_FULL)
    got = dict(pred_slice=pred[::16, ::16], pred_mean=np.asarray([pred.mean()]))
    diffs = {}
    for key, val in got.items():
        np.testing.assert_allclose(val, ref[key], rtol=5e-4, atol=5e-5,
                                   err_msg=f"serving artifact against the golden in {key}")
        diffs[key] = float(np.abs(val - ref[key]).max())
    return dict(max_abs_diff=diffs)


def replay_device_kernels(replay, attempts: int = 5):
    """The ported kernels' device launches in one ``replay()`` by name
    (``SERVING_DEVICE_KERNELS``' keys, matched as substrings), from
    torch.profiler; a session that records another count is run again, up
    to ``attempts`` times (a session now and then records no device event,
    ``kernel_split``)."""
    from torch.profiler import ProfilerActivity, profile

    replay()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            replay()
            torch.cuda.synchronize()
        counts = {k: 0 for k in SERVING_DEVICE_KERNELS}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for k in counts:
                    if k in e.key:
                        counts[k] += e.count
        if counts == SERVING_DEVICE_KERNELS:
            break
    return counts


def same_prediction(got: np.ndarray, want: np.ndarray, what: str):
    """Raises unless two predictions are equal bit for bit, naming the gap."""
    if not np.array_equal(got, want):
        gap = np.abs(got.astype(np.float64) - want)
        raise AssertionError(f"{what}: max abs {gap.max()}, max rel "
                             f"{(gap / np.maximum(np.abs(want), 1e-30)).max()}")


def http_run(dst: str, image: np.ndarray, hist: np.ndarray, mask: np.ndarray):
    """``cfpnet_torch.serve.http`` on 127.0.0.1 at a free port over the
    artifact ``dst`` with a 2 ms micro-batching window: ``HTTP_CLIENTS``
    concurrent clients, each sending ``HTTP_REQUESTS`` bs=1 requests one
    after the other. Every request must be answered with a finite [1, H, W]
    depth. Returns requests/s over the run, the p50 and p99 of the
    requests' ms, and the micro-batcher's batches and rows."""
    import io
    import threading
    import urllib.request

    from cfpnet_torch.serve import http

    server = http.make_server(dst, port=0, batch_wait_ms=2.0, device="cuda", host="127.0.0.1")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/predict"
    latencies, failures = [], []
    try:
        def client(c):
            buf = io.BytesIO()
            np.savez(buf, image_u8=image[c % len(image)][None], hist=hist[c % len(hist)][None],
                     mask=mask[c % len(mask)][None])
            body = buf.getvalue()
            for _ in range(HTTP_REQUESTS):
                t = time.perf_counter()
                try:
                    req = urllib.request.Request(url, data=body, method="POST")
                    with np.load(io.BytesIO(urllib.request.urlopen(req, timeout=120).read())) as z:
                        depth = z["depth"]
                    if depth.shape != (1,) + image.shape[1:3] or not np.isfinite(depth).all():
                        failures.append(f"client {c}: depth {depth.shape}")
                except Exception as e:  # every failure is reported below
                    failures.append(f"client {c}: {e!r}")
                latencies.append((time.perf_counter() - t) * 1e3)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(HTTP_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        seconds = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            raise AssertionError("HTTP: a client did not finish in 300 s")
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.close()
    n = HTTP_CLIENTS * HTTP_REQUESTS
    if failures or len(latencies) != n:
        raise AssertionError(f"HTTP: {len(latencies)} of {n} requests, failures {failures[:5]}")
    return dict(clients=HTTP_CLIENTS, requests=n, seconds=seconds, requests_a_s=n / seconds,
                p50_ms=float(np.percentile(latencies, 50)),
                p99_ms=float(np.percentile(latencies, 99)),
                batches_run=server.batcher.batches_run, rows_run=server.batcher.rows_run,
                batch_wait_ms=2.0)


def serving_phase(config, geoms, args, keep=None):
    """Phase 15: serving (``cfpnet_torch/serve``) on the card, the
    production model on the deterministic weights exported into a
    temporary directory (removed after; with ``keep``, a copy of the bf16
    artifact stays there): bs 1 and 8 in bf16 (the headline dtype) and bs
    1 in f32, each reloaded by a fresh ``ServingModel``.

    - graph: each program calls the three custom ops 6 / 6 / 18 times;
    - eager launches: one eager call of each program's module, the launch
      counters set to 0 just before and read just after, launches 6 / 6 /
      18 kernels, all on the artifact's dtype;
    - the replayed graph: a profiled replay of the bs=1 serving graph runs
      the kernels' device functions at ``SERVING_DEVICE_KERNELS``' counts;
    - agreement: ``predict`` at bs=1 (the golden's inputs, the image
      quantized) and bs=8 (8 synthetic images, quantized) equals the live
      eval step (``make_eval_step`` on the model cast to the dtype) bit for
      bit, or the phase fails, naming the gap;
    - the golden: ``serving_golden`` on the bs=1 program;
    - padding: ``predict`` of 3 rows, which runs them padded in the bs=8
      program, equals the live bs=8 step on that padded batch bit for bit,
      and each row's own bs=1 ``predict`` within the golden's tolerance in
      f32 or ``BF16_DRIFT`` in bf16 (batch sizes change the sums);
    - times: export seconds and artifact bytes for each (bs, dtype); the
      bs=1 serving replay against the live ``CapturedForward`` replay in
      each dtype (``replay_latency_ms``, ``SERVING_ITERS``); bs=8 images/s;
      and one HTTP run (``http_run``) over the bf16 artifact."""
    import copy
    import shutil
    import tempfile

    from cfpnet_torch import kernels, weights
    from cfpnet_torch.data.datasets import SyntheticDataset, collate
    from cfpnet_torch.evaluate_time import replay_latency_ms
    from cfpnet_torch.graphs import CapturedForward
    from cfpnet_torch.models.deltar import cast_to_compute_dtype, make_model
    from cfpnet_torch.serve.export import ServingModel, custom_op_calls, export_serving_artifact
    from cfpnet_torch.train.steps import make_eval_step

    t_phase = time.perf_counter()
    sd = weights.deterministic_state_dict(config)
    img, hist, mask = args
    one = (quantize(img.cpu().numpy()), hist.cpu().numpy(), mask.cpu().numpy())
    samples = SyntheticDataset(config, "online_eval", 8)
    batch = collate([samples[i] for i in range(8)])
    eight = (quantize(batch["image"]), batch["hist_data"], batch["mask"])
    three = tuple(a[:3] for a in eight)
    padded = tuple(np.concatenate([a[:3], np.zeros((5,) + a.shape[1:], a.dtype)]) for a in eight)
    live32 = make_model(config, device="cuda")
    live32.load_state_dict(sd, strict=True)

    def live_step(dtype):
        model = live32 if dtype == torch.float32 else cast_to_compute_dtype(
            copy.deepcopy(live32), dtype)
        return model, make_eval_step(model, config, geoms, protocol="validate",
                                     compute_dtype=dtype)

    def as_batch(arrays):
        return {k: torch.from_numpy(a).cuda() for k, a in zip(("image_u8", "hist_data", "mask"),
                                                             arrays)}

    work = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    out = dict(phase="serving", artifacts={})
    try:
        for dtype_name_, sizes in SERVING_ARTIFACTS:
            dtype = getattr(torch, dtype_name_)
            dst = os.path.join(work, dtype_name_)
            t0 = time.perf_counter()
            export_serving_artifact(config, sd, dst, batch_sizes=sizes, compute_dtype=dtype_name_,
                                    device="cuda")
            export_s = time.perf_counter() - t0
            if keep and dtype == torch.bfloat16:
                shutil.copytree(dst, keep)
            m = ServingModel(dst, "cuda")
            model, step = live_step(dtype)
            rec = dict(export_s=export_s, bytes={
                str(bs): os.path.getsize(os.path.join(dst, m.manifest["files"][str(bs)]))
                for bs in sizes}, per_batch_size={})
            for bs in sizes:
                inputs = one if bs == 1 else eight
                calls = custom_op_calls(m.exported(bs))
                if calls != SERVING_OPS:
                    raise AssertionError(f"{dtype_name_} bs={bs} program calls {calls}")
                tensors = tuple(torch.from_numpy(a).cuda() for a in inputs)
                kernels.reset_launches()
                with torch.no_grad():
                    m.module(bs)(*tensors)
                torch.cuda.synchronize()
                by_dtype = launches_by_dtype()
                want = {k: {dtype_name_: v} for k, v in EVAL_LAUNCHES.items()}
                if by_dtype != want:
                    raise AssertionError(f"{dtype_name_} bs={bs} module launched {by_dtype}")
                got = m.predict(*inputs)
                same_prediction(got, step(as_batch(inputs))[0][..., 0].cpu().numpy(),
                                f"{dtype_name_} bs={bs} predict against the live eval step")
                entry = dict(custom_op_calls=calls, eager_launches=by_dtype,
                             predict_equals_live_step=True)
                if bs == 1:
                    entry["replay_device_kernels"] = replay_device_kernels(m.captured(1).replay)
                    if entry["replay_device_kernels"] != SERVING_DEVICE_KERNELS:
                        raise AssertionError(f"{dtype_name_} serving replay ran "
                                             f"{entry['replay_device_kernels']}")
                    entry["golden"] = serving_golden(m.module(1), args, dtype_name_)
                    entry["serving_replay_ms"] = replay_latency_ms(m.captured(1), SERVING_ITERS, 50)
                    live = CapturedForward(model, geoms, 1, config)
                    live(img.to(dtype), hist.to(dtype), mask)
                    entry["live_replay_ms"] = replay_latency_ms(live, SERVING_ITERS, 50)
                    del live
                else:
                    entry["serving_replay_ms"] = replay_latency_ms(m.captured(bs), SERVING_ITERS,
                                                                   50)
                    entry["images_a_s"] = bs * 1000.0 / entry["serving_replay_ms"]
                    got3 = m.predict(*three)
                    same_prediction(got3, step(as_batch(padded))[0][..., 0].cpu().numpy()[:3],
                                    f"{dtype_name_} 3 rows padded to bs=8 against the live step")
                    rows = np.concatenate([m.predict(*(a[i:i + 1] for a in three))
                                           for i in range(3)])
                    gap = np.abs(got3.astype(np.float64) - rows)
                    entry["padding"] = dict(
                        equals_live_padded_step=True, max_abs_vs_bs1=float(gap.max()),
                        max_rel_vs_bs1=float((gap / np.abs(rows)).max()),
                        median_rel_vs_bs1=float(np.median(gap / (np.abs(rows) + 1e-2))))
                    if dtype == torch.float32:
                        np.testing.assert_allclose(got3, rows, rtol=5e-4, atol=5e-5)
                    elif not (entry["padding"]["median_rel_vs_bs1"] < BF16_DRIFT["median_rel"]
                              and np.median(gap) < BF16_DRIFT["median_abs"]):
                        raise AssertionError(f"bf16 padded rows against bs=1: {entry['padding']}")
                    entry["http"] = http_run(dst, *eight)
                rec["per_batch_size"][str(bs)] = entry
            out["artifacts"][dtype_name_] = rec
            del m, model, step
        kernels.reset_launches()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    return out


# phase 16: the self-supervised variant (--selfsup)
# selfsup_golden_errors' limits, by TRAIN_GOLDEN_TOL's rule: 4 times the
# larger error of the port's float32 step on the CPU and the JAX package's own
# float32 step against the float64 golden (``python
# tests/test_torch_port_selfsup.py --tolerance``). As in the supervised step,
# the JAX package's own float32 trunk gradients are 17% off in norm; the loss
# terms, the head, PoseNet and the running statistics hold to 1e-7..7e-3.
# ``pose_grad_at_median`` is 0: more than half of PoseNet's sampled gradient
# entries are exactly 0 in every dtype (ReLUs that are off).
SELFSUP_GOLDEN_TOL = dict(
    loss=1.4e-6, photometric=2.1e-5, smooth=8.4e-5, zone=1.4e-6, stat=0.0072,
    stat_median=5.0e-6, zero_grad_norm=3.4e-7, zero_grad_norm_median=8.1e-11,
    head_grad_norm=9.3e-5, head_grad_norm_median=4.1e-6, head_grad_sum=2.4e-6,
    head_grad_sum_median=4.8e-7, head_grad_at=2.0e-4, head_grad_at_median=1.6e-6,
    head_param_at=6.0e-4, head_param_at_median=8.8e-5, pose_grad_norm=1.9e-4,
    pose_grad_norm_median=1.7e-4, pose_grad_sum=1.6e-4, pose_grad_sum_median=8.0e-6,
    pose_grad_at=1.8e-3, pose_grad_at_median=0.0, pose_param_at=6.2e-4,
    pose_param_at_median=1.1e-4, trunk_grad_norm=0.67, trunk_grad_norm_median=0.054,
    trunk_grad_sum=0.13, trunk_grad_sum_median=0.0032, trunk_grad_at=2.8,
    trunk_grad_at_median=0.18, trunk_param_at=0.36, trunk_param_at_median=0.005)
SELFSUP_WARM_STEPS = 3  # bs-16 steps before the launch count and the timing
SELFSUP_STEPS_TIMED = 10  # bs-16 steps between CUDA events, K = 5
SELFSUP_LOOP_STEPS = 2  # run_selfsup_training's steps in its one epoch
SELFSUP_EVAL_IMAGES = 16  # synthetic images of its validation


def selfsup_config(tconfig):
    """Phase 16's configuration: the production train step's (bs 16 at
    416x544) with ``--selfsup`` on synthetic pairs, validated on synthetic
    images."""
    return tconfig.replace(selfsup=True, dataset="synthetic", dataset_eval="synthetic",
                           synthetic_length=SELFSUP_EVAL_IMAGES, epochs=1, no_logging=False,
                           name="chip_smoke_selfsup", save_dir="results/chip_smoke_selfsup")


def selfsup_step_check(cfg, device="cuda"):
    """The bs-16 self-supervised step on synthetic pairs
    (``SyntheticPairDataset``) with the deterministic depth and pose
    weights: ``SELFSUP_WARM_STEPS`` steps with finite terms; one step's
    launches (counters set to 0 just before, read just after), which must
    be 6 attention, 6 + 6 dwconv and 18 fused-LoFTR launches, all on
    float32; ms a step (``SELFSUP_STEPS_TIMED`` steps between CUDA events)
    and images/s; the peak of allocated memory; one profiled step by kind,
    and beside it the objective on its own (``selfsup_terms``: PoseNet, the
    warp, SSIM, the smoothness and zone terms, forward and backward, on a
    fixed depth map), timed and profiled. ``device="cpu"`` runs the steps
    alone (a dry run at a tiny size)."""
    from cfpnet_torch import kernels, weights
    from cfpnet_torch.data.datasets import SyntheticPairDataset, collate
    from cfpnet_torch.data.geometry import geometry_for
    from cfpnet_torch.evaluate_time import train_latency_ms
    from cfpnet_torch.models.deltar import make_model, model_geometries
    from cfpnet_torch.models.posenet import PoseNet
    from cfpnet_torch.train import selfsup

    cuda = torch.device(device).type == "cuda"
    model = make_model(cfg, device=device)
    state = selfsup.create_selfsup_state(model, cfg, GOLDEN_TRAIN_TOTAL_STEPS,
                                         PoseNet().to(device))
    state.model.load_state_dict(weights.deterministic_selfsup_state_dict(cfg), strict=True)
    pixel_geom = geometry_for(cfg, "train")
    step = selfsup.make_selfsup_train_step(state, cfg, model_geometries(cfg, "train"),
                                           pixel_geom)
    pairs = SyntheticPairDataset(cfg, "train")
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in collate([pairs[i] for i in range(cfg.bs)]).items()}
    seeds = iter(range(cfg.seed, cfg.seed + 10 ** 6))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    warm = [{k: float(v) for k, v in step(state, batch, next(seeds)).items()}
            for _ in range(SELFSUP_WARM_STEPS)]
    if not all(math.isfinite(v) for terms in warm for v in terms.values()):
        raise AssertionError(f"selfsup terms of the warm steps: {warm}")
    kernels.reset_launches()
    step(state, batch, next(seeds))
    if not cuda:
        return dict(batch=cfg.bs, warm_terms=warm)
    torch.cuda.synchronize()
    launches, by_dtype = launch_counts(), launches_by_dtype()
    if launches != TRAIN_LAUNCHES or any(d != {"float32": launches[k]}
                                         for k, d in by_dtype.items()):
        raise AssertionError(f"a selfsup step launched {by_dtype}, expected {TRAIN_LAUNCHES} "
                             "on float32")
    ms = train_latency_ms(lambda: step(state, batch, next(seeds))["loss"],
                          SELFSUP_STEPS_TIMED, 5)
    events = device_events(lambda: step(state, batch, next(seeds)))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    depth_full = (1.0 + 3.0 * batch["image_raw"][..., :1]).requires_grad_()

    def objective():
        loss = selfsup.selfsup_terms(state.model.pose, cfg, pixel_geom, batch, depth_full)["loss"]
        loss.backward()
        return loss.detach()

    objective_ms = train_latency_ms(objective, SELFSUP_STEPS_TIMED, 5)
    objective_events = device_events(objective)
    device_share = busy(objective_events, objective_ms)
    return dict(batch=cfg.bs, size=[cfg.input_height, cfg.input_width], warm_terms=warm,
                launches_a_step=launches, launches_by_dtype=by_dtype, ms_a_step=ms,
                images_a_s=cfg.bs * 1000.0 / ms, steps_timed=SELFSUP_STEPS_TIMED,
                max_memory_allocated_gib=peak, profiled_step=busy(events, ms),
                profiled_step_by_kind=by_kind(events),
                pose_warp_photometric=dict(
                    what="selfsup_terms forward and backward on a fixed depth map: PoseNet, "
                         "the warp, SSIM, smoothness and zone terms (inside the step above)",
                    ms=objective_ms, device_ms=device_share.get("device_ms"),
                    kernel_launches=device_share.get("kernel_launches"),
                    by_kind=by_kind(objective_events)))


def selfsup_loop_check(cfg, device="cuda"):
    """``run_selfsup_training`` for one epoch of ``SELFSUP_LOOP_STEPS``
    steps and a validation on ``SELFSUP_EVAL_IMAGES`` synthetic images, in
    a temporary working directory: one ``selfsup_val`` line with finite
    metrics; the epoch's and the ``best`` depth weights, ``best`` loaded
    back into the eval model equal bit for bit to the trained depth model;
    the run's launches (counters set to 0 just before, read just after):
    the steps' and the validation forwards'."""
    import shutil
    import tempfile

    from cfpnet_torch import kernels
    from cfpnet_torch.models.deltar import make_model
    from cfpnet_torch.train import checkpoint, selfsup

    cuda = torch.device(device).type == "cuda"
    here = os.getcwd()
    work = tempfile.mkdtemp(prefix="chip_smoke_selfsup_", dir=ROOT)
    os.chdir(work)
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        state = selfsup.run_selfsup_training(cfg, max_steps_per_epoch=SELFSUP_LOOP_STEPS,
                                             device=device)
        if cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        with open(os.path.join(cfg.save_dir, "selfsup_log.jsonl")) as f:
            log = [json.loads(line) for line in f]
        if ([x["kind"] for x in log] != ["selfsup_val"] or log[0]["step"] != SELFSUP_LOOP_STEPS
                or not all(math.isfinite(log[0][k]) for k in EVAL_METRICS + ("loss",))):
            raise AssertionError(f"selfsup log: {log}")
        saved = sorted(os.listdir(f"weights/{cfg.name}"))
        if len(saved) != 2 or saved[-1] != "best":
            raise AssertionError(f"selfsup weights: {saved}")
        eval_model = make_model(cfg, device=device)
        eval_model.load_state_dict(checkpoint.load_weights(f"weights/{cfg.name}/best"),
                                   strict=True)
        trained = state.model.depth.state_dict()
        differ = [k for k, v in eval_model.state_dict().items() if not torch.equal(v, trained[k])]
        if differ:
            raise AssertionError(f"best weights loaded back differ in {differ[:5]}")
        if cuda:
            want = {k: SELFSUP_LOOP_STEPS * TRAIN_LAUNCHES[k]
                    + min(SELFSUP_EVAL_IMAGES, 64) * EVAL_LAUNCHES[k] for k in TRAIN_LAUNCHES}
            if launches != want:
                raise AssertionError(f"run_selfsup_training launched {launches}, expected {want}")
        return dict(steps=SELFSUP_LOOP_STEPS, eval_images=min(SELFSUP_EVAL_IMAGES, 64),
                    run_s=seconds, launches_run=launches, weights_files=saved,
                    best_loaded_bit_equal=True,
                    selfsup_val={k: log[0][k] for k in ("loss", "rmse", "a1", "abs_rel")})
    finally:
        os.chdir(here)
        shutil.rmtree(work, ignore_errors=True)


def selfsup_phase(tconfig):
    """Phase 16: the self-supervised variant on the card. (a) one step at
    bs 2 against the JAX package's float64 golden
    (``selfsup_golden_errors``, within ``SELFSUP_GOLDEN_TOL``; 6 / 6 + 6 /
    18 launches); (b) the bs-16 step on synthetic pairs
    (``selfsup_step_check``); (c) a short ``run_selfsup_training``
    (``selfsup_loop_check``)."""
    t0 = time.perf_counter()
    errs, golden_launches, terms = selfsup_golden_errors()
    if golden_launches != TRAIN_LAUNCHES:
        raise AssertionError(f"the selfsup golden step launched {golden_launches}")
    if set(errs) != set(SELFSUP_GOLDEN_TOL) or not all(
            v <= SELFSUP_GOLDEN_TOL[k] for k, v in errs.items()):
        raise AssertionError(f"selfsup step against the golden: {errs}, tolerance "
                             f"{SELFSUP_GOLDEN_TOL}")
    golden = dict(golden=os.path.relpath(GOLDEN_SELFSUP, ROOT), terms=terms,
                  launches=golden_launches, errors=errs)
    cfg = selfsup_config(tconfig)
    step = selfsup_step_check(cfg)
    loop = selfsup_loop_check(cfg)
    return dict(phase="selfsup", golden_step=golden, step=step, loop=loop,
                seconds=time.perf_counter() - t0)


# phase 17: data parallelism (cfpnet_torch/parallel)
DP_TIMEOUT = 600.0  # seconds for the two processes, and for any join or collective of theirs
DP_STEPS_TIMED = 3  # bs-16 steps timed in each process, after one warm and one counted step
DP_EVAL_IMAGES = 8  # synthetic images of the sharded evaluation
DP_EVAL_RTOL = 1e-6  # its merged metrics against one process's evaluate


def state_digest(model) -> str:
    """sha256 of every parameter and buffer by name: equal digests, equal
    bits."""
    import hashlib

    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


class CountedAllReduce:
    """``torch.distributed.all_reduce`` counted while inside (calls, bytes);
    with ``sync``, each call also timed between two device synchronizations
    (``ms``), so that the time is the collective's own (gloo copies a CUDA
    tensor to the host after the kernels before it)."""

    def __init__(self, sync: bool = False):
        self.sync, self.calls, self.bytes, self.ms = sync, 0, 0, 0.0

    def __enter__(self):
        import torch.distributed as dist

        self.real = dist.all_reduce

        def counted(t, *args, **kw):
            self.calls += 1
            self.bytes += t.numel() * t.element_size()
            if self.sync:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            out = self.real(t, *args, **kw)
            if self.sync:
                torch.cuda.synchronize()
                self.ms += 1e3 * (time.perf_counter() - t0)
            return out

        dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.all_reduce = self.real


def dp_rank(rank: int, init_method: str, out_dir: str) -> None:
    """Process ``rank`` of phase 17's two, both on ``cuda:0``, joined over
    gloo (NCCL refuses two processes on one card). Writes
    ``out_dir/rank{rank}.json``:

    - ``golden``: the golden step (``golden_train_step``) on this process's
      row of the bs-2 golden batch: its errors against ``GOLDEN_TRAIN``,
      its launches, and a digest of every parameter and BatchNorm buffer
      after it;
    - ``evaluate``: ``evaluate_sharded`` over ``DP_EVAL_IMAGES`` synthetic
      images at 480x640 on the stepped weights, and this process's own
      ``evaluate`` of all of them;
    - ``step16``: the production f32 step at global bs 16 (8 + 8 rows): the
      launches of one step, ms a step over ``DP_STEPS_TIMED`` steps (host
      clock, synchronized), the all-reduces of one step (calls, bytes, ms
      between synchronizations, and that step's ms), one profiled step
      (its ``c10d::allreduce_`` host time and the device's busy share),
      and the peak of allocated memory."""
    from cfpnet_torch import kernels, weights
    from cfpnet_torch.data.datasets import SyntheticDataset
    from cfpnet_torch.data.pipeline import make_loader
    from cfpnet_torch.evaluate_time import make_train_batch, train_config
    from cfpnet_torch.models.deltar import make_model, model_geometries
    from cfpnet_torch.parallel import mesh
    from cfpnet_torch.train import steps
    from cfpnet_torch.train.loop import evaluate, evaluate_sharded

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = mesh.init_rank(rank, 2, init_method, "cuda:0", backend="gloo", timeout=DP_TIMEOUT)
    out = dict(rank=rank, world=mesh.world_size(), backend=torch.distributed.get_backend(),
               device=str(device))

    model, loss, launches = golden_train_step(str(device), rows=mesh.shard_batch)
    out["golden"] = dict(loss=float(loss), launches=launches, state_sha256=state_digest(model),
                         errors=golden_errors(golden_record(model, loss), np.load(GOLDEN_TRAIN)))

    config = production_config()
    ds = SyntheticDataset(config, "online_eval", DP_EVAL_IMAGES)
    out["evaluate"] = dict(
        sharded=evaluate_sharded(model, config, ds, device=device),
        one_process=evaluate(model, config, make_loader(config, "online_eval", dataset=ds,
                                                        device=device)))
    del model
    torch.cuda.empty_cache()

    tconfig = train_config(config)
    model = make_model(tconfig, device=device)
    model.load_state_dict(weights.deterministic_state_dict(tconfig), strict=True)
    state = steps.create_train_state(model, tconfig, GOLDEN_TRAIN_TOTAL_STEPS)
    train_step = steps.make_train_step(model, tconfig, model_geometries(tconfig, "train"))
    batch = mesh.shard_batch(make_train_batch(tconfig, tconfig.bs, device))
    seeds = iter(range(tconfig.seed, tconfig.seed + 10 ** 6))
    torch.cuda.reset_peak_memory_stats(device)
    train_step(state, batch, next(seeds))
    kernels.reset_launches()
    train_step(state, batch, next(seeds))
    torch.cuda.synchronize()
    step_launches = launch_counts()
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(DP_STEPS_TIMED):
        loss = train_step(state, batch, next(seeds))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / DP_STEPS_TIMED
    mesh.barrier()
    with CountedAllReduce(sync=True) as reduced:
        t0 = time.perf_counter()
        train_step(state, batch, next(seeds))
        torch.cuda.synchronize()
        synced_ms = 1e3 * (time.perf_counter() - t0)
    events = device_events(lambda: train_step(state, batch, next(seeds)))
    c10d = [e for e in events if e.key == "c10d::allreduce_"]
    out["step16"] = dict(
        rows=int(batch["image"].shape[0]), global_batch=tconfig.bs, launches_a_step=step_launches,
        ms_a_step=ms, images_a_s=tconfig.bs * 1000.0 / ms, steps_timed=DP_STEPS_TIMED,
        loss=float(loss), allreduce_calls_a_step=reduced.calls,
        allreduce_bytes_a_step=reduced.bytes, allreduce_ms_synced=reduced.ms,
        step_ms_synced=synced_ms, allreduce_share_synced=reduced.ms / synced_ms,
        profiled_c10d_allreduce=dict(calls=sum(e.count for e in c10d),
                                     host_ms=sum(e.cpu_time_total for e in c10d) / 1e3),
        profiled_step=busy(events, ms),
        max_memory_allocated_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def multi_process_phase(artifact: str):
    """Phase 17: data parallelism (``cfpnet_torch/parallel``) on the card.

    (a) A process group of one over NCCL: the golden step through the
        data-parallel step (its gradients all-reduced over NCCL) equals the
        same step with no group bit for bit, loss and every parameter and
        buffer, both under deterministic algorithms; and it is within
        ``TRAIN_GOLDEN_TOL`` of the golden.
    (b) Two processes on ``cuda:0`` over gloo (``dp_rank``, spawned by
        ``parallel/launch.py``, ``DP_TIMEOUT``): the golden step as 1 + 1
        rows within ``TRAIN_GOLDEN_TOL`` of the golden, both processes'
        parameters and buffers after it equal bit for bit, 6 / 12 / 18
        launches a step in each (the golden step and the bs-16 step);
        the bs-16 step's times, all-reduces and memory for the record; and
        ``evaluate_sharded``'s metrics equal on both, within
        ``DP_EVAL_RTOL`` of one process's ``evaluate``.
    (c) ``ServingModel.predict_sharded`` over the one card equals
        ``predict`` bit for bit (``artifact``: phase 15's bf16 artifact, bs
        1 and 8), by default and through a replica of the programs moved
        to ``cuda:0`` (``devices=[cuda:0]``), as each card of several gets.

    Gloo stages every collective through the host, and two processes share
    the card: (b) measures the path, not multi-card speed."""
    import gc
    import shutil
    import tempfile

    from cfpnet_torch.data.datasets import SyntheticDataset, collate
    from cfpnet_torch.parallel import launch, mesh
    from cfpnet_torch.serve.export import ServingModel

    t_phase = time.perf_counter()
    ref = np.load(GOLDEN_TRAIN)
    work = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        with deterministic_algorithms() as caught:
            plain_model, plain_loss, _ = golden_train_step()
            plain = {k: v.clone() for k, v in plain_model.state_dict().items()}
            del plain_model
            mesh.init_rank(0, 1, "file://" + os.path.join(work, "store"), "cuda:0",
                           timeout=DP_TIMEOUT)
            try:
                backend = torch.distributed.get_backend()
                with CountedAllReduce() as reduced:
                    model, loss, launches = golden_train_step()
            finally:
                torch.distributed.destroy_process_group()
        differ = [k for k, v in model.state_dict().items() if not torch.equal(v, plain[k])]
        if backend != "nccl" or reduced.calls != 1 or not torch.equal(loss, plain_loss) or differ:
            raise AssertionError(f"a group of one over {backend} ({reduced.calls} all-reduces): "
                                 f"loss {float(loss)} against {float(plain_loss)}, "
                                 f"{len(differ)} tensors differ: {differ[:5]}")
        errs = golden_errors(golden_record(model, loss), ref)
        if launches != TRAIN_LAUNCHES or set(errs) != set(TRAIN_GOLDEN_TOL) or not all(
                v <= TRAIN_GOLDEN_TOL[k] for k, v in errs.items()):
            raise AssertionError(f"the group of one's golden step: launches {launches}, "
                                 f"errors {errs}")
        one = dict(backend=backend, allreduce_calls=reduced.calls,
                   allreduce_bytes=reduced.bytes, bit_for_bit_the_plain_step=True,
                   deterministic_warnings=sorted({str(w.message)[:120] for w in caught}),
                   golden_errors=errs, launches=launches)
        del model, plain
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        launch.spawn("chip_smoke:dp_rank", 2, (work,), timeout=DP_TIMEOUT)
        two_s = time.perf_counter() - t0
        ranks = []
        for r in (0, 1):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for r in ranks:
        errs = r["golden"]["errors"]
        if (r["world"], r["backend"]) != (2, "gloo") or set(errs) != set(TRAIN_GOLDEN_TOL) \
                or not all(v <= TRAIN_GOLDEN_TOL[k] for k, v in errs.items()):
            raise AssertionError(f"process {r['rank']}'s golden step: {r['golden']}")
        if r["golden"]["launches"] != TRAIN_LAUNCHES or \
                r["step16"]["launches_a_step"] != TRAIN_LAUNCHES:
            raise AssertionError(f"process {r['rank']} launched {r['golden']['launches']} in "
                                 f"the golden step, {r['step16']['launches_a_step']} at bs 16")
        ev = r["evaluate"]
        if set(ev["sharded"]) != set(EVAL_METRICS) or not all(
                abs(ev["sharded"][k] - ev["one_process"][k]) <= DP_EVAL_RTOL
                * abs(ev["one_process"][k]) for k in EVAL_METRICS):
            raise AssertionError(f"process {r['rank']}: sharded {ev['sharded']}, one process "
                                 f"{ev['one_process']}")
    if ranks[0]["golden"]["state_sha256"] != ranks[1]["golden"]["state_sha256"]:
        raise AssertionError("the two processes hold other weights after the golden step")
    if ranks[0]["golden"]["loss"] != ranks[1]["golden"]["loss"] or \
            ranks[0]["evaluate"]["sharded"] != ranks[1]["evaluate"]["sharded"]:
        raise AssertionError(f"the two processes disagree: {[r['golden'] for r in ranks]}, "
                             f"{[r['evaluate']['sharded'] for r in ranks]}")

    m = ServingModel(artifact, "cuda")
    samples = SyntheticDataset(production_config(), "online_eval", 8)
    batch = collate([samples[i] for i in range(8)])
    eight = (quantize(batch["image"]), batch["hist_data"], batch["mask"])
    want = m.predict(*eight)
    for devices in (None, [torch.device("cuda", 0)]):
        got = m.predict_sharded(*eight, devices=devices)
        if not np.array_equal(got, want):
            raise AssertionError(f"predict_sharded over {devices} differs from predict: max "
                                 f"{np.abs(got.astype(np.float64) - want).max()}")
    replicas = sorted(m._replicas)
    return dict(phase="multi_process", group_of_one=one, two_processes=dict(
        seconds=two_s, golden_loss=ranks[0]["golden"]["loss"],
        golden_errors=[r["golden"]["errors"] for r in ranks],
        golden_launches=ranks[0]["golden"]["launches"], state_bit_identical=True,
        evaluate_sharded=ranks[0]["evaluate"]["sharded"], step16=[r["step16"] for r in ranks]),
        predict_sharded=dict(rows=8, equals_predict=True, replicas=replicas,
                             cards=torch.cuda.device_count()),
        seconds=time.perf_counter() - t_phase)


# phase 18: spatial partitioning (--spatial_shards, cfpnet_torch/parallel/spatial.py)
SPATIAL_GRID = (1, 2)  # (dp, sp) over ["cuda:0"] * 2: the one card, repeated
SPATIAL_STEPS_TIMED = 6  # bs-16 grid steps between CUDA events (K = 3), after 2 warm ones


def spatial_phase(tconfig, plain_step_ms: float, card: str):
    """Phase 18: the production model with each image's rows split over a
    1 x 2 grid of the one card (``SPATIAL_GRID``), the library's repeated
    device list. The f32 eval forward at bs 2 (the golden image and its
    mirror) against the one-device forward (max |diff| <= ``TOL`` x max
    |one-device|) and its first row against the golden; the bf16 forward
    within ``BF16_DRIFT`` of the golden; each forward launching 6 / 6 / 18;
    the golden train step on the grid within ``TRAIN_GOLDEN_TOL``, 6 / 12 /
    18 launches; the bs-16 step at 416x544 on the grid, ms a step beside
    phase 9's one-device step, launches and peak memory. ``card`` (the
    nvidia-smi line) goes beside every number."""
    from cfpnet_torch import kernels, weights
    from cfpnet_torch.evaluate_time import make_train_batch, train_latency_ms
    from cfpnet_torch.models.deltar import cast_to_compute_dtype, make_model, model_geometries
    from cfpnet_torch.parallel import spatial
    from cfpnet_torch.train import steps

    dp, sp = SPATIAL_GRID
    grid = spatial.make_mesh_2d(dp, sp, ["cuda:0"] * (dp * sp))
    config = production_config()
    geoms = model_geometries(config, "online_eval")
    sd = weights.deterministic_state_dict(config)
    img = torch.from_numpy(weights.det_leaf("img", (1, 480, 640, 3))).cuda()
    img = torch.cat([img, img.flip(2)])
    hist = torch.from_numpy(np.abs(weights.det_leaf("hist", (1, 64, 16))) * 20).cuda()
    hist = hist.repeat(2, 1, 1)
    mask = torch.ones((2, 64), dtype=torch.bool, device="cuda")

    def on_grid(model, dtype=torch.float32):
        placed = spatial.shard_batch_spatial(dict(image=img, hist_data=hist, mask=mask), grid)
        with torch.no_grad():
            edges, pred, prob, _ = model(spatial.each(lambda x: x.to(dtype), placed["image"]),
                                         [h.to(dtype) for h in placed["hist_data"]],
                                         placed["mask"], geoms, grid=grid)
        return edges, spatial.gather(pred, grid.root, 1), spatial.gather(prob, grid.root, 1)

    def counted(fn):
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, launch_counts()

    model = make_model(config, device="cuda")
    model.load_state_dict(sd, strict=True)
    got, launches = counted(lambda: on_grid(model))
    check_launches(launches, 2)
    with torch.no_grad():
        one = model(img, hist, mask, geoms)[:3]
    rel = {name: float((a - b).abs().max()) / float(b.abs().max())
           for name, a, b in zip(("bin_edges", "pred", "prob"), got, one)}
    if not all(math.isfinite(v) and v <= TOL for v in rel.values()):
        raise AssertionError(f"the grid forward against the one-device forward: {rel}")
    golden = golden_diffs(got[0][:1], got[1][:1])
    forward_ms = device_ms(lambda: on_grid(model), reps=5, trials=3)
    with torch.no_grad():
        one_ms = device_ms(lambda: model(img, hist, mask, geoms), reps=5, trials=3)
    cast_to_compute_dtype(model, torch.bfloat16)
    got16, launches16 = counted(lambda: on_grid(model, torch.bfloat16))
    check_launches(launches16, 2)
    drift = bf16_drift(got16[1][:1])
    del model, got, got16, one

    gmodel, gloss, glaunches = golden_train_step(grid=grid)
    errs = golden_errors(golden_record(gmodel, gloss), np.load(GOLDEN_TRAIN))
    del gmodel
    if glaunches != TRAIN_LAUNCHES:
        raise AssertionError(f"the golden step on the grid launched {glaunches}")
    if set(errs) != set(TRAIN_GOLDEN_TOL) or not all(
            v <= TRAIN_GOLDEN_TOL[k] for k, v in errs.items()):
        raise AssertionError(f"the golden step on the grid: {errs}, tolerance "
                             f"{TRAIN_GOLDEN_TOL}")

    model = make_model(tconfig, device="cuda")
    model.load_state_dict(weights.deterministic_state_dict(tconfig), strict=True)
    state = steps.create_train_state(model, tconfig, GOLDEN_TRAIN_TOTAL_STEPS)
    step = steps.make_train_step(model, tconfig, model_geometries(tconfig, "train"), grid)
    batch = make_train_batch(tconfig, tconfig.bs)
    seeds = iter(range(tconfig.seed, tconfig.seed + 10 ** 6))
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(state, batch, next(seeds))) for _ in range(2)]
    _, step_launches = counted(lambda: step(state, batch, next(seeds)))
    if step_launches != TRAIN_LAUNCHES:
        raise AssertionError(f"a bs-{tconfig.bs} step on the grid launched {step_launches}")
    ms = train_latency_ms(lambda: step(state, batch, next(seeds)), SPATIAL_STEPS_TIMED, 3)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"grid step losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del model, state
    return dict(phase="spatial", card=card, grid=[dp, sp],
                devices=[str(d) for d in grid.devices],
                forward=dict(batch=2, size=[480, 640], max_rel_err_vs_one_device=rel,
                             golden_max_abs_diff=golden, ms=forward_ms, one_device_ms=one_ms),
                launches_forward=launches, launches_forward_bf16=launches16, bf16_drift=drift,
                train_golden=dict(loss=float(gloss), launches=glaunches, errors=errs),
                step16=dict(batch=tconfig.bs, size=[tconfig.input_height, tconfig.input_width],
                            ms_a_step=ms, one_device_ms_a_step=plain_step_ms,
                            steps_timed=SPATIAL_STEPS_TIMED, losses_warm=losses,
                            launches_a_step=step_launches, max_memory_allocated_gib=peak))


# phase 19: the DELTAR baseline, the fusion layer names, masked calls, the demo
CONFIG_ITERS = 50  # evaluate_time --niters of the phase's replays
CONFIG_STEPS_TIMED = 4  # bs-16 baseline steps between CUDA events (K = 2), after 2 warm ones
# max |card - CPU float64| / max |CPU float64| of a masked call, by dtype
MASKED_TOL = {torch.float32: 1e-5, torch.bfloat16: BF16_TOL}


def config_argv(name: str):
    """The config arguments of phase 19's configuration ``name``."""
    return list(CONFIG_GOLDENS[name][1])


def config_forward(name: str, device="cuda"):
    """The f32 bs=1 forward of configuration ``name`` (``CONFIG_GOLDENS``)
    on the deterministic weights and the golden's inputs: its eager outputs
    against the golden, their launches against ``CONFIG_LAUNCHES``, and (on
    the card) its CUDA graph's replay bit for bit the eager forward and the
    golden. Returns (the line's fields, the model, its config, the inputs)."""
    from cfpnet_torch import weights
    from cfpnet_torch.config import parse_config
    from cfpnet_torch.graphs import CapturedForward
    from cfpnet_torch.models.deltar import make_model, model_geometries

    golden = CONFIG_GOLDENS[name][0]
    config = parse_config(config_argv(name)).replace(mode="online_eval")
    geoms = model_geometries(config, "online_eval")
    model = make_model(config, device=device)
    model.load_state_dict(weights.deterministic_state_dict(config), strict=True)
    img = torch.from_numpy(weights.det_leaf("img", (1, 480, 640, 3))).to(device)
    hist = torch.from_numpy(np.abs(weights.det_leaf("hist", (1, 64, 16))) * 20).to(device)
    mask = torch.ones((1, 64), dtype=torch.bool, device=device)
    args = (img, hist, mask)
    (edges, pred, prob, _), launches = eager_launches(model, args, geoms)
    if device != "cpu" and launches != CONFIG_LAUNCHES[name]:
        raise AssertionError(f"{name}: the bs=1 forward launched {launches}, expected "
                             f"{CONFIG_LAUNCHES[name]}")
    if not (torch.isfinite(pred).all() and torch.isfinite(prob).all()):
        raise AssertionError(f"{name}: non-finite forward output")
    out = dict(launches=launches, golden=os.path.relpath(golden, ROOT),
               golden_max_abs_diff=golden_diffs(edges, pred, golden))
    if device != "cpu":
        captured = CapturedForward(model, geoms, 1, config)
        got = [t.clone() for t in captured(*args)[:3]]
        same_outputs(got, (edges, pred, prob), f"{name}: bs=1 replay")
        out["replay_golden_max_abs_diff"] = golden_diffs(got[0], got[1], golden)
        del captured
    return out, model, config, args


def replay_ms(argv, dtype: str) -> float:
    """``python -m cfpnet_torch.evaluate_time`` on ``argv`` (the synthetic
    sample, the deterministic weights) in ``dtype``: ms of a bs=1 replay."""
    from cfpnet_torch import evaluate_time

    out = evaluate_time.main(argv + ["--compute_dtype", dtype, "--test_dataset", "synthetic",
                                     "--niters", str(CONFIG_ITERS)])
    if out["dtype"] != dtype or not out["latency_ms_bs1"] > 0:
        raise AssertionError(f"evaluate_time {argv} --compute_dtype {dtype}: {out}")
    return out["latency_ms_bs1"]


def baseline_step(config):
    """The baseline's bs-16 train step at 416x544 in f32 from the
    deterministic weights: finite losses, the launches of one step, ms a
    step, peak memory."""
    from cfpnet_torch import kernels, weights
    from cfpnet_torch.evaluate_time import make_train_batch, train_config, train_latency_ms
    from cfpnet_torch.models.deltar import make_model, model_geometries
    from cfpnet_torch.train import steps

    tconfig = train_config(config)
    model = make_model(tconfig, device="cuda")
    model.load_state_dict(weights.deterministic_state_dict(tconfig), strict=True)
    state = steps.create_train_state(model, tconfig, GOLDEN_TRAIN_TOTAL_STEPS)
    step = steps.make_train_step(model, tconfig, model_geometries(tconfig, "train"))
    batch = make_train_batch(tconfig, tconfig.bs)
    seeds = iter(range(tconfig.seed, tconfig.seed + 10 ** 6))
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(state, batch, next(seeds))) for _ in range(2)]
    kernels.reset_launches()
    losses.append(float(step(state, batch, next(seeds))))
    torch.cuda.synchronize()
    launches = launch_counts()
    if launches != CONFIG_LAUNCHES["baseline"]:
        raise AssertionError(f"a baseline bs-{tconfig.bs} step launched {launches}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"baseline step losses {losses}")
    ms = train_latency_ms(lambda: step(state, batch, next(seeds)), CONFIG_STEPS_TIMED, 2)
    return dict(batch=tconfig.bs, size=[tconfig.input_height, tconfig.input_width],
                dtype="float32", losses=losses, launches_a_step=launches, ms_a_step=ms,
                steps_timed=CONFIG_STEPS_TIMED,
                max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def masked_calls(device="cuda", scale: int = 4):
    """Masked linear attention and a masked LoFTR layer at the bs=1
    hist2image shape of ``scale`` (N = 64 zones, L = p1 * p2, S = 16, C =
    128 / 64 / 32 at 1/16 / 1/8 / 1/4, 4 heads), about half of each mask
    false, on numpy-seeded inputs and weights (std 0.1): on ``device`` in
    f32 and bf16 against the same call on the CPU in float64 on the same
    values, within ``MASKED_TOL`` x max |float64|, with no kernel launched
    (the plain route); the same calls unmasked launch their kernels on the
    card."""
    from cfpnet_torch import kernels
    from cfpnet_torch.models.deltar import model_geometries
    from cfpnet_torch.models.transformer import LoFTREncoderLayer
    from cfpnet_torch.ops import dispatch

    g = model_geometries(production_config(), "online_eval")[scale]
    N, L, S, C, H = g.zone_num ** 2, g.p1 * g.p2, 16, 8 * scale, 4
    rng = np.random.default_rng(SEED)
    q = rng.standard_normal((N, L, H, C // H))
    k, v = rng.standard_normal((2, N, S, H, C // H))
    x, src = rng.standard_normal((N, L, C)), rng.standard_normal((N, S, C))
    x_mask, kv_mask = rng.random((N, L)) > 0.5, rng.random((N, S)) > 0.5
    kv_mask[:, 0] = True  # every zone keeps a key
    layer64 = LoFTREncoderLayer(C, H).double()
    with torch.no_grad():
        for n, p in layer64.named_parameters():  # LayerNorm scales near 1
            p.copy_(torch.from_numpy(0.1 * rng.standard_normal(tuple(p.shape))
                                     + (p.dim() == 1 and n.endswith("weight"))))
    masks = {n: torch.from_numpy(m) for n, m in (("x", x_mask), ("kv", kv_mask))}

    def run(dtype, dev, layer, masked=True):
        ts = [torch.from_numpy(a).to(dev, dtype) for a in (q, k, v, x, src)]
        m = {n: (t.to(dev) if masked else None) for n, t in masks.items()}
        with torch.no_grad():
            return (dispatch.attention(*ts[:3], q_mask=m["x"], kv_mask=m["kv"]),
                    layer(ts[3], ts[4], m["x"], m["kv"]))

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        layer = LoFTREncoderLayer(C, H).to(device, dtype)
        layer.load_state_dict(layer64.state_dict())
        # the float64 reference on the values the dtype holds
        ref_layer = LoFTREncoderLayer(C, H).double()
        ref_layer.load_state_dict({n: t.to(dtype).double()
                                   for n, t in layer64.state_dict().items()})
        with torch.no_grad():
            ts = [torch.from_numpy(a).to(dtype).double() for a in (q, k, v, x, src)]
            ref = (dispatch.attention(*ts[:3], q_mask=masks["x"], kv_mask=masks["kv"]),
                   ref_layer(ts[3], ts[4], masks["x"], masks["kv"]))
        kernels.reset_launches()
        got = run(dtype, device, layer)
        if device != "cpu":
            torch.cuda.synchronize()
        launches = launch_counts()
        errs = {}
        for what, a, b in zip(("attention", "loftr_layer"), got, ref):
            if a.dtype != dtype or a.device.type != torch.device(device).type:
                raise AssertionError(f"masked {what}: {a.dtype} on {a.device}")
            errs[what] = float((a.double().cpu() - b).abs().max()) / float(b.abs().max())
        if not all(math.isfinite(e) and e <= MASKED_TOL[dtype] for e in errs.values()):
            raise AssertionError(f"masked calls in {dtype}: {errs}, limit {MASKED_TOL[dtype]}")
        if any(launches.values()):
            raise AssertionError(f"masked calls in {dtype} launched {launches}")
        unmasked = None
        if device != "cpu":
            kernels.reset_launches()
            run(dtype, device, layer, masked=False)
            torch.cuda.synchronize()
            unmasked = launch_counts()
            if unmasked != {"linear_attention": 1, "dwconv": 0, "fused_loftr": 1}:
                raise AssertionError(f"the unmasked calls in {dtype} launched {unmasked}")
        out[str(dtype).replace("torch.", "")] = dict(
            max_rel_err=errs, limit=MASKED_TOL[dtype], launches_masked=launches,
            launches_unmasked=unmasked)
    return dict(shape=dict(N=N, L=L, S=S, C=C, H=H),
                mask_false_share=dict(x=float(1 - x_mask.mean()), kv=float(1 - kv_mask.mean())),
                **out)


def demo_check(device="cuda"):
    """``cfpnet_torch.demo.predict`` on the synthetic frame with the
    deterministic weights against this phase's own eager f32 forward of the
    same model on that frame, resized the same way (max |diff| <= 1e-6 x
    max |forward|)."""
    from cfpnet_torch import demo, weights
    from cfpnet_torch.data.datasets import sample_image_f32
    from cfpnet_torch.models.deltar import make_model, model_geometries
    from cfpnet_torch.ops.interp import resize_bilinear_align_corners

    config = demo.demo_config()
    sample = demo.load_frame(config)
    got = demo.predict(config, sample, device=device)
    model = make_model(config, device=device)
    model.load_state_dict(weights.deterministic_state_dict(config), strict=True)
    image = torch.from_numpy(sample_image_f32(sample)[None]).to(device)
    with torch.no_grad():
        pred = model(image, torch.from_numpy(sample["hist_data"][None]).to(device),
                     torch.from_numpy(sample["mask"][None]).to(device),
                     model_geometries(config, "online_eval"))[1]
        want = resize_bilinear_align_corners(pred, image.shape[1], image.shape[2])
    want = want[0, :, :, 0].cpu().numpy()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    if got.shape != (480, 640) or not np.isfinite(got).all() or not rel <= 1e-6:
        raise AssertionError(f"demo.predict: shape {got.shape}, finite "
                             f"{bool(np.isfinite(got).all())}, max rel diff {rel}")
    return dict(shape=list(got.shape), max_rel_diff_vs_forward=rel, min=float(got.min()),
                max=float(got.max()), mean=float(got.mean()))


def configs_phase(card: str):
    """Phase 19: (a) the DELTAR baseline (``configs/train_deltar_baseline.txt``:
    no combine1, so no dwconv and no cross-zone attention): the f32 bs=1
    forward eager and replayed against ``torch_port_baseline_forward.npz``,
    0 / 0 / 18 launches, the bf16 forward within ``BF16_DRIFT`` of that
    golden (0 / 0 / 18 on bf16), replay ms of both dtypes through
    ``evaluate_time``, ``evaluate`` on 2 synthetic images, and the bs-16
    train step; (b) the production configuration with the fusion layer names
    ``FUSION_NAMES``: the f32 forward eager and replayed against
    ``torch_port_fusion_names_forward.npz``, 9 / 12 / 9 launches, replay ms;
    (c) ``masked_calls``; (d) ``demo_check``. ``card`` (the nvidia-smi line)
    goes beside every number."""
    from cfpnet_torch import evaluate
    from cfpnet_torch.models.deltar import cast_to_compute_dtype, model_geometries

    t0 = time.perf_counter()
    base, model, config, args = config_forward("baseline")
    cast_to_compute_dtype(model, torch.bfloat16)
    img, hist, mask = args
    (_, pred16, _, _), launches16 = eager_launches(
        model, (img.to(torch.bfloat16), hist.to(torch.bfloat16), mask),
        model_geometries(config, "online_eval"))
    by_dtype = launches_by_dtype()
    if launches16 != CONFIG_LAUNCHES["baseline"] or any(
            set(d) - {"bfloat16"} for d in by_dtype.values()):
        raise AssertionError(f"the baseline's bf16 forward launched {by_dtype}")
    base.update(launches_bf16=launches16,
                bf16_drift=bf16_drift(pred16, CONFIG_GOLDENS["baseline"][0]))
    del model
    base["replay_ms"] = {dt: replay_ms(config_argv("baseline"), dt)
                         for dt in ("float32", "bfloat16")}
    entry = evaluate.main(config_argv("baseline") + [
        "--test_dataset", "synthetic", "--synthetic_length", "2", "--time_iters", "0"])
    if len(entry["metrics"]) != 9 or not all(math.isfinite(v)
                                             for v in entry["metrics"].values()):
        raise AssertionError(f"evaluate on the baseline: {entry['metrics']}")
    base["evaluate_metrics"] = entry["metrics"]
    base["step16"] = baseline_step(config)

    names, model, _, _ = config_forward("fusion_names")
    del model
    names["replay_ms"] = {"float32": replay_ms(config_argv("fusion_names"), "float32")}
    return dict(phase="configs", card=card, baseline=base,
                fusion_names=dict(names, attention_layer=list(FUSION_NAMES)),
                masked=masked_calls(), demo=demo_check(), seconds=time.perf_counter() - t0)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a GPU", file=sys.stderr)
        return 2

    from cfpnet_torch import bench, evaluate, weights
    from cfpnet_torch.evaluate_time import train_config
    from cfpnet_torch.kernels import build
    from cfpnet_torch.models.deltar import make_model, model_geometries

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    gpu = torch.cuda.get_device_name(0)
    emit(dict(phase="device", nvidia_smi=smi[0], name=gpu, count=torch.cuda.device_count(),
              torch=torch.__version__, cuda=torch.version.cuda))

    # 2. build
    t0 = time.perf_counter()
    seconds = build.build()
    ptxas = {name: ptxas_report(log) for name, log in build.BUILD_LOGS.items()}
    emit(dict(phase="build", seconds=time.perf_counter() - t0, per_source=seconds, ptxas=ptxas))
    # the bf16 fused layer's kernels keep their values in registers
    spilled = [k for k in ptxas.get("fused_loftr_bf16", ())
               if k["spill_stores"] or k["spill_loads"]]
    if spilled:
        raise AssertionError(f"bf16 fused LoFTR kernels spill: {spilled}")

    # 3. kernels at every main-path shape of the bs=1 and the bs=8 forward
    # and of the bs=16 train step; the configuration and inputs of
    # tests/test_golden.py::test_golden_forward_production_size
    config = production_config()
    geoms = model_geometries(config, "online_eval")
    tconfig = train_config(config)
    tgeoms = model_geometries(tconfig, "train")
    per_shape = check_kernels(config, geoms)
    per_shape_bs8 = check_kernels(config, geoms, 8, full=False)
    per_shape_train = check_kernels(tconfig, tgeoms, tconfig.bs, full=False, mode="train")

    # 4. the kernels' gradients at the train step's shapes
    gradients = check_gradients(tconfig, tgeoms, tconfig.bs)
    rows = kernel_rows(per_shape, per_shape_bs8, per_shape_train, gradients)
    # and the bf16 variants at the bf16 train step's shapes, forward and
    # backward
    per_shape_train16 = check_kernels_bf16(tconfig, tgeoms, tconfig.bs, mode="train")
    gradients16 = check_gradients(tconfig, tgeoms, tconfig.bs, torch.bfloat16)
    for r in rows:
        r.update(bf16_train_fields(r["name"], per_shape_train16, gradients16))

    # 5. slice: the full-width forward through the kernels, against the golden
    model = make_model(config, device="cuda")
    model.load_state_dict(weights.deterministic_state_dict(config), strict=True)
    img = torch.from_numpy(weights.det_leaf("img", (1, 480, 640, 3))).cuda()
    hist = torch.from_numpy(np.abs(weights.det_leaf("hist", (1, 64, 16))) * 20).cuda()
    mask = torch.ones((1, 64), dtype=torch.bool, device="cuda")
    args = (img, hist, mask)
    (bin_edges, pred, prob, _), launches = eager_launches(model, args, geoms)
    check_launches(launches, 1)
    for r in rows:
        r["launches"] = launches[r["name"]]
    if tuple(pred.shape) != (1, 240, 320, 1) or tuple(prob.shape) != (1, 240, 320, 256):
        raise AssertionError(f"pred {tuple(pred.shape)}, prob {tuple(prob.shape)}")
    if not (torch.isfinite(pred).all() and torch.isfinite(prob).all()):
        raise AssertionError("non-finite forward output")
    emit(dict(phase="slice", launches=launches, golden_max_abs_diff=golden_diffs(bin_edges, pred),
              pred_mean=float(pred.mean())))

    # 6. graph: the forward captured in a CUDA graph at bs=1 and bs=8
    emit(graph_phase(model, config, geoms, args))

    # 7. entry: the eval entry point on synthetic images
    entry = {}
    for bs, iters in ((1, 50), (2, 0)):
        out = evaluate.main([f"@{PROD_CONFIG}", "--test_dataset", "synthetic",
                             "--synthetic_length", "4", "--eval_bs", str(bs),
                             "--time_iters", str(iters)])
        if len(out["metrics"]) != 9 or not all(math.isfinite(v)
                                               for v in out["metrics"].values()):
            raise AssertionError(f"eval_bs={bs}: metrics {out['metrics']}")
        entry[f"bs{bs}"] = out
    emit(dict(phase="entry", latency_ms_bs1=entry["bs1"]["latency_ms_bs1"],
              latency_ms_bs1_eager=entry["bs1"]["latency_ms_bs1_eager"],
              metrics_bs1=entry["bs1"]["metrics"], metrics_bs2=entry["bs2"]["metrics"]))

    # 8. profile: where the bs=1 forward's time goes, eager and replayed
    profile = profile_phase(model, config, geoms, args, entry["bs1"])
    emit(profile)
    check_host_waits(profile)
    del model

    # 9. the train step: one step at bs 2 against the JAX package's golden,
    # then the production step at bs 16, timed and profiled
    errs, golden_launches, golden_loss = train_golden_errors()
    emit(dict(phase="train_golden", golden=os.path.relpath(GOLDEN_TRAIN, ROOT),
              loss=golden_loss, launches=golden_launches, errors=errs,
              tolerance=TRAIN_GOLDEN_TOL))
    if golden_launches != TRAIN_LAUNCHES:
        raise AssertionError(f"the golden step launched {golden_launches}")
    if set(errs) != set(TRAIN_GOLDEN_TOL) or not all(
            v <= TRAIN_GOLDEN_TOL[k] for k, v in errs.items()):
        raise AssertionError(f"train step against the golden: {errs}, tolerance "
                             f"{TRAIN_GOLDEN_TOL}")
    train = train_step_phase(tconfig)
    emit(train)
    for r in rows:
        r["launches_train_step"] = train["launches_a_step"][r["name"]]
    # the bf16 step: at bs 2 against the same float64 golden, all its kernels
    # on bf16 tensors; then at bs 16 beside the f32 step
    errs16, golden_launches16, golden_loss16 = train_golden_errors(compute_dtype="bfloat16")
    by_dtype16 = launches_by_dtype()
    emit(dict(phase="train_golden_bf16", golden=os.path.relpath(GOLDEN_TRAIN, ROOT),
              loss=golden_loss16, launches=golden_launches16, launches_by_dtype=by_dtype16,
              errors=errs16, tolerance=TRAIN_GOLDEN_TOL_BF16))
    if golden_launches16 != TRAIN_LAUNCHES or any(
            d != {"bfloat16": golden_launches16[k]} for k, d in by_dtype16.items()):
        raise AssertionError(f"the bf16 golden step launched {by_dtype16}")
    if set(errs16) != set(TRAIN_GOLDEN_TOL_BF16) or not all(
            v <= TRAIN_GOLDEN_TOL_BF16[k] for k, v in errs16.items()):
        raise AssertionError(f"bf16 train step against the golden: {errs16}, tolerance "
                             f"{TRAIN_GOLDEN_TOL_BF16}")
    train16 = train_step_phase(tconfig.replace(compute_dtype="bfloat16"))
    train16["f32_ms_a_step"] = train["ms_a_step"]
    emit(train16)
    for r in rows:
        r["launches_train_step_bf16"] = train16["launches_a_step"][r["name"]]

    # 10. the training loop: two epochs with validation and checkpoints,
    # a profiled step, and a resume from the epoch-0 checkpoint
    import tempfile

    sweep_dir = tempfile.mkdtemp(prefix="chip_smoke_sweep_")
    loop = loop_phase(tconfig, train["images_a_s"], keep_weights=sweep_dir)
    emit(loop)
    for r in rows:
        r["launches_loop"] = loop["launches_run"][r["name"]]
    emit(loop_bf16_phase(tconfig))

    # 14. the train options: --device_pipeline (the device transform, a
    # bf16 loop and its resume), --grad_accum, --remat, --debug_nans
    options = train_options_phase(tconfig, loop)
    emit(options)
    for r in rows:
        r["launches_device_pipeline_loop"] = options["loop_device_pipeline"]["launches_run"][
            r["name"]]

    # 11. bf16: the bf16 kernels, the bf16 forward's launches, drift and
    # graphs, evaluate_time --compute_dtype bfloat16, device time by kind
    bf16, lines16, lines16_bs8 = bf16_phase(config, geoms, args, entry["bs1"]["latency_ms_bs1"])
    emit(bf16)
    for r in rows:
        r.update(bf16_row_fields(r["name"], lines16, lines16_bs8),
                 launches_bf16=bf16["launches_by_dtype"][r["name"]].get("bfloat16", 0))

    # 12. the epoch sweep over the loop's weights
    emit(sweep_phase(sweep_dir))

    # 15. serving: the production model exported (bf16 bs 1 and 8, f32 bs 1),
    # reloaded, its custom ops, launches, replayed kernels, agreement with the
    # live eval step, golden, padding, times and one HTTP run
    kept = tempfile.mkdtemp(prefix="chip_smoke_artifact_")
    serving = serving_phase(config, geoms, args, keep=os.path.join(kept, "bf16"))
    emit(serving)
    for r in rows:
        r["launches_serving"] = {
            dt: a["per_batch_size"]["1"]["eager_launches"][r["name"]].get(dt, 0)
            for dt, a in serving["artifacts"].items()}

    # 16. the self-supervised variant: the golden step, the bs-16 step on
    # synthetic pairs, a short run_selfsup_training
    selfsup = selfsup_phase(tconfig)
    emit(selfsup)
    for r in rows:
        r["launches_selfsup_step"] = selfsup["step"]["launches_a_step"][r["name"]]

    # 17. data parallelism: a group of one over NCCL, two processes on the
    # card over gloo (the golden step, bs 16, sharded evaluation), and
    # predict_sharded on the one card
    import shutil

    try:
        dp = multi_process_phase(os.path.join(kept, "bf16"))
    finally:
        shutil.rmtree(kept, ignore_errors=True)
    emit(dp)
    for r in rows:
        r["launches_two_rank_step"] = dp["two_processes"]["step16"][0]["launches_a_step"][
            r["name"]]

    # 18. spatial partitioning: the forward, the golden step and the bs-16
    # step with each image's rows split over a 1 x 2 grid of the one card
    grid18 = spatial_phase(tconfig, train["ms_a_step"], smi[0])
    emit(grid18)
    for r in rows:
        r["launches_spatial_forward"] = grid18["launches_forward"][r["name"]]
        r["launches_spatial_step"] = grid18["step16"]["launches_a_step"][r["name"]]

    # 19. the DELTAR baseline and the fusion layer names against their
    # goldens, masked calls on the plain route, the demo's forward
    configs = configs_phase(smi[0])
    emit(configs)
    for r in rows:
        r["launches_configs"] = dict(
            baseline_forward=configs["baseline"]["launches"][r["name"]],
            baseline_step=configs["baseline"]["step16"]["launches_a_step"][r["name"]],
            fusion_names_forward=configs["fusion_names"]["launches"][r["name"]])

    # 13. the headline benchmark at reduced iterations (its own JSON line),
    # with the root bench's train keys: the bf16 step's, the f32 step's
    # under _f32
    import io

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = bench.main(["--iters", str(BENCH_ITERS), "--train_iters", str(BENCH_TRAIN_ITERS)])
    print(printed.getvalue(), end="", flush=True)
    line = json.loads(printed.getvalue().strip().splitlines()[-1])
    keys = {f"train_ms_bs{tconfig.bs}", "train_img_s", "tfps_train", "mfu_train"}
    missing = {k + sfx for k in keys for sfx in ("", "_f32")} - set(line)
    if rc != 0 or line.get("train_dtype") != "bfloat16" or missing:
        raise AssertionError(f"cfpnet_torch.bench: rc {rc}, train_dtype "
                             f"{line.get('train_dtype')}, missing {sorted(missing)}")
    emit(dict(phase="done", seconds_total=time.perf_counter() - t_start))

    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": gpu,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
