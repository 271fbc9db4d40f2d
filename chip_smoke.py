#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); exits nonzero without them.
Imports nothing of JAX or of the JAX package. Phases, each printing one JSON
line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: compiles every kernel of ``cfpnet_torch/csrc`` from source.
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
   LoFTR backwards (autograd of the plain version, recomputed).
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
7. entry: ``cfpnet_torch.evaluate`` on 4 synthetic images at bs=1 and
   bs=2; metrics must be finite; prints the bs=1 latency in a CUDA graph
   and eager.
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
   profiled step by kernel and by kind with the device's busy share.
10. bench: ``cfpnet_torch.bench`` at ``BENCH_ITERS`` forward and
    ``BENCH_TRAIN_ITERS`` train iterations prints its line.

Then the kernel table as one JSON line (each row also carries its
kernel's per-forward ms and bound, and its worst error over max |plain|,
at bs=8: ``ms_bs8``, ``bound_ms_bs8``, ``max_rel_err_bs8``; in the train
step's forward: ``ms_train``, ``bound_ms_train``, ``max_rel_err_train``; its
backward: ``backward_ms_train``, ``grad_max_rel_err_train``, for dwconv
``dx_ms_train``, ``dw_library_ms_train``; and its launches in one train
step, ``launches_train_step``), and last the ``ok`` line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_FULL = os.path.join(ROOT, "tests", "golden", "full_forward.npz")
# one production train step of the JAX package in float64 on the CPU, bs 2 at
# 416x544 (tests/test_torch_port_train.py::write_train_golden)
GOLDEN_TRAIN = os.path.join(ROOT, "tests", "golden", "torch_port_train_step.npz")
GOLDEN_TRAIN_BS = 2
GOLDEN_TRAIN_SEED = 5  # the step's seed: its crop offsets
GOLDEN_TRAIN_TOTAL_STEPS = 1000  # the OneCycle length (the root timed_train_step's)
# golden_errors' limits: 4 times the larger error of the same comparison on
# the CPU in float32, the port's step and the JAX package's own float32 step
# against the float64 golden (``python tests/test_torch_port_train.py
# --tolerance``). On the deterministic weights at bs 2 the step is
# ill-conditioned in float32 upstream of the BatchNorms (flax's fast
# variance cancels where a channel's mean dwarfs its spread): the JAX
# package's own float32 gradients are 15% off in norm there ("trunk"), while
# the loss, the head and the running statistics hold to 1e-7..1e-2.
TRAIN_GOLDEN_TOL = dict(loss=9.6e-7, stat=0.023, zero_grad_norm=1.3e-6,
                        head_grad_norm=1.5e-5, head_grad_sum=2.5e-6, head_grad_at=4.2e-4,
                        head_param_at=5.1e-4, trunk_grad_norm=0.59, trunk_grad_sum=0.15,
                        trunk_grad_at=2.6, trunk_param_at=0.29)
PROD_CONFIG = os.path.join(ROOT, "configs", "train_cfpnet_combine1.txt")
TOL = 1e-4  # max |kernel - plain| / max |plain|
# published H100 SXM peaks: HBM bytes/s, f32 flop/s outside the tensor cores,
# and the TF32 tensor-core rate over three (a 3xTF32 product is three TF32 ones)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_TF32_3X = 495e12 / 3
SEED = 117010053
BENCH_ITERS = 40  # cfpnet_torch.bench --iters in phase 10 (its default is 500)
BENCH_TRAIN_ITERS = 10  # and its --train_iters (its default is 40)


def emit(obj) -> None:
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


def bound_fields(nbytes: float, flops: float):
    """The least time for the work: bytes over the memory rate and operations
    over the f32 rate, in ms, and the larger of the two."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def kernel_split(fn, calls: int = 10, attempts: int = 3):
    """The device kernels of one ``fn()`` call by name: ``{name: {"launches":
    per call, "ms": device ms per call}}``, from torch.profiler (CUPTI) over
    ``calls`` back-to-back calls of ``fn``. A profiler session now and then
    records no device event at all; such a session is run again, up to
    ``attempts`` times."""
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
        if split:
            return split
    raise AssertionError(f"the profiler saw no device kernel in {attempts} sessions")


def pass_split(fn):
    """Device ms per call of the fused LoFTR layer's two device kernels
    (``summary_kernel``, ``rows_kernel``), by kernel name."""
    split = dict(summary_ms=0.0, rows_ms=0.0)
    for name, k in kernel_split(fn).items():
        for key in split:
            if key.replace("_ms", "_kernel") in name:
                split[key] += k["ms"]
    if not all(split.values()):
        raise AssertionError(f"the profiler saw no summary or row kernel: {split}")
    return split


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
    import torch.nn.functional as F

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
            split = kernel_split(lambda: linear_attention.linear_attention(q, k, v))
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


def check_gradients(config, geoms, batch: int):
    """Phase 4: each kernel's gradients at every train-step shape (``mode``
    "train") held against autograd of its plain version on the same inputs,
    each within ``TOL`` of its max |plain|: dq, dk, dv of the attention calls
    (the kernel's backward is that autograd, recomputed from the saved
    inputs); dx, dW, db of dwconv (dx: the forward kernel on the rotated
    taps; dW: PyTorch's depthwise weight gradient), against the plain twin
    at one batch row where k = 31 (its autograd is 961 full-size passes); dx, dsource,
    wq and w1 of the fused LoFTR layer. Each line also times the backward at
    the full batch: for dwconv dx, dW (from NCHW copies, as the port calls
    it, copies included, and on the channels-last views) and db apart,
    against the bounds of their work."""
    import torch.nn.functional as F

    from cfpnet_torch.kernels import dwconv, fused_loftr, linear_attention
    from cfpnet_torch.models.transformer import LoFTREncoderLayer
    from cfpnet_torch.ops.attention import linear_attention as att_plain
    from cfpnet_torch.ops.dwconv import depthwise_conv2d as dw_plain
    from cfpnet_torch.ops.loftr import loftr_apply

    att_shapes, dw_shapes, loftr_shapes = main_path_shapes(config, geoms, batch, "train")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 100)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device="cuda", generator=gen)).requires_grad_()

    def held(name, shape, got, ref):
        torch.cuda.synchronize()
        out = {}
        for key, a, b in zip(name.split(","), got, ref):
            err, top = float((a - b).abs().max()), float(b.abs().max())
            if not (err <= TOL * top):
                raise AssertionError(f"gradient {key} at {shape}: max err {err} > {TOL} * {top}")
            out[key] = err / top
        return out

    lines = []
    for (N, L, S, H, D), calls in sorted(att_shapes.items()):
        if not calls:
            continue
        ins = [randn(N, L, H, D), randn(N, S, H, D), randn(N, S, H, D)]
        g = torch.randn(N, L, H, D, device="cuda", generator=gen)
        got = torch.autograd.grad(linear_attention.linear_attention(*ins), ins, g)
        ref = torch.autograd.grad(att_plain(*ins), ins, g)
        lines.append(dict(kernel="linear_attention", shape=dict(N=N, L=L, S=S, H=H, D=D),
                          calls=calls, max_rel_err=held("dq,dk,dv", (N, L, S, H, D), got, ref),
                          backward_ms=device_ms(lambda: torch.autograd.grad(
                              att_plain(*ins), ins, g), reps=5, trials=3)))
    for (B, H, W, C, k), calls in sorted(dw_shapes.items()):
        x, w, b = randn(B, H, W, C), randn(C, 1, k, k, scale=0.05), randn(C)
        g = torch.randn(B, H, W, C, device="cuda", generator=gen)
        rows = 1 if k == 31 else B
        ins = [x[:rows].detach().requires_grad_(), w, b]
        got = torch.autograd.grad(dwconv.depthwise_conv2d(*ins), ins, g[:rows])
        ref = torch.autograd.grad(dw_plain(*ins), ins, g[:rows])
        errs = held("dx,dW,db", (rows, H, W, C, k), got, ref)
        wflip = w.detach().flip(-1, -2)
        xd = x.detach()
        x_nchw, g_nchw = xd.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        nbytes = 4 * (2 * B * H * W * C + C * k * k)
        flops = 2 * k * k * B * H * W * C
        lines.append(dict(
            kernel="dwconv", shape=dict(B=B, H=H, W=W, C=C, k=k), calls=calls,
            checked_rows=rows, max_rel_err=errs,
            dx_ms=device_ms(lambda: dwconv.depthwise_conv2d(g, wflip)),
            dw_ms=device_ms(lambda: torch.nn.grad.conv2d_weight(
                x_nchw.contiguous(), w.shape, g_nchw.contiguous(), padding=k // 2, groups=C),
                reps=5, trials=3),
            dw_channels_last_ms=device_ms(lambda: torch.nn.grad.conv2d_weight(
                x_nchw, w.shape, g_nchw, padding=k // 2, groups=C), reps=2, trials=3),
            db_ms=device_ms(lambda: g.sum((0, 1, 2))),
            dx_bound=bound_fields(nbytes, flops), dw_bound=bound_fields(nbytes, flops),
            library_conv_ms=device_ms(lambda: F.conv2d(x_nchw, w.detach(), b.detach(),
                                                       padding=k // 2, groups=C))))
    rng = np.random.default_rng(SEED + 100)
    for (N, L, S, C, H), calls in sorted(loftr_shapes.items()):
        def normal(*shape, mean=0.0, std=1.0):
            a = (mean + std * rng.standard_normal(shape)).astype(np.float32)
            return torch.from_numpy(a).cuda()

        x, src = normal(N, L, C).requires_grad_(), normal(N, S, C).requires_grad_()
        layer = LoFTREncoderLayer(C, H).cuda()
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
        emit(dict(phase="kernel_gradient", batch=batch, **r))
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


def golden_record(model, loss):
    """What the golden keeps of a step just taken (``GOLDEN_TRAIN``'s keys):
    the loss; per parameter its gradient's sum and norm, its gradient and
    its value after the step at ``leaf_indices``; every BatchNorm running
    statistic."""
    rec = {"loss": float(loss)}
    for k, p in model.named_parameters():
        g = p.grad.detach().double().cpu().numpy().ravel()
        idx = leaf_indices(g.size)
        rec.update({"grad_sum:" + k: g.sum(), "grad_norm:" + k: np.linalg.norm(g),
                    "grad_at:" + k: g[idx],
                    "param_at:" + k: p.detach().double().cpu().numpy().ravel()[idx]})
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            rec["stat:" + k] = v.double().cpu().numpy()
    return rec


def golden_errors(got, ref):
    """Errors of a step's record ``got`` against ``ref`` (both with the
    golden's keys), each the largest over the parameters of a class:
    ``head`` (``depth_head``, ``conv_out``: downstream of every
    BatchNorm), ``trunk`` (the rest), and ``zero`` (those whose reference
    gradient is zero in exact arithmetic, a norm below 1e-12 of the global
    one: a conv bias before a train-mode BatchNorm):

    - ``loss``: |loss - loss_ref| / |loss_ref|;
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
    """
    from cfpnet_torch import weights
    from cfpnet_torch.train.optim import LR_SCALE, onecycle_schedules, param_group_labels

    config = golden_train_config()
    start = weights.deterministic_state_dict(config)
    names = [k.split(":", 1)[1] for k in ref.keys() if k.startswith("grad_norm:")]
    labels = param_group_labels(names, config.hist_encoder_10x)
    lr0 = onecycle_schedules(config.lr, GOLDEN_TRAIN_TOTAL_STEPS, config.div_factor,
                             config.final_div_factor)[0](0)
    global_norm = np.sqrt(sum(float(ref["grad_norm:" + k]) ** 2 for k in names))
    errs = dict(loss=abs(float(got["loss"]) - float(ref["loss"])) / abs(float(ref["loss"])))

    def worst(key, value):
        errs[key] = max(errs.get(key, 0.0), float(value))

    for k in names:
        norm, n = float(ref["grad_norm:" + k]), start[k].numel()
        if norm <= 1e-12 * global_norm:
            worst("zero_grad_norm", float(got["grad_norm:" + k]) / global_norm)
            continue
        cls = "head" if k.startswith(("depth_head.", "conv_out.")) else "trunk"
        rms = norm / np.sqrt(n)
        g_ref = ref["grad_at:" + k]
        worst(cls + "_grad_norm", abs(float(got["grad_norm:" + k]) - norm) / norm)
        worst(cls + "_grad_sum", abs(float(got["grad_sum:" + k]) - float(ref["grad_sum:" + k]))
              / (norm * np.sqrt(n)))
        worst(cls + "_grad_at", np.abs(got["grad_at:" + k] - g_ref).max() / rms)
        clear = np.abs(g_ref) >= rms
        if clear.any():
            lr = float(np.float32(lr0 * np.float32(LR_SCALE[labels[k]])))
            worst(cls + "_param_at",
                  np.abs(got["param_at:" + k] - ref["param_at:" + k])[clear].max() / lr)
    for k in ref.keys():
        if k.startswith("stat:"):
            moved = np.abs(ref[k] - 0.9 * start[k[5:]].double().numpy()).max()
            worst("stat", np.abs(got[k] - ref[k]).max() / moved)
    return errs


def train_golden_errors(device="cuda"):
    """One step of the port's train step (``train/steps.py``) on
    ``golden_train_batch`` with the deterministic weights and the golden's
    crop offsets, against ``GOLDEN_TRAIN`` (``golden_errors``). Returns (the
    errors, the launch counts of the step, the loss)."""
    from cfpnet_torch import kernels, weights
    from cfpnet_torch.models import fusion
    from cfpnet_torch.models.deltar import make_model, model_geometries
    from cfpnet_torch.train import steps

    ref = np.load(GOLDEN_TRAIN)
    config = golden_train_config()
    model = make_model(config, device=device)
    model.load_state_dict(weights.deterministic_state_dict(config), strict=True)
    geoms = model_geometries(config, "train")
    state = steps.create_train_state(model, config, GOLDEN_TRAIN_TOTAL_STEPS)
    train_step = steps.make_train_step(model, config, geoms)
    batch = {k: torch.from_numpy(v).to(device) for k, v in golden_train_batch(config).items()}
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
    return golden_errors(golden_record(model, loss), ref), launches, float(loss)


def golden_diffs(bin_edges, pred):
    """Max abs differences of a bs=1 forward's outputs from
    ``tests/golden/full_forward.npz``; raises outside that test's tolerance
    (rtol 5e-4, atol 5e-5)."""
    ref = np.load(GOLDEN_FULL)
    got = dict(pred_slice=pred.cpu().numpy()[0, ::16, ::16, 0],
               bin_edges16=bin_edges.cpu().numpy()[0, ::16],
               pred_mean=pred.mean().cpu().numpy()[None])
    diffs = {}
    for key, val in got.items():
        np.testing.assert_allclose(val, ref[key], rtol=5e-4, atol=5e-5,
                                   err_msg=f"full-size golden mismatch in {key}")
        diffs[key] = float(np.abs(val - ref[key]).max())
    return diffs


def eager_launches(model, args, geoms):
    """The kernels' launch counts of one eager forward."""
    from cfpnet_torch import kernels

    kernels.reset_launches()
    with torch.no_grad():
        out = model(*args, geoms)
    torch.cuda.synchronize()
    return out, {k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels.KERNELS}


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


def host_waits(fn):
    """(copies from the host to the device, ``cudaStreamSynchronize`` calls)
    of one ``fn()``: the copies counted at the aten level (a copy of a CPU
    tensor into a CUDA one) and by the profiler's ``Memcpy HtoD`` device
    events, which a short session does not always receive; the syncs by the
    profiler."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class HostCopies(TorchDispatchMode):
        count = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.name().startswith(("aten::_to_copy", "aten::copy_")):
                ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
                if (any(t.device.type == "cpu" for t in ins)
                        and out.device.type == "cuda"):
                    self.count += 1
            return out

    with HostCopies() as aten:
        fn()
    events = device_events(fn)
    profiler = sum(e.count for e in events if "HtoD" in e.key)
    syncs = sum(e.count for e in events if e.key == "cudaStreamSynchronize")
    return dict(aten=aten.count, profiler=profiler), syncs


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
    ``config``'s shape (bs 16 at 416x544), eager, on one synthetic batch
    and the deterministic weights: 10 steps whose losses must be finite and
    fall; the launch counts of one step (6 attention, 6 + 6 dwconv, 18 fused
    LoFTR); ``steps_timed`` steps between CUDA events
    (``evaluate_time.train_latency_ms``, K = 5); one profiled step; the
    peak of allocated memory."""
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
    launches = {k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels.KERNELS}
    if launches != TRAIN_LAUNCHES:
        raise AssertionError(f"a train step launched {launches}, expected {TRAIN_LAUNCHES}")
    ms = train_latency_ms(lambda: train_step(state, batch, next(seeds)), steps_timed, 5)
    events = device_events(lambda: train_step(state, batch, next(seeds)))
    return dict(phase="train_step", batch=config.bs,
                size=[config.input_height, config.input_width], ms_a_step=ms,
                images_a_s=config.bs * 1000.0 / ms, steps_timed=steps_timed,
                losses_first_10=losses, launches_a_step=launches,
                max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                profiled_step=busy(events, ms), profiled_step_by_kind=by_kind(events))


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
    ptxas = {name: [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
             for name, log in build.BUILD_LOGS.items()}
    emit(dict(phase="build", seconds=time.perf_counter() - t0, per_source=seconds, ptxas=ptxas))

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
        out = evaluate.main([f"@{PROD_CONFIG}", "--dataset", "synthetic",
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

    # 10. the headline benchmark at reduced iterations (its own JSON line)
    if bench.main(["--iters", str(BENCH_ITERS), "--train_iters", str(BENCH_TRAIN_ITERS)]) != 0:
        raise AssertionError("cfpnet_torch.bench failed")
    emit(dict(phase="done", seconds_total=time.perf_counter() - t_start))

    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": gpu,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
