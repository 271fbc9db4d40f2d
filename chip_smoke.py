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
   forward.
4. slice: the production model (configs/train_cfpnet_combine1.txt
   topology) at 480x640, bs=1, with the golden tests' deterministic
   weights, against ``tests/golden/full_forward.npz`` at that test's
   tolerance (rtol 5e-4, atol 5e-5); the launch counts of that forward must
   be 6 attention, 6 depthwise-conv and 18 fused-LoFTR launches.
5. entry: ``cfpnet_torch.evaluate`` on 4 synthetic images at bs=1 and
   bs=2; metrics must be finite; prints the bs=1 latency.
6. profile: device time of one bs=1 forward by kernel (torch.profiler),
   its kernel launches, and the device's busy share of the forward's
   latency.

Then the kernel table as one JSON line, and last the ``ok`` line.
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
PROD_CONFIG = os.path.join(ROOT, "configs", "train_cfpnet_combine1.txt")
TOL = 1e-4  # max |kernel - plain| / max |plain|
# published H100 SXM peaks: HBM bytes/s, f32 flop/s outside the tensor cores,
# and the TF32 tensor-core rate over three (a 3xTF32 product is three TF32 ones)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_TF32_3X = 495e12 / 3
SEED = 117010053


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
    """The production model (configs/train_cfpnet_combine1.txt topology), as
    tests/test_golden.py::test_golden_forward_production_size builds it."""
    from cfpnet_torch.config import Config

    return Config(n_bins=256, attention_layer=["hist2image", "combine1", "image",
                                               "hist2image", "combine1", "image"],
                  change_embedding=True, sample_uniform=True)


def main_path_shapes(config, geoms, batch: int = 1):
    """(attention, dwconv, LoFTR layer) shapes of one eval forward, with the
    number of calls at each: attention (N, L, S, H, D), dwconv (B, H, W, C,
    k), LoFTR layer (N, L, S, C, H). The attention inside a LoFTR layer is
    listed with 0 calls: the fused kernel computes it."""
    from cfpnet_torch.models.transformer import twins_window_size

    att, dw, loftr = {}, {}, {}

    def add(d, key, n=1):
        d[key] = d.get(key, 0) + n

    def add_loftr(N, L, S, C, H):
        add(loftr, (N, L, S, C, H))
        add(att, (N, L, S, H, C // H), 0)

    nh, nw = config.native_height, config.native_width
    for scale, C, k in ((16, 128, 7), (8, 64, 15), (4, 32, 31)):
        g = geoms[scale]
        H, W = nh // scale, nw // scale
        ws = twins_window_size(H, W)
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


def check_kernels(config, geoms):
    """Phase 3: every kernel at every main-path shape against its plain
    version; returns the per-kernel rows of the kernel table."""
    import torch.nn.functional as F

    from cfpnet_torch.kernels import dwconv, fused_loftr, linear_attention
    from cfpnet_torch.models.transformer import LoFTREncoderLayer
    from cfpnet_torch.ops.attention import linear_attention as att_plain
    from cfpnet_torch.ops.dwconv import depthwise_conv2d as dw_plain
    from cfpnet_torch.ops.loftr import loftr_apply

    att_shapes, dw_shapes, loftr_shapes = main_path_shapes(config, geoms)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    rows = []
    per_shape = []
    for (N, L, S, H, D), calls in sorted(att_shapes.items()):
        q, k, v = randn(N, L, H, D), randn(N, S, H, D), randn(N, S, H, D)
        got = linear_attention.linear_attention(q, k, v)
        ref = att_plain(q, k, v)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        if not (err <= TOL * scale):
            raise AssertionError(f"linear_attention {(N, L, S, H, D)}: max err {err} > "
                                 f"{TOL} * {scale}")
        C = H * D
        nbytes = 4 * (2 * N * L * C + 2 * N * S * C)
        flops = N * H * (2 * S * D * D + S * D + 2 * L * D * D + 2 * L * D)
        plan = linear_attention.launch_plan(N, L, S, H, D)
        split = kernel_split(lambda: linear_attention.linear_attention(q, k, v))
        per_shape.append(dict(
            kernel="linear_attention", shape=dict(N=N, L=L, S=S, H=H, D=D), calls=calls,
            plan={key: plan[key] for key in (
                "cl", "g", "tk", "chunk", "slices", "sum_threads", "sum_blocks", "sum_smem",
                "tl", "apply_threads", "apply_blocks", "apply_blocks_per_sm", "apply_waves",
                "apply_smem")},
            device_kernels_a_call=sum(s["launches"] for s in split.values()),
            device_kernels={name.replace("(anonymous namespace)::", "").split("(")[0]: s
                            for name, s in split.items()},
            max_abs_err=err, max_abs_plain=scale,
            ms=device_ms(lambda: linear_attention.linear_attention(q, k, v)),
            plain_ms=device_ms(lambda: att_plain(q, k, v)),
            library_ms=None, **bound_fields(nbytes, flops)))
    for (B, H, W, C, kk), calls in sorted(dw_shapes.items()):
        x, w, bias = randn(B, H, W, C), 0.05 * randn(C, 1, kk, kk), randn(C)
        got = dwconv.depthwise_conv2d(x, w, bias)
        ref = dw_plain(x, w, bias)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        if not (err <= TOL * scale):
            raise AssertionError(f"dwconv {(B, H, W, C, kk)}: max err {err} > {TOL} * {scale}")
        nbytes = 4 * (2 * B * H * W * C + C * kk * kk + C)
        flops = 2 * kk * kk * B * H * W * C
        x_nchw = x.permute(0, 3, 1, 2)  # the same memory, as cuDNN's channels-last input
        plan = dwconv.launch_plan(B, H, W, C, kk)
        per_shape.append(dict(
            kernel="dwconv", shape=dict(B=B, H=H, W=W, C=C, k=kk), calls=calls,
            plan={key: plan[key] for key in ("tile", "threads", "blocks", "blocks_per_sm",
                                             "waves", "smem_bytes")},
            max_abs_err=err, max_abs_plain=scale,
            ms=device_ms(lambda: dwconv.depthwise_conv2d(x, w, bias)),
            plain_ms=device_ms(lambda: dw_plain(x, w, bias), reps=2, trials=3),
            library_ms=device_ms(lambda: F.conv2d(x_nchw, w, bias, padding=kk // 2, groups=C)),
            **bound_fields(nbytes, flops)))
    rng = np.random.default_rng(SEED)
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
            got = fused_loftr.fused_loftr(x, src, p, H)
            ref = loftr_apply(x, src, p, H)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            if not (err <= TOL * scale):
                raise AssertionError(f"fused_loftr {(N, L, S, C, H)}: max err {err} > "
                                     f"{TOL} * {scale}")
            D = C // H
            nbytes = 4 * (2 * N * L * C + N * S * C + 10 * C * C + 4 * C)
            flops = 2 * (N * L * 8 * C * C + N * S * 2 * C * C + N * H * (S + L) * D * D)
            per_shape.append(dict(
                kernel="fused_loftr", shape=dict(N=N, L=L, S=S, C=C, H=H), calls=calls,
                max_abs_err=err, max_abs_plain=scale,
                ms=device_ms(lambda: fused_loftr.fused_loftr(x, src, p, H)),
                **pass_split(lambda: fused_loftr.fused_loftr(x, src, p, H)),
                plain_ms=device_ms(lambda: loftr_apply(x, src, p, H)),
                unfused_ms=device_ms(lambda: layer.modules_forward(x, src)),
                library_ms=None, **bound_fields(nbytes, flops),
                bound_tc_ms=max(nbytes / PEAK_BYTES, flops / PEAK_TF32_3X) * 1e3))
    for r in per_shape:
        emit(dict(phase="kernel_shape", **r))

    meta = {
        "linear_attention": ("cfpnet_torch/csrc/linear_attention.cu",
                             "cfpnet_tpu/ops/pallas_attention.py:109"),
        "dwconv": ("cfpnet_torch/csrc/dwconv.cu", "cfpnet_tpu/ops/pallas_dwconv.py:41"),
        "fused_loftr": ("cfpnet_torch/csrc/fused_loftr.cu",
                        "cfpnet_tpu/ops/pallas_loftr.py:156"),
    }
    for name, (source, replaces) in meta.items():
        mine = [r for r in per_shape if r["kernel"] == name]

        def per_forward(key):
            if any(r[key] is None for r in mine):
                return None
            return sum(r["calls"] * r[key] for r in mine)

        extra = {}
        if name == "fused_loftr":
            extra = {key: per_forward(key)
                     for key in ("summary_ms", "rows_ms", "unfused_ms", "bound_tc_ms")}
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=None,
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=per_forward("ms"), plain_ms=per_forward("plain_ms"),
            bound_ms=per_forward("bound_ms"),
            bound_by="bytes" if per_forward("bytes_ms") >= per_forward("ops_ms") else "operations",
            library_ms=per_forward("library_ms"),
            calls_per_forward=sum(r["calls"] for r in mine), **extra))
    return rows


def profile_forward(model, args, geoms, latency_ms: float):
    """Device time of one bs=1 forward by kernel (torch.profiler, CUPTI),
    against the forward's unprofiled latency: the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        for _ in range(3):
            model(*args, geoms)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model(*args, geoms)
            torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in device)
    if total_us <= 0:
        return dict(phase="profile", device_ms="not measured (the profiler saw no device time)")
    top = sorted(device, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    return dict(phase="profile", device_ms=total_us / 1e3,
                kernel_launches=sum(e.count for e in device), latency_ms=latency_ms,
                busy_share=total_us / 1e3 / latency_ms,
                top=[dict(name=e.key[:80], calls=e.count, ms=e.self_device_time_total / 1e3)
                     for e in top])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a GPU", file=sys.stderr)
        return 2

    from cfpnet_torch import evaluate, kernels, weights
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

    # 3. kernels at every main-path shape; the configuration and inputs of
    # tests/test_golden.py::test_golden_forward_production_size
    config = production_config()
    geoms = model_geometries(config, "online_eval")
    rows = check_kernels(config, geoms)

    # 4. slice: the full-width forward through the kernels, against the golden
    model = make_model(config, device="cuda")
    model.load_state_dict(weights.deterministic_state_dict(config), strict=True)
    img = torch.from_numpy(weights.det_leaf("img", (1, 480, 640, 3))).cuda()
    hist = torch.from_numpy(np.abs(weights.det_leaf("hist", (1, 64, 16))) * 20).cuda()
    mask = torch.ones((1, 64), dtype=torch.bool, device="cuda")
    kernels.reset_launches()
    with torch.no_grad():
        bin_edges, pred, prob, _ = model(img, hist, mask, geoms)
    torch.cuda.synchronize()
    launches = {k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels.KERNELS}
    if launches != {"linear_attention": 6, "dwconv": 6, "fused_loftr": 18}:
        raise AssertionError(f"main path launched {launches}, expected 6 attention, "
                             "6 dwconv and 18 fused LoFTR launches")
    for r in rows:
        r["launches"] = launches[r["name"]]
    if tuple(pred.shape) != (1, 240, 320, 1) or tuple(prob.shape) != (1, 240, 320, 256):
        raise AssertionError(f"pred {tuple(pred.shape)}, prob {tuple(prob.shape)}")
    if not (torch.isfinite(pred).all() and torch.isfinite(prob).all()):
        raise AssertionError("non-finite forward output")
    ref = np.load(GOLDEN_FULL)
    got = dict(pred_slice=pred.cpu().numpy()[0, ::16, ::16, 0],
               bin_edges16=bin_edges.cpu().numpy()[0, ::16],
               pred_mean=pred.mean().cpu().numpy()[None])
    golden = {}
    for key, val in got.items():
        np.testing.assert_allclose(val, ref[key], rtol=5e-4, atol=5e-5,
                                   err_msg=f"full-size golden mismatch in {key}")
        golden[key] = float(np.abs(val - ref[key]).max())
    emit(dict(phase="slice", launches=launches, golden_max_abs_diff=golden,
              pred_mean=float(got["pred_mean"][0])))

    # 5. entry: the eval entry point on synthetic images
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
              metrics_bs1=entry["bs1"]["metrics"], metrics_bs2=entry["bs2"]["metrics"]))

    # 6. where the time of the bs=1 forward goes on the device
    emit(profile_forward(model, (img, hist, mask), geoms, entry["bs1"]["latency_ms_bs1"]))
    emit(dict(phase="done", seconds_total=time.perf_counter() - t_start))

    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": gpu,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
