#!/usr/bin/env python3
"""Time one kernel of several trees of this repo side by side on one card.

    python3 bench_dwconv.py --tree parent=DIR --tree new=. --order parent,new,new,parent
    python3 bench_dwconv.py --kernel linear_attention --tree parent=DIR --tree new=.
    python3 bench_dwconv.py --kernel fused_loftr --dtype bfloat16 --tree parent=DIR --tree new=.

Each ``--tree LABEL=DIR`` is a checkout of the repo (``.``, or a commit
unpacked by ``git archive``). Its ``cfpnet_torch`` package is imported under
a name of its own, so each tree runs its own wrapper (registering its op
again before each run), which builds that tree's source into that tree's
``cfpnet_torch/_build/``; the builds run at once. The trees run in the
order ``--order`` gives (labels may repeat: parent, change, change,
parent) at the kernel's main-path shapes, on inputs of ``--dtype``
(float32, or bfloat16 for the kernels' bf16 variants), each call timed
alone (``device_ms``: CUDA events) against the benchmark's least time for
it (``benchmark/reference/counters.py::least_ms``, the bound the cells'
``dwconv_roofline`` and ``fused_loftr_roofline`` read) and held against
this tree's plain version:

- ``dwconv`` (the default): ``kernels/dwconv.py::depthwise_conv2d`` at k=31
  on 120x160x32, k=15 on 60x80x64, k=7 on 30x40x128, bs=1;
- ``linear_attention``: ``kernels/linear_attention.py::linear_attention``
  at the three ``LoFTRNewCross9`` calls (N, L, S, H, D) = (1, 1200, 784, 4,
  32), (1, 4800, 3136, 4, 16), (1, 19200, 12544, 4, 8); each line also
  carries the device kernels of one call by name (``kernel_split``,
  torch.profiler) and, where the tree has one, its ``launch_plan``;
- ``fused_loftr``: ``kernels/fused_loftr.py::fused_loftr`` at the nine
  shapes of the bs=1 forward and the nine of the bs=8 forward
  (``chip_smoke.main_path_shapes``), weights of std 0.1 as in
  ``chip_smoke.py``'s phases 3 and 11; each line also carries the call's
  two device kernels, ``summary_ms`` and ``rows_ms`` (``pass_split``,
  torch.profiler), and, where the tree has one, its ``launch_plan``. The
  bound takes the products at the dense bf16 tensor-core rate in bfloat16
  and at the 3xTF32 rate (TF32 over three) in float32. With ``--sweep``
  each bf16 line also times the call under every row variant the tree
  builds (``kernels/fused_loftr.py::ROW_VARIANTS_BF16``) and under 1, 2, 4
  and 8 groups a summary block, the rest of the plan as ``launch_plan``
  makes it (``sweep_ms``; each held against the plain version like the
  call).

Prints the card's name and power limit, one JSON line per run and shape
(with the launches the tree's counters counted and whether the output is
within ``chip_smoke.TOL``, or ``chip_smoke.BF16_TOL`` in bfloat16, of the
plain version) and last the per-forward ms of each run at each batch size
(two calls of each shape a forward). A tree that computes something else
on purpose (a diagnostic copy) reports its error like any other;
correctness is ``chip_smoke.py``'s and the card tests' to decide. This is
the one place that times a kernel alone; the benchmark times the cells
end to end.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import numpy as np

from benchmark import peaks
from benchmark.reference.counters import bytes_and_ops, least_ms
from chip_smoke import BF16_TOL, SEED, TOL, main_path_shapes, production_config
from cfpnet_torch.ops.attention import linear_attention as attention_plain
from cfpnet_torch.ops.dwconv import depthwise_conv2d as dwconv_plain
from cfpnet_torch.ops.loftr import LoFTRParams, loftr_apply

CALLS_PER_FORWARD = 2


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


def bound(kernel: str, shape, dtype: torch.dtype):
    """The benchmark's least time of one call (``counters.least_ms``) and
    what bounds it: its bytes at the memory rate, or its operations."""
    least = least_ms(kernel, shape, str(dtype).replace("torch.", ""))
    nbytes, _ = bytes_and_ops(kernel, shape, dtype.itemsize)
    return least, "bytes" if 1e3 * nbytes / peaks.BYTES >= least else "operations"


def _dwconv_inputs(shape, gen, dtype):
    B, H, W, C, k = shape
    x = torch.randn(B, H, W, C, device="cuda", generator=gen)
    w = 0.05 * torch.randn(C, 1, k, k, device="cuda", generator=gen)
    b = torch.randn(C, device="cuda", generator=gen)
    return x.to(dtype), w.to(dtype), b.to(dtype)


def _attention_inputs(shape, gen, dtype):
    N, L, S, H, D = shape
    return tuple(torch.randn(N, n, H, D, device="cuda", generator=gen).to(dtype)
                 for n in (L, S, S))


def _loftr_inputs(shape, gen, dtype):
    """x, source, the layer's weights (as ``LoFTREncoderLayer.loftr_params``
    hands them over: [in, out] views of [out, in] storage) and the head
    count; numpy-seeded, std 0.1 with the LayerNorm scales around 1."""
    N, L, S, C, H = shape
    rng = np.random.default_rng(SEED + N * L)

    def normal(*dims, mean=0.0, std=1.0):
        a = (mean + std * rng.standard_normal(dims)).astype(np.float32)
        return torch.from_numpy(a).cuda().to(dtype)

    x, src = normal(N, L, C), normal(N, S, C)
    stored = dict(wq=(C, C), wk=(C, C), wv=(C, C), wm=(C, C), g1=(C,), b1=(C,),
                  w0=(2 * C, 2 * C), w1=(C, 2 * C), g2=(C,), b2=(C,))
    p = {k: normal(*dims, mean=1.0 if k in ("g1", "g2") else 0.0, std=0.1)
         for k, dims in stored.items()}
    return x, src, LoFTRParams(**{k: v.t() if v.dim() == 2 else v for k, v in p.items()}), H


def _loftr_shapes():
    from cfpnet_torch.models.deltar import model_geometries

    config = production_config()
    geoms = model_geometries(config, "online_eval")
    return tuple((batch, shape) for batch in (1, 8)
                 for shape in sorted(main_path_shapes(config, geoms, batch)[2]))


# kernel: (module name in kernels/, wrapper, (batch, shape) pairs, inputs, plain version)
KERNELS = {
    "dwconv": ("dwconv", "depthwise_conv2d",
               tuple((1, s) for s in ((1, 120, 160, 32, 31), (1, 60, 80, 64, 15),
                                      (1, 30, 40, 128, 7))),
               _dwconv_inputs, dwconv_plain),
    "linear_attention": ("linear_attention", "linear_attention",
                         tuple((1, s) for s in ((1, 1200, 784, 4, 32), (1, 4800, 3136, 4, 16),
                                                (1, 19200, 12544, 4, 8))),
                         _attention_inputs, attention_plain),
    "fused_loftr": ("fused_loftr", "fused_loftr", None, _loftr_inputs, loftr_apply),
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@contextlib.contextmanager
def _plan(module, plan):
    """The tree's wrapper launching with ``plan`` instead of its own."""
    own = module.launch_plan
    module.launch_plan = lambda *args: plan
    try:
        yield
    finally:
        module.launch_plan = own


def _sweep(module, fn, args_in, shape, ref, tol):
    """ms of one bf16 fused-layer call under each row variant and each count
    of summary groups a block, keyed "tm<rows>_cl<cluster>" and
    "groups<g>"."""
    N, L, S, C, H = shape
    base = dict(module.launch_plan(*shape, torch.bfloat16))
    plans = {}
    for tm, cl in module.ROW_VARIANTS_BF16[C]:
        resident = module._row_units(C, C // H, tm, cl, torch.bfloat16)[2]
        units = min(resident, -(-N * L // tm))
        plans[f"tm{tm}_cl{cl}"] = dict(base, tm=tm, cl=cl, units=units)
    if base["sum_split"] == 1:
        hg = C // max(C // H, 16)
        for g in (1, 2, 4, 8):
            plans[f"groups{g}"] = dict(base, sum_groups=g, sum_blocks=hg * -(-N // g))
    out = {}
    for key, plan in plans.items():
        with _plan(module, plan):
            err = float((fn(*args_in).float() - ref).abs().max())
            if not err <= tol * float(ref.abs().max()):
                raise AssertionError(f"{shape} under {key}: max err {err}")
            out[key] = device_ms(lambda: fn(*args_in))
    return out


def load_tree(label: str, root: str):
    """``root``'s ``cfpnet_torch`` package, imported as ``_tree_<label>``,
    with its ``kernels`` and ``tracing`` modules loaded."""
    pkg = Path(root, "cfpnet_torch").resolve()
    name = f"_tree_{label}"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    importlib.import_module(f"{name}.kernels")
    return module


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True, help="LABEL=DIR, a checkout")
    ap.add_argument("--order", default=None, help="comma-separated labels (default: as given)")
    ap.add_argument("--kernel", default="dwconv", choices=sorted(KERNELS))
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--sweep", action="store_true",
                    help="fused_loftr in bfloat16: also time every row variant and summary split")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_dwconv: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    source, wrapper, shapes, make_inputs, plain = KERNELS[args.kernel]
    shapes = shapes or _loftr_shapes()
    dtype = DTYPES[args.dtype]
    tol = BF16_TOL if dtype == torch.bfloat16 else TOL
    trees = dict(spec.split("=", 1) for spec in args.tree)
    packages = {label: load_tree(label, root) for label, root in trees.items()}

    def build(package):  # the kernel's sources in the tree (fused_loftr may have a bf16 file)
        names = [n for n in package.kernels.build.SOURCES if n.startswith(source)]
        return sum(package.kernels.build.build(names).values())

    with ThreadPoolExecutor(len(packages)) as pool:
        seconds = dict(zip(packages, pool.map(build, packages.values())))
    print(json.dumps(dict(build_seconds=seconds)), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    inputs = []
    with torch.no_grad():
        for batch, shape in shapes:
            args_in = make_inputs(shape, gen, dtype)
            inputs.append((args_in, plain(*args_in).float()))

    per_forward = {}
    with torch.no_grad():
        for run, label in enumerate(args.order.split(",") if args.order else trees):
            # every tree registers its kernel as the same torch.library op, and
            # the last registration is the one that runs: re-run the tree's
            # wrapper module so that its op is the registered one
            module = importlib.reload(getattr(packages[label].kernels, source))
            tracing = packages[label].tracing
            fn = getattr(module, wrapper)
            totals = {}
            for (batch, shape), (args_in, ref) in zip(shapes, inputs):
                tracing.reset_counters("kernel.")
                err = float((fn(*args_in).float() - ref).abs().max())
                scale = float(ref.abs().max())
                launches = sum(tracing.counters(f"kernel.{source}.launches.").values())
                ms = device_ms(lambda: fn(*args_in))
                bound_ms, bound_by = bound(source, shape, dtype)
                extra = {}
                if args.kernel == "linear_attention":
                    extra["device_kernels"] = kernel_split(lambda: fn(*args_in))
                if args.kernel == "fused_loftr":
                    extra.update(pass_split(lambda: fn(*args_in)))
                    if (args.sweep and dtype == torch.bfloat16
                            and hasattr(module, "ROW_VARIANTS_BF16")):
                        extra["sweep_ms"] = _sweep(module, fn, args_in, shape, ref, tol)
                if hasattr(module, "launch_plan"):
                    plan_args = shape + ((dtype,) if args.kernel == "fused_loftr" else ())
                    extra["plan"] = dict(module.launch_plan(*plan_args))
                print(json.dumps(dict(run=run, tree=label, kernel=args.kernel, dtype=args.dtype,
                                      batch=batch, shape=shape, ms=ms, bound_ms=bound_ms,
                                      bound_by=bound_by, x_bound=ms / bound_ms,
                                      launches=launches, max_abs_err=err, max_abs_plain=scale,
                                      within_tol=err <= tol * scale, **extra)), flush=True)
                key = f"bs{batch}"
                totals[key] = totals.get(key, 0.0) + CALLS_PER_FORWARD * ms
            for key, total in totals.items():
                per_forward.setdefault(key, {}).setdefault(label, []).append(total)
    print(json.dumps(dict(nvidia_smi=smi, kernel=args.kernel, dtype=args.dtype,
                          per_forward_ms=per_forward)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
