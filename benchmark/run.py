"""Runs one cell of the benchmark once and prints its result.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration, its model family,
traffic mix, limits and per-layer readers are found by name (``spec.py``).
The run builds the system under test (``cfpnet_torch``) and warms it up (``setup_s``, from the
start of this module), measures for ``--seconds`` (``--trace 0``: the cell's
end-to-end metrics), or measures and then profiles the mix's traced items
(``--trace 1``: its per-layer metrics), reads the peak of device memory,
frees the system and holds the window's outputs against the reference
(``correct``). The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each number compared
beside its limit; the same numbers end standard error.

Exits 2 without a result where CUDA is missing or has fewer cards than the
cell asks for, and 3 where a JAX module was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import torch  # noqa: E402

from . import drivers, trace  # noqa: E402
from .spec import Spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cfpnet_tpu")
TRACE_ATTEMPTS = 3  # a profiler session now and then misses a kernel


def leaked_modules():
    """Top-level names of loaded modules that belong to JAX or its package."""
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None, device="cuda", tiny=False, overrides=None) -> int:
    """One run; returns the exit code. ``device``, ``tiny`` (the family's
    test widths) and ``overrides`` (settings replaced) let the tests drive a
    run at a small size on the CPU."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = Spec(Path.cwd() / "BENCHMARK.json")
    cell = spec.cell(args.workload)
    cuda = torch.device(device).type == "cuda"
    if cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    config, traffic, limits = spec.config(cell), spec.traffic(cell), spec.limits(cell)
    family = spec.family(cell)
    settings = dict(config["settings"], **(overrides or {}))
    if cuda:
        from cfpnet_torch.kernels import build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.build()
    driver = drivers.DRIVERS[traffic["driver"]](family, settings, traffic, args.seed, device,
                                                tiny)
    setup_s = time.perf_counter() - T0
    print(f"setup_s {setup_s!r}: {json.dumps(driver.phases)}", file=sys.stderr)
    window = driver.window(args.seconds)
    if cuda:
        print(card_line(), file=sys.stderr)
    metrics, breakdown, dev = {}, None, {}
    if args.trace:
        readers = [(m, spec.reader(m)) for m in spec.per_layer(cell)]
        flops, calls = family.work(settings, traffic)
        for _ in range(TRACE_ATTEMPTS):
            tr = trace.capture(driver.traced)
            run = SimpleNamespace(trace=tr, rate=window["rate"], traffic=traffic,
                                  settings=settings, flops=flops, calls=calls)
            values = {m["name"]: (m, r(run)) for m, r in readers}
            if all(v is not None for _, v in values.values()):
                break
        metrics = {name: {"value": v, "unit": m["unit"]} for name, (m, v) in values.items()
                   if v is not None}
        breakdown = dict(device_ops=tr.device_ops, idle_gaps=tr.idle_gaps)
        dev = dict(busy_s=tr.busy_s, window_s=tr.window_s)
    else:
        values = dict(window, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end(cell)}
    device_info = dict(platform="gpu" if cuda else "cpu",
                       kind=torch.cuda.get_device_name() if cuda else "cpu",
                       count=cell["chips"],
                       memory_peak_bytes=torch.cuda.max_memory_allocated() if cuda else 0, **dev)
    gaps, _ = driver.check()
    checks = {name: {"value": gaps[name], "limit": limit} for name, limit in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    leaked = leaked_modules()
    if leaked:
        print(f"modules of JAX or its package were loaded: {leaked}", file=sys.stderr)
        return 3
    result = dict(correct=correct, attempted=window["attempted"], failed=window["failed"],
                  metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
