#!/usr/bin/env python3
"""Time the depthwise-conv kernel of several trees of this repo side by side
on one card.

    python3 bench_dwconv.py --tree parent=DIR --tree new=. --order parent,new,new,parent

Each ``--tree LABEL=DIR`` is a checkout of the repo (``.``, or a commit
unpacked by ``git archive``). Its ``cfpnet_torch`` package is imported under
a name of its own, so each tree runs its own wrapper
(``kernels/dwconv.py::depthwise_conv2d``), which builds that tree's
``csrc/dwconv.cu`` into that tree's ``cfpnet_torch/_build/``; the builds
run at once. The trees run in the order ``--order`` gives (labels may
repeat: parent, change, change, parent) at the three main-path shapes (k=31
at 120x160x32, k=15 at 60x80x64, k=7 at 30x40x128, bs=1), timed by
``chip_smoke.device_ms`` against ``chip_smoke.bound_fields`` and held
against this tree's plain version.

Prints the card's name and power limit, one JSON line per run and shape
(with the launches the tree's wrapper counted and whether the output is
within ``chip_smoke.TOL`` of the plain version) and last the per-forward ms
of each run (two calls of each shape a forward). A tree that computes
something else on purpose (a diagnostic copy that only stages, or only runs
its taps) reports its error like any other; correctness is ``chip_smoke.py``'s
and the card tests' to decide.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from chip_smoke import SEED, TOL, bound_fields, device_ms
from cfpnet_torch.ops.dwconv import depthwise_conv2d as dwconv_plain

SHAPES = ((1, 120, 160, 32, 31), (1, 60, 80, 64, 15), (1, 30, 40, 128, 7))
CALLS_PER_FORWARD = 2


def load_tree(label: str, root: str):
    """``root``'s ``cfpnet_torch.kernels`` package, imported as
    ``_tree_<label>.kernels``."""
    pkg = Path(root, "cfpnet_torch").resolve()
    name = f"_tree_{label}"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{name}.kernels")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True, help="LABEL=DIR, a checkout")
    ap.add_argument("--order", default=None, help="comma-separated labels (default: as given)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_dwconv: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    trees = dict(spec.split("=", 1) for spec in args.tree)
    kernels = {label: load_tree(label, root) for label, root in trees.items()}
    with ThreadPoolExecutor(len(kernels)) as pool:
        seconds = dict(zip(kernels, pool.map(lambda k: k.build.build(["dwconv"])["dwconv"],
                                             kernels.values())))
    print(json.dumps(dict(build_seconds=seconds)), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    inputs = []
    for B, H, W, C, k in SHAPES:
        x = torch.randn(B, H, W, C, device="cuda", generator=gen)
        w = 0.05 * torch.randn(C, 1, k, k, device="cuda", generator=gen)
        b = torch.randn(C, device="cuda", generator=gen)
        inputs.append((x, w, b, dwconv_plain(x, w, b)))

    per_forward = {}
    with torch.no_grad():
        for run, label in enumerate(args.order.split(",") if args.order else trees):
            dwconv = kernels[label].dwconv
            total = 0.0
            for (B, H, W, C, k), (x, w, b, ref) in zip(SHAPES, inputs):
                dwconv.reset_launches()
                err = float((dwconv.depthwise_conv2d(x, w, b) - ref).abs().max())
                scale = float(ref.abs().max())
                launches = dwconv.launches
                ms = device_ms(lambda: dwconv.depthwise_conv2d(x, w, b))
                bound = bound_fields(4 * (2 * B * H * W * C + C * k * k + C),
                                     2 * k * k * B * H * W * C)
                print(json.dumps(dict(run=run, tree=label, shape=dict(B=B, H=H, W=W, C=C, k=k),
                                      ms=ms, bound_ms=bound["bound_ms"],
                                      x_bound=ms / bound["bound_ms"], launches=launches,
                                      max_abs_err=err, max_abs_plain=scale,
                                      within_tol=err <= TOL * scale)), flush=True)
                total += CALLS_PER_FORWARD * ms
            per_forward.setdefault(label, []).append(total)
    print(json.dumps(dict(nvidia_smi=smi, per_forward_ms=per_forward)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
