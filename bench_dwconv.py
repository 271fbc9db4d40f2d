#!/usr/bin/env python3
"""Time one kernel of several trees of this repo side by side on one card.

    python3 bench_dwconv.py --tree parent=DIR --tree new=. --order parent,new,new,parent
    python3 bench_dwconv.py --kernel linear_attention --tree parent=DIR --tree new=.

Each ``--tree LABEL=DIR`` is a checkout of the repo (``.``, or a commit
unpacked by ``git archive``). Its ``cfpnet_torch`` package is imported under
a name of its own, so each tree runs its own wrapper, which builds that
tree's source into that tree's ``cfpnet_torch/_build/``; the builds run at
once. The trees run in the order ``--order`` gives (labels may repeat:
parent, change, change, parent) at the kernel's three main-path shapes,
timed by ``chip_smoke.device_ms`` against ``chip_smoke.bound_fields`` and
held against this tree's plain version:

- ``dwconv`` (the default): ``kernels/dwconv.py::depthwise_conv2d`` at k=31
  on 120x160x32, k=15 on 60x80x64, k=7 on 30x40x128, bs=1;
- ``linear_attention``: ``kernels/linear_attention.py::linear_attention``
  at the three ``LoFTRNewCross9`` calls (N, L, S, H, D) = (1, 1200, 784, 4,
  32), (1, 4800, 3136, 4, 16), (1, 19200, 12544, 4, 8); each line also
  carries the device kernels of one call by name (``chip_smoke.kernel_split``,
  torch.profiler) and, where the tree has one, its ``launch_plan``.

Prints the card's name and power limit, one JSON line per run and shape
(with the launches the tree's wrapper counted and whether the output is
within ``chip_smoke.TOL`` of the plain version) and last the per-forward ms
of each run (two calls of each shape a forward). A tree that computes
something else on purpose (a diagnostic copy) reports its error like any
other; correctness is ``chip_smoke.py``'s and the card tests' to decide.
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

from chip_smoke import SEED, TOL, bound_fields, device_ms, kernel_split
from cfpnet_torch.ops.attention import linear_attention as attention_plain
from cfpnet_torch.ops.dwconv import depthwise_conv2d as dwconv_plain

CALLS_PER_FORWARD = 2


def _dwconv_inputs(shape, gen):
    B, H, W, C, k = shape
    x = torch.randn(B, H, W, C, device="cuda", generator=gen)
    w = 0.05 * torch.randn(C, 1, k, k, device="cuda", generator=gen)
    b = torch.randn(C, device="cuda", generator=gen)
    return x, w, b


def _dwconv_bound(shape):
    B, H, W, C, k = shape
    return bound_fields(4 * (2 * B * H * W * C + C * k * k + C), 2 * k * k * B * H * W * C)


def _attention_inputs(shape, gen):
    N, L, S, H, D = shape
    return tuple(torch.randn(N, n, H, D, device="cuda", generator=gen) for n in (L, S, S))


def _attention_bound(shape):
    N, L, S, H, D = shape
    C = H * D
    return bound_fields(4 * (2 * N * L * C + 2 * N * S * C),
                        N * H * (2 * S * D * D + S * D + 2 * L * D * D + 2 * L * D))


# kernel: (module name in kernels/, wrapper, shapes, inputs, plain version, bound)
KERNELS = {
    "dwconv": ("dwconv", "depthwise_conv2d",
               ((1, 120, 160, 32, 31), (1, 60, 80, 64, 15), (1, 30, 40, 128, 7)),
               _dwconv_inputs, dwconv_plain, _dwconv_bound),
    "linear_attention": ("linear_attention", "linear_attention",
                         ((1, 1200, 784, 4, 32), (1, 4800, 3136, 4, 16), (1, 19200, 12544, 4, 8)),
                         _attention_inputs, attention_plain, _attention_bound),
}


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
    ap.add_argument("--kernel", default="dwconv", choices=sorted(KERNELS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_dwconv: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    source, wrapper, shapes, make_inputs, plain, bound_of = KERNELS[args.kernel]
    trees = dict(spec.split("=", 1) for spec in args.tree)
    kernels = {label: load_tree(label, root) for label, root in trees.items()}
    with ThreadPoolExecutor(len(kernels)) as pool:
        seconds = dict(zip(kernels, pool.map(lambda k: k.build.build([source])[source],
                                             kernels.values())))
    print(json.dumps(dict(build_seconds=seconds)), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    inputs = []
    for shape in shapes:
        args_in = make_inputs(shape, gen)
        inputs.append((args_in, plain(*args_in)))

    per_forward = {}
    with torch.no_grad():
        for run, label in enumerate(args.order.split(",") if args.order else trees):
            module = getattr(kernels[label], source)
            fn = getattr(module, wrapper)
            total = 0.0
            for shape, (args_in, ref) in zip(shapes, inputs):
                module.reset_launches()
                err = float((fn(*args_in) - ref).abs().max())
                scale = float(ref.abs().max())
                launches = module.launches
                ms = device_ms(lambda: fn(*args_in))
                bound = bound_of(shape)
                extra = {}
                if args.kernel == "linear_attention":
                    extra["device_kernels"] = kernel_split(lambda: fn(*args_in))
                    if hasattr(module, "launch_plan"):
                        extra["plan"] = dict(module.launch_plan(*shape))
                print(json.dumps(dict(run=run, tree=label, kernel=args.kernel, shape=shape,
                                      ms=ms, bound_ms=bound["bound_ms"],
                                      x_bound=ms / bound["bound_ms"], launches=launches,
                                      max_abs_err=err, max_abs_plain=scale,
                                      within_tol=err <= TOL * scale, **extra)), flush=True)
                total += CALLS_PER_FORWARD * ms
            per_forward.setdefault(label, []).append(total)
    print(json.dumps(dict(nvidia_smi=smi, kernel=args.kernel, per_forward_ms=per_forward)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
