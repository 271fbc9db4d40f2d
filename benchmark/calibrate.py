"""Readings that the limits of a cell's output check are set from.

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,3 --seconds 2 \\
        [--control] [--fault half_batch]

For each seed, in one process: the cell's set-up, a short window at its own
load and its output check, printing one JSON line with the gaps of the
system under test (``program``) and, with ``--control``, of the reference
put in its place in the precision below the cell's (``control``:
``reference/precision.py::CONTROL``). ``--fault half_batch`` plants a
fault in the train step that the cell's family builds
(``family.train_program``): it steps on the first half of each batch only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from . import drivers
from .reference import precision
from .spec import Spec


def half_batch(train_program):
    """``train_program`` whose step sees the first half of each batch only."""
    def program(*args, **kwargs):
        model, opt_state, step = train_program(*args, **kwargs)

        def half(state, batch, seed):
            return step(state, {k: v[:v.shape[0] // 2] for k, v in batch.items()}, seed)

        return model, opt_state, half

    return program


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=("half_batch",))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibration needs a CUDA card", file=sys.stderr)
        return 2
    spec = Spec(Path.cwd() / "BENCHMARK.json")
    cell = spec.cell(args.workload)
    settings, traffic = spec.config(cell)["settings"], spec.traffic(cell)
    family = spec.family(cell)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.fault == "half_batch":
        family.train_program = half_batch(family.train_program)
    control = precision.CONTROL[traffic["dtype"]] if args.control else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        driver = drivers.DRIVERS[traffic["driver"]](family, settings, traffic, seed)
        window = driver.window(args.seconds)
        program, ctl = driver.check(control)
        print(json.dumps(dict(workload=cell["name"], seed=seed, fault=args.fault,
                              attempted=window["attempted"], program=program, control=ctl,
                              seconds=time.perf_counter() - t0)), flush=True)
        del driver
        drivers.free("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
