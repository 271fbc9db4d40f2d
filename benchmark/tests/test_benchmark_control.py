"""The controls of the output checks, on the card, at the published widths and
a small frame: the reference put in the system's place in the precision
below the cell's (fp8 products for a bf16 cell, TF32 for a float32 one) has
to come out over the cell's limits, on three seeds."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmark import drivers
from benchmark.reference import precision
from benchmark.spec import Spec

ROOT = Path(__file__).resolve().parents[2]
SMALL = dict(native_height=128, native_width=160, eval_zone_num_cfg=4, eval_patch_px=24,
             input_height=96, input_width=128, train_zone_num=2, train_patch_px=32)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["cfpnet.frame_bs1", "deltar.frame_bs1", "cfpnet.train_bs16"])
@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
def test_control_fails(workload, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cfpnet_torch.kernels import build

    build.build()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    spec = Spec(ROOT / "BENCHMARK.json")
    cell = spec.cell(workload)
    traffic, limits = spec.traffic(cell), spec.limits(cell)
    settings = dict(spec.config(cell)["settings"], **SMALL)
    driver = drivers.DRIVERS[traffic["driver"]](spec.family(cell), settings,
                                                dict(traffic, pool=4, warmup=2), seed)
    driver.window(0.5)
    program, control = driver.check(precision.CONTROL[traffic["dtype"]])
    print(json.dumps(dict(workload=workload, seed=seed, program=program, control=control)))
    assert any(control[k] > v for k, v in limits.items()), (control, limits)
