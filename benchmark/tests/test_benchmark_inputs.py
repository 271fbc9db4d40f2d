"""The generator of the benchmark's inputs: the same seed gives the same
frames, different frames and seeds differ, and its zone histograms are those
of the system under test's ToF simulation."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark import inputs

HERE = Path(__file__).resolve().parents[1]
SETTINGS = json.loads((HERE / "configs" / "cfpnet_combine1.json").read_text())["settings"]
SMALL = dict(SETTINGS, native_height=128, native_width=160, eval_zone_num_cfg=4,
             eval_patch_px=24, input_height=96, input_width=128, train_zone_num=2,
             train_patch_px=32)
SEED = 2 ** 31 + 12345


@pytest.mark.parametrize("mode", ["online_eval", "train"])
def test_deterministic_per_seed(mode):
    a, b = inputs.make(SMALL, mode, 6, SEED), inputs.make(SMALL, mode, 6, SEED)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    c = inputs.make(SMALL, mode, 6, SEED + 1)
    assert not np.array_equal(a["image"], c["image"])


@pytest.mark.parametrize("mode", ["online_eval", "train"])
def test_frames_are_distinct(mode):
    d = inputs.make(SMALL, mode, 8, SEED)
    flat = d["image"].reshape(8, -1)
    assert len({f.tobytes() for f in flat}) == 8
    assert len({h.tobytes() for h in d["hist_data"]}) == 8
    assert d["mask"].any(axis=1).all()


def test_shapes_do_not_depend_on_the_seed():
    a, b = inputs.make(SMALL, "train", 4, 1), inputs.make(SMALL, "train", 4, 2 ** 40)
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in b.items()}


def test_histograms_match_the_tof_simulation():
    from cfpnet_torch.data import tof_sim
    from cfpnet_torch.data.geometry import ZoneGeometry

    d = inputs.make(SMALL, "online_eval", 4, SEED)
    geom = ZoneGeometry(128, 160, 4, 24, 24)
    for f in range(4):
        fh, _, mask = tof_sim.get_hist(d["depth"][f, ..., 0], geom, SMALL["simu_max_distance"])
        pts = tof_sim.sample_points(fh, mask, SMALL["zone_sample_num"], True)
        np.testing.assert_array_equal(mask, d["mask"][f])
        np.testing.assert_allclose(pts, d["hist_data"][f], rtol=0, atol=1e-5)
