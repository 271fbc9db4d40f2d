"""A whole run of each kind of cell at a tiny size on the CPU, with the
harness's look for a card skipped (the CUDA graph replaced by the same
forward called eagerly, since a graph needs a card): sound, ``correct``
comes out true; with the timed path broken underneath in each way that the
cell can break, it comes out false."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import calibrate, run
from benchmark.families import cfpnet

TINY = dict(n_bins=16, native_height=64, native_width=96, eval_zone_num_cfg=2, eval_patch_px=16,
            input_height=48, input_width=64, train_zone_num=2, train_patch_px=16)
SEED = 2 ** 31 + 4242


def eager(alter=None):
    def capture(model, geoms, batch, config):
        @torch.no_grad()
        def forward(image, hist, mask):
            out = model(image, hist, mask, geoms)
            return out if alter is None else alter(out)

        return forward

    return capture


def one_run(capsys, workload):
    rc = run.main(["--workload", workload, "--seed", str(SEED), "--seconds", "0.5"],
                  device="cpu", tiny=True, overrides=TINY)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def scaled_depth(out):
    """An answer altered where it is produced: the depth map 10% deeper."""
    edges, pred, prob, extra = out
    return edges, pred * 1.1, prob, extra


@pytest.mark.parametrize("fault", [None, "altered answer"])
def test_frames(monkeypatch, capsys, fault):
    monkeypatch.setattr(cfpnet, "capture_forward", eager(scaled_depth if fault else None))
    result = one_run(capsys, "cfpnet.frame_bs1")
    assert result["correct"] is (fault is None), result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", [None, "state unchanged", "half batch"])
def test_train(monkeypatch, capsys, fault):
    from cfpnet_torch.train import optim

    if fault == "state unchanged":
        monkeypatch.setattr(optim.AdamW, "step", lambda self: None)
    if fault == "half batch":
        monkeypatch.setattr(cfpnet, "train_program", calibrate.half_batch(cfpnet.train_program))
    result = one_run(capsys, "cfpnet.train_bs16")
    assert result["correct"] is (fault is None), result["checks"]
