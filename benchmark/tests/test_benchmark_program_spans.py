"""The readers of the port's spans (``graph_host_ms.infer`` and the three
``*_host_ms.train``): on hand-built spans, the median of the graph calls
without their replays and each phase's mean a step, over the last traced
attempt's items only; nothing without spans or without the port's tracing
module (a parent commit); and on the CPU, the train cell's traced steps
under torch.profiler at a tiny size."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cfpnet_torch
from benchmark import drivers
from benchmark.families import cfpnet
from benchmark.spec import Spec
from cfpnet_torch import tracing

ROOT = Path(__file__).resolve().parents[2]
SPEC = Spec(ROOT / "BENCHMARK.json")
READERS = {m["name"]: SPEC.reader(m) for m in SPEC.data["per_layer"]
           if m["source"] == "program_span"}
TRAIN = ("forward_host_ms.train", "backward_host_ms.train", "optimizer_host_ms.train")
TINY = dict(n_bins=16, native_height=64, native_width=96, eval_zone_num_cfg=2, eval_patch_px=16,
            input_height=48, input_width=64, train_zone_num=2, train_patch_px=16)


def test_the_entries():
    assert sorted(READERS) == sorted(("graph_host_ms.infer",) + TRAIN)
    cells = {m["name"]: m["workloads"] for m in SPEC.data["per_layer"]}
    assert cells["graph_host_ms.infer"] == ["cfpnet.frame_bs1", "deltar.frame_bs1"]
    assert all(cells[name] == ["cfpnet.train_bs16"] for name in TRAIN)


def _run(items):
    """What the readers get of a traced window of ``items`` items."""
    return SimpleNamespace(trace=SimpleNamespace(items=items))


def _span(name, id_, root, start_us, end_us, parent=None):
    return tracing.Record(name, id_, parent, root, int(start_us * 1e3), int(end_us * 1e3), 0)


@pytest.fixture
def spans(monkeypatch):
    held = []
    monkeypatch.setattr(tracing, "snapshot", lambda: tracing.Snapshot(held, {}))
    return held


def test_graph_calls_median_without_the_replays(spans):
    # each call: a copy, then a replay of half the call's time, ended first
    for i, us in enumerate((300, 100, 250, 4000, 200)):
        call = 3 * i + 1
        spans.append(_span("graph.copy_in", call + 1, call, 0, us / 4, call))
        spans.append(_span("graph.replay", call + 2, call, us / 4, 3 * us / 4, call))
        spans.append(_span("graph.call", call, call, 0, us))
    assert READERS["graph_host_ms.infer"](_run(5)) == pytest.approx(0.125)
    # the last three frames only: an earlier attempt's are not read again
    assert READERS["graph_host_ms.infer"](_run(3)) == pytest.approx(0.125)
    assert READERS["graph_host_ms.infer"](_run(2)) == pytest.approx((2.0 + 0.1) / 2)


def test_train_phases_mean_a_step(spans):
    # two steps, the second of two microbatches; a forward outside any step
    # is not counted
    spans += [_span("train.forward", 2, 1, 0, 100, 1), _span("train.backward", 3, 1, 100, 300, 1),
              _span("train.optimizer", 4, 1, 300, 340, 1), _span("train.step", 1, 1, 0, 350),
              _span("train.forward", 6, 5, 0, 50, 5), _span("train.backward", 7, 5, 50, 150, 5),
              _span("train.forward", 8, 5, 150, 220, 5), _span("train.backward", 9, 5, 220, 300, 5),
              _span("train.optimizer", 10, 5, 300, 360, 5), _span("train.step", 5, 5, 0, 370),
              _span("train.forward", 11, 11, 0, 9000)]
    got = [READERS[name](_run(2)) for name in TRAIN]
    assert got == pytest.approx([(0.1 + 0.05 + 0.07) / 2, (0.2 + 0.1 + 0.08) / 2,
                                 (0.04 + 0.06) / 2])
    # a window of one step reads the last step alone
    got = [READERS[name](_run(1)) for name in TRAIN]
    assert got == pytest.approx([0.05 + 0.07, 0.1 + 0.08, 0.06])


def test_steps_nested_in_the_loop(spans):
    spans += [_span("train.forward", 3, 1, 10, 60, 2), _span("train.step", 2, 1, 5, 90, 1),
              _span("loop.step", 1, 1, 0, 100)]
    assert READERS["forward_host_ms.train"](_run(1)) == pytest.approx(0.05)


@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_without_spans(spans, name):
    assert READERS[name](_run(2)) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_without_the_module(monkeypatch, name):
    monkeypatch.delattr(cfpnet_torch, "tracing")
    monkeypatch.setitem(__import__("sys").modules, "cfpnet_torch.tracing", None)
    assert READERS[name](_run(2)) is None


def test_traced_train_steps_on_the_cpu():
    """The train cell's driver at a tiny size on the CPU: its traced steps
    under a profiler session record the step's spans, and the three phases
    fit inside the step."""
    torch.set_num_threads(1)
    cell = SPEC.cell("cfpnet.train_bs16")
    settings = dict(SPEC.config(cell)["settings"], **TINY)
    traffic = dict(SPEC.traffic(cell), batch=2, pool=2, check_steps=1, warmup=1)
    driver = drivers.Train(cfpnet, settings, traffic, 2 ** 31 + 7, "cpu", tiny=True)
    tracing.reset()
    assert all(READERS[name](_run(1)) is None for name in TRAIN)
    with profile(activities=[ProfilerActivity.CPU]):
        items, _ = driver.traced()
    got = [READERS[name](_run(items)) for name in TRAIN]
    steps = [s.ms for s in tracing.snapshot().spans if s.name == "train.step"]
    tracing.reset()
    assert len(steps) == items == traffic["trace_steps"]
    assert all(v > 0 for v in got) and sum(got) <= sum(steps) / len(steps)
