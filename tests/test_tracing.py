"""``cfpnet_torch/tracing.py`` on the CPU: the gate while tracing is off;
nesting, parents, roots and self time while it is on; spans that record
while a torch.profiler session runs and add no event to it; the shared clock
with the profiler's events; the loader's two threads; a tiny training run's
epoch line; a tiny train step bit for bit the same with tracing on and off;
the counters under many threads; and the kernels' launch counts read and
reset through the counters."""

import json
import os
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cfpnet_torch import kernels, tracing, weights
from cfpnet_torch.config import Config as PtConfig
from cfpnet_torch.data import datasets as pt_ds
from cfpnet_torch.data import pipeline as pt_pipe
from cfpnet_torch.kernels import dtypes, dwconv, fused_loftr
from cfpnet_torch.models.deltar import make_model, model_geometries
from cfpnet_torch.train import loop as pt_loop
from cfpnet_torch.train import steps as pt_steps

TINY = dict(n_bins=16, input_height=48, input_width=64, native_height=64, native_width=96,
            train_zone_num=2, eval_zone_num_cfg=2, train_patch_px=16, eval_patch_px=16,
            zone_sample_num=16, sample_uniform=True,
            attention_layer=["hist2image", "combine1", "image"], change_embedding=True,
            disable_clip_grad=False, hist_encoder_10x=True, bs=2, epochs=1, tiny_model=True,
            dataset="synthetic", dataset_eval="synthetic")


@pytest.fixture(autouse=True)
def clean():
    torch.set_num_threads(1)
    tracing.reset()
    yield
    tracing.reset()


def _names(snapshot):
    return [s.name for s in snapshot.spans]


def test_off_returns_the_shared_noop_and_records_nothing():
    assert tracing.span("x") is tracing.NOOP
    s = tracing.span("graph.call")
    assert s is tracing.NOOP and tracing.span("other") is s
    with s:
        with tracing.span("inner"):
            pass
    assert tracing.snapshot() == ([], {})
    tracing.count("parallel.all_reduce")  # counters are always on
    assert tracing.counters() == {"parallel.all_reduce": 1}


def test_enable_nests_with_parents_roots_and_self_time(monkeypatch):
    ticks = iter([0, 10, 30, 40, 45, 100, 200, 260])
    monkeypatch.setattr(tracing, "_clock", lambda: next(ticks))
    tracing.enable()
    try:
        with tracing.span("a"):
            with tracing.span("b"):
                pass
            with tracing.span("c"):
                pass
        with tracing.span("d"):
            pass
    finally:
        tracing.disable()
    assert tracing.span("x") is tracing.NOOP
    snap = tracing.snapshot()
    b, c, a, d = snap.spans
    assert [r.name for r in (a, b, c, d)] == ["a", "b", "c", "d"]
    assert a.parent is None and a.root == a.id
    assert b.parent == c.parent == a.id and b.root == c.root == a.id
    assert d.parent is None and d.root == d.id != a.id
    assert (a.start_ns, a.end_ns, a.self_ns) == (0, 100, 75)
    assert (b.self_ns, c.self_ns, d.self_ns) == (20, 5, 60)
    assert snap.aggregates["a"] == pytest.approx(dict(n=1, total_ms=100e-6, self_ms=75e-6,
                                                      max_ms=100e-6))
    assert a.ms == pytest.approx(100e-6)


def test_aggregates_sum_and_keep_the_longest(monkeypatch):
    ticks = iter([0, 5, 10, 30, 40, 41])
    monkeypatch.setattr(tracing, "_clock", lambda: next(ticks))
    with tracing.session() as rec:
        for _ in range(3):
            with tracing.span("x"):
                pass
    assert rec.snapshot().aggregates["x"] == pytest.approx(dict(n=3, total_ms=26e-6,
                                                                self_ms=26e-6, max_ms=20e-6))
    assert rec.drain().aggregates and rec.snapshot() == ([], {})


def test_a_recorder_keeps_the_last_records_and_aggregates_all(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    rec = tracing.Recorder()
    for i in range(5):
        rec.add(tracing.Record("x", i + 1, None, i + 1, 0, 10, 10))
    snap = rec.snapshot()
    assert [r.id for r in snap.spans] == [3, 4, 5] and snap.aggregates["x"]["n"] == 5


def test_sessions_see_only_their_own_spans():
    """A session's recorder gets the spans that end while it is open, and
    the process's recorder only those that end while none is."""
    tracing.enable()
    with tracing.span("before"):
        pass
    with tracing.session() as outer:
        with tracing.span("both"):
            pass
        with tracing.session() as inner:
            with tracing.span("inner"):
                pass
    with tracing.span("after"):
        pass
    tracing.disable()
    assert tracing.span("x") is tracing.NOOP
    assert _names(outer.snapshot()) == ["both", "inner"]
    assert _names(inner.snapshot()) == ["inner"]
    assert _names(tracing.snapshot()) == ["before", "after"]
    assert _names(tracing.drain()) == ["before", "after"]
    assert tracing.snapshot() == ([], {})


def _tiny_step():
    """A tiny model, its optimizer and train step on the CPU, and one batch."""
    cfg = PtConfig(**TINY)
    model = make_model(cfg, tiny=True, device="cpu")
    model.load_state_dict(weights.deterministic_state_dict(cfg, tiny=True), strict=True)
    state = pt_steps.create_train_state(model, cfg, 10)
    step = pt_steps.make_train_step(model, cfg, model_geometries(cfg, "train"))
    ds = pt_ds.SyntheticDataset(cfg, "train", 2)
    batch = {k: torch.from_numpy(v) for k, v in pt_ds.collate([ds[0], ds[1]]).items()}
    return state, step, batch


def test_profiler_session_records_spans_and_adds_no_event(monkeypatch):
    """While a profiler session runs, the train step's spans record without
    ``enable()``; the profiler's events of a step are the same by name with
    the spans live as with every span the shared no-op."""
    state, step, batch = _tiny_step()
    step(state, batch, 1)  # first-call work outside the comparison

    def event_names(seed):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(state, batch, seed)
        return {e.name for e in prof.events()}

    live = event_names(2)
    names = _names(tracing.drain())
    assert {"train.step", "train.forward", "train.backward", "train.optimizer"} <= set(names)
    monkeypatch.setattr(tracing, "span", lambda name: tracing.NOOP)
    off = event_names(3)
    assert tracing.snapshot() == ([], {})
    assert live == off
    assert not any(n.startswith(("train.", "graph.", "data.", "loop.")) for n in live)


def test_spans_share_the_profilers_clock():
    """A span around ``x @ x`` holds that session's ``aten::mm`` event, its
    times taken as ``trace_start_ns()`` plus the event's microseconds."""
    x = torch.randn(512, 512)
    x @ x
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("mm"):
            x @ x
    (mm_span,) = tracing.snapshot().spans
    start = prof.profiler.kineto_results.trace_start_ns()
    (mm,) = [e for e in prof.events() if e.name == "aten::mm"]
    ev_start, ev_end = start + mm.time_range.start * 1e3, start + mm.time_range.end * 1e3
    slack = 100e3  # ns; the product takes milliseconds
    assert ev_end - ev_start > 5 * slack
    assert mm_span.start_ns - slack <= ev_start and ev_end <= mm_span.end_ns + slack


SMALL = dict(n_bins=16, input_height=48, input_width=64, native_height=64, native_width=96,
             train_zone_num=2, eval_zone_num_cfg=2, train_patch_px=16, eval_patch_px=16,
             zone_sample_num=16, sample_uniform=True, seed=5)


def test_loader_threads_record_waits_and_makes():
    """The consumer's ``data.wait`` spans are children of the span open
    around the loop; the producer thread's ``data.produce`` spans are roots
    of their own thread; one of each a batch."""
    cfg = PtConfig(**SMALL, bs=2)
    loader = pt_pipe.DataLoader(pt_ds.SyntheticDataset(cfg, "train", 7), 2, shuffle=True,
                                drop_last=True, seed=5, device="cpu")
    with tracing.session() as rec:
        with tracing.span("consumer"):
            got = list(loader)
    snap = rec.snapshot()
    (consumer,) = [s for s in snap.spans if s.name == "consumer"]
    waits = [s for s in snap.spans if s.name == "data.wait"]
    made = [s for s in snap.spans if s.name == "data.produce"]
    assert len(got) == len(waits) == len(made) == 3
    assert all(s.parent == s.root == consumer.id for s in waits)
    assert all(s.parent is None and s.root == s.id for s in made)
    assert consumer.self_ns == consumer.end_ns - consumer.start_ns - sum(
        s.end_ns - s.start_ns for s in waits)


def test_run_training_epoch_line_carries_spans(tmp_path, monkeypatch):
    """A tiny ``run_training`` epoch: its JSONL ``epoch`` line keeps the old
    timing keys, now read from the spans, and gains ``spans`` and ``counters``,
    the epoch's increments of the counters (here one kernel launch a step,
    counted by a wrapped train step: the CPU launches no kernel; and the
    two steps, eager on the CPU)."""
    monkeypatch.chdir(tmp_path)
    make = pt_loop.make_train_step

    def make_train_step(*args, **kw):
        step = make(*args, **kw)

        def counted(*a):
            dtypes.count_launch("dwconv", torch.float32)
            return step(*a)

        return counted

    monkeypatch.setattr(pt_loop, "make_train_step", make_train_step)
    tracing.count("kernel.dwconv.launches.float32", 5)  # before the run: not the epoch's
    cfg = PtConfig(**TINY).replace(synthetic_length=4, name="t", save_dir="results/t",
                                   validate_every=1)
    pt_loop.run_training(cfg, tiny=True, device="cpu")
    with open(os.path.join(cfg.save_dir, "train_log.jsonl")) as f:
        (epoch,) = [x for x in map(json.loads, f) if x["kind"] == "epoch"]
    spans = epoch["spans"]
    assert {"train.step", "train.forward", "train.backward", "train.optimizer", "data.wait",
            "data.produce", "loop.train", "loop.step", "loop.validate",
            "loop.checkpoint"} <= set(spans)
    assert epoch["steps"] == 2 and spans["train.step"]["n"] == spans["loop.step"]["n"] == 2
    assert len(epoch["loader_wait_ms"]) == len(epoch["producer_ms"]) == 2
    assert epoch["train_s"] == pytest.approx(spans["loop.train"]["total_ms"] / 1e3)
    assert epoch["val_s"] == pytest.approx(spans["loop.validate"]["total_ms"] / 1e3)
    assert epoch["checkpoint_s"] == pytest.approx(spans["loop.checkpoint"]["total_ms"] / 1e3)
    assert all(set(v) == {"n", "total_ms", "self_ms", "max_ms"} for v in spans.values())
    assert epoch["counters"] == {"kernel.dwconv.launches.float32": 2, "train.eager_steps": 2}
    phases = sum(spans[k]["total_ms"] for k in ("train.forward", "train.backward",
                                                "train.optimizer"))
    assert 0 < phases <= spans["train.step"]["total_ms"] <= spans["loop.train"]["total_ms"]
    assert tracing.span("x") is tracing.NOOP


def test_train_step_bit_identical_with_tracing_on_and_off():
    runs = []
    for on in (False, True):
        torch.manual_seed(0)
        state, step, batch = _tiny_step()
        if on:
            tracing.enable()
        try:
            losses = [step(state, batch, seed) for seed in (4, 5)]
        finally:
            if on:
                tracing.disable()
        runs.append((losses, [p.detach().clone() for p in state.model.parameters()]))
    (loss_off, p_off), (loss_on, p_on) = runs
    assert all(torch.equal(a, b) for a, b in zip(loss_off, loss_on))
    assert all(torch.equal(a, b) for a, b in zip(p_off, p_on))
    assert _names(tracing.snapshot()).count("train.step") == 2


def test_counters_and_spans_under_many_threads():
    """More threads than cores, switching often: no count is lost, and every
    span's parent is the span its own thread had open."""
    threads, reps = 4 * (os.cpu_count() or 1), 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    tracing.enable()
    try:
        def work():
            for _ in range(reps):
                with tracing.span("outer"):
                    tracing.count("n")
                    with tracing.span("inner"):
                        tracing.count("n", 2)

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(60)
        assert not any(t.is_alive() for t in pool)
    finally:
        tracing.disable()
        sys.setswitchinterval(old)
    assert tracing.counters() == {"n": 3 * threads * reps}
    snap = tracing.snapshot()
    outer = {s.id: s for s in snap.spans if s.name == "outer"}
    inner = [s for s in snap.spans if s.name == "inner"]
    assert len(outer) == len(inner) == threads * reps
    assert snap.aggregates["inner"]["n"] == threads * reps
    assert all(o.parent is None for o in outer.values())
    for s in inner:
        o = outer[s.parent]
        assert s.root == o.id and o.start_ns <= s.start_ns <= s.end_ns <= o.end_ns


def test_kernel_launches_are_read_and_reset_through_the_counters():
    """A wrapper counts its launches in ``kernel.<name>.launches.<dtype>``:
    ``tracing.counters`` reads them by prefix and ``reset_counters`` clears
    them, one kernel's or all; no wrapper module keeps a view of its own."""
    tracing.reset_counters("kernel.")
    assert tracing.counters("kernel.") == {}
    dtypes.count_launch("dwconv", torch.bfloat16)
    dtypes.count_launch("dwconv", torch.float32)
    dtypes.count_launch("dwconv", torch.float32)
    dtypes.count_launch("fused_loftr", torch.float32)
    assert tracing.counters("kernel.dwconv.launches.") == {"kernel.dwconv.launches.bfloat16": 1,
                                                           "kernel.dwconv.launches.float32": 2}
    tracing.reset_counters("kernel.dwconv.")
    assert tracing.counters("kernel.") == {"kernel.fused_loftr.launches.float32": 1}
    tracing.reset_counters("kernel.")
    assert tracing.counters() == {}
    for module in (kernels.bn_act, dwconv, fused_loftr, kernels.linear_attention):
        assert not hasattr(module, "launches")
