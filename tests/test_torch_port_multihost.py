"""Data parallelism of the port on the CPU, with no JAX: the processes of a
run (``cfpnet_torch/parallel/launch.py``), the layout of a global batch
over the processes, the training and sweep entry points under
``--multihost`` and ``--dp_shards`` as two gloo processes, and
``rank_worker``, the process side of ``tests/test_torch_port_parallel.py``.
This module imports nothing of JAX, so that a process spawned to import it
starts in about a second.

Every process a test starts has ``OMP_NUM_THREADS=2``; every group join,
collective and wait has a timeout of ``TIMEOUT`` seconds, so a hung process
fails the test in seconds."""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from cfpnet_torch.config import Config as PtConfig
from cfpnet_torch.data import datasets as pt_ds
from cfpnet_torch.data import tof_sim_device
from cfpnet_torch.data.geometry import geometry_for
from cfpnet_torch.data.pipeline import make_loader
from cfpnet_torch.models import fusion
from cfpnet_torch.models.deltar import make_model, model_geometries
from cfpnet_torch.models.layers import BatchNorm
from cfpnet_torch.models.posenet import PoseNet
from cfpnet_torch.parallel import launch, mesh
from cfpnet_torch.train import __main__ as pt_train_main
from cfpnet_torch.train import loop as pt_loop
from cfpnet_torch.train import selfsup as pt_selfsup
from cfpnet_torch.train import steps as pt_steps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120.0
ENV = {"OMP_NUM_THREADS": "2"}
# one torch thread in this process and in the processes that import this
# module (``rank_worker``): tiny ops, shared cores (``tests/torch_port_util.py``)
torch.set_num_threads(1)
TINY = dict(n_bins=16, input_height=48, input_width=64, native_height=64, native_width=96,
            train_zone_num=2, eval_zone_num_cfg=2, train_patch_px=16, eval_patch_px=16,
            zone_sample_num=16, sample_uniform=True,
            attention_layer=["hist2image", "combine1", "image"], change_embedding=True,
            disable_clip_grad=True, hist_encoder_10x=True, bs=2, epochs=1)
ENTRY = ["--tiny_model", "--n_bins", "16", "--native_height", "64", "--native_width", "96",
         "--input_height", "48", "--input_width", "64", "--train_zone_num", "2",
         "--eval_zone_num_cfg", "2", "--train_patch_px", "16", "--eval_patch_px", "16",
         "--sample_uniform", "--change_embedding", "--attention_layer", "hist2image",
         "combine1", "image", "--dataset", "synthetic", "--dataset_eval", "synthetic",
         "--synthetic_length", "4", "--bs", "2", "--epochs", "1", "--name", "dp",
         "--save_dir", "results/dp", "--device", "cpu", "--logging"]


class Float64:
    """A dataset's samples in float64, ``image_u8`` normalized on the host,
    so that the port's model and the JAX package's run in float64 on the
    same values (``tests/test_torch_port_loop.py``'s wrapper)."""

    def __init__(self, base):
        self.base = base

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        s = dict(self.base[i])
        if "image_u8" in s:
            raw = s.pop("image_u8").astype(np.float64) / 255.0
            s["image"] = (raw - pt_ds.IMAGENET_MEAN.astype(np.float64)) / pt_ds.IMAGENET_STD
        return {k: v.astype(np.float64) if v.dtype.kind == "f" else v for k, v in s.items()}


def to_f64(batch):
    """numpy or torch leaves as float64 tensors (bool leaves kept)."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(np.asarray(v))
        out[k] = v.double() if v.is_floating_point() else v
    return out


# ---- the process side of tests/test_torch_port_parallel.py ------------------------

@contextlib.contextmanager
def recorded_offsets():
    """``fusion.crop_offsets`` recording what it draws, (offsets, ranges)
    each, while inside."""
    drawn, real = [], fusion.crop_offsets

    def record(H, W, maxH, maxW, generator=None):
        off = real(H, W, maxH, maxW, generator)
        drawn.append((off, (maxH - H + 1, maxW - W + 1)))
        return off

    fusion.crop_offsets = record
    try:
        yield drawn
    finally:
        fusion.crop_offsets = real


def _port(state_dict, cfg):
    port = make_model(cfg, tiny=True, device="cpu").double()
    port.load_state_dict(state_dict, strict=True)
    return port


def _after(model, out):
    """The step's result with the model's state and gradients, copied."""
    out.update(state={k: v.clone() for k, v in model.state_dict().items()},
               grads={k: p.grad.clone() for k, p in model.named_parameters()})
    return out


def _train_step(inp, sc):
    cfg = PtConfig(**sc["config"])
    port = _port(inp["state"], cfg)
    state = pt_steps.create_train_state(port, cfg, total_steps=20)
    accum = int(cfg.grad_accum or 1)
    batch = mesh.shard_batch({k: torch.as_tensor(v) for k, v in sc["batch"].items()}, accum)
    if cfg.device_pipeline:
        draws = {k: torch.as_tensor(v) for k, v in sc["draws"].items()}

        def injected(generator, B, Z, config):
            assert (B, Z) == (len(draws["flip"]), draws["drop"].shape[1])  # the global batch
            return draws

        real = tof_sim_device.draw_augmentations
        tof_sim_device.draw_augmentations = injected
        try:
            batch = tof_sim_device.preprocess_batch(batch, cfg, geometry_for(cfg, "train"),
                                                    torch.Generator())
        finally:
            tof_sim_device.draw_augmentations = real
        batch.pop("image_raw")
    batch = to_f64(batch)
    with recorded_offsets() as drawn:
        loss = pt_steps.make_train_step(port, cfg, model_geometries(cfg, "train"))(
            state, batch, sc["seed"])
    return _after(port, dict(loss=loss, offsets=drawn, batch=batch))


def _selfsup_step(inp, sc):
    cfg = PtConfig(**sc["config"])
    depth = make_model(cfg, tiny=True, device="cpu").double()
    state = pt_selfsup.create_selfsup_state(depth, cfg, 20, PoseNet().double())
    state.model.load_state_dict(sc["state"], strict=True)
    step = pt_selfsup.make_selfsup_train_step(state, cfg, model_geometries(cfg, "train"),
                                              geometry_for(cfg, "train"))
    with recorded_offsets() as drawn:
        terms = step(state, mesh.shard_batch(to_f64(sc["batch"])), sc["seed"])
    return _after(state.model, dict(terms=terms, offsets=drawn))


def _batchnorm(sc):
    """Train-mode ``BatchNorm`` on this process's rows: the output, the
    gradient of sum(y * g) for x, the parameters' gradients summed over the
    processes, and the running statistics."""
    out = {}
    for channel_dim, case in sc.items():
        bn = BatchNorm(case["C"], case["eps"], channel_dim=channel_dim).double()
        bn.load_state_dict({k: torch.as_tensor(v) for k, v in case["start"].items()})
        bn.train()
        x = mesh.shard_batch({"x": torch.as_tensor(case["x"])})["x"].requires_grad_()
        g = mesh.shard_batch({"g": torch.as_tensor(case["g"])})["g"]
        y = bn(x)
        (y * g).sum().backward()
        for p in (bn.weight, bn.bias):
            torch.distributed.all_reduce(p.grad)
        out[channel_dim] = dict(y=y.detach(), dx=x.grad, dscale=bn.weight.grad,
                                dbias=bn.bias.grad, mean=bn.running_mean.clone(),
                                var=bn.running_var.clone())
    return out


def _evaluate(inp, sc):
    cfg = PtConfig(**sc["config"])
    seen = []
    metrics = pt_loop.evaluate_sharded(
        _port(inp["state"], cfg), cfg, Float64(pt_ds.SyntheticDataset(cfg, "online_eval",
                                                                      sc["length"])),
        per_image_hook=lambda i, pred, batch, j: seen.append(i), device="cpu")
    return dict(metrics=metrics, indices=seen)


def _loaders(sc):
    out = {}
    for accum in (1, 2):
        cfg = PtConfig(**sc["config"]).replace(grad_accum=accum)
        loader = make_loader(cfg, "train", dataset=pt_ds.SyntheticDataset(cfg, "train",
                                                                          sc["length"]),
                             device="cpu")
        out[accum] = [(loader.indices.copy(), {k: v.numpy() for k, v in b.items()})
                      for b in loader]
    return out


def rank_worker(rank, init_method, in_path, out_dir):
    """One of the two processes of ``test_torch_port_parallel.py``'s run:
    every case of ``in_path`` (written by that module) on this process's
    rows, the results to ``out_dir/rank{rank}.pt``."""
    mesh.init_rank(rank, 2, init_method, "cpu", timeout=TIMEOUT)
    inp = torch.load(in_path, weights_only=False)
    out = dict(world=mesh.world_size(), rank=mesh.rank(), jax_imported="jax" in sys.modules,
               bn=_batchnorm(inp["bn"]),
               evaluate=_evaluate(inp, inp["evaluate"]), loaders=_loaders(inp["loader"]),
               selfsup=_selfsup_step(inp, inp["selfsup"]))
    for name in ("plain", "grad_accum", "device_pipeline"):
        out[name] = _train_step(inp, inp[name])
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


# ---- the processes and the layout --------------------------------------------------

def failing_rank(rank, init_method, fail_rank):
    mesh.init_rank(rank, 2, init_method, "cpu", timeout=TIMEOUT)
    if rank == fail_rank:
        raise RuntimeError(f"rank {rank} fails")
    time.sleep(TIMEOUT)  # until it is terminated


def hung_rank(rank, init_method):
    mesh.init_rank(rank, 2, init_method, "cpu", timeout=TIMEOUT)
    if rank == 0:
        time.sleep(TIMEOUT)  # hangs
    mesh.barrier()


@pytest.fixture
def env(monkeypatch):
    """``ENV`` in this process's environment, which spawned processes
    start with."""
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)


def test_a_failing_rank_fails_the_run(env):
    """A process that raises ends the run: the error reaches the caller and
    the other process is terminated."""
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails"):
        launch.spawn("tests.test_torch_port_multihost:failing_rank", 2, (1,), timeout=TIMEOUT)
    assert time.monotonic() - t0 < TIMEOUT / 2


def test_a_hung_rank_times_out(env):
    with pytest.raises(TimeoutError, match="still running"):
        launch.spawn("tests.test_torch_port_multihost:hung_rank", 2, timeout=5.0)


def test_rank_rows_layout_and_refusals():
    """Contiguous shares of a batch; under ``--grad_accum`` each process's
    share of each microbatch in turn; the JAX loader's ``ValueError`` where
    the processes do not divide the batch, and a ``ValueError`` naming both
    numbers where they do not divide the microbatch."""
    assert [list(mesh.rank_rows(8, 2, r)) for r in (0, 1)] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert [list(mesh.rank_rows(8, 2, r, accum=2)) for r in (0, 1)] == [[0, 1, 4, 5],
                                                                       [2, 3, 6, 7]]
    assert list(mesh.rank_rows(12, 3, 2, accum=2)) == [4, 5, 10, 11]
    for accum in (1, 2, 4):
        rows = np.concatenate([mesh.rank_rows(16, 4, r, accum) for r in range(4)])
        assert sorted(rows) == list(range(16))
    with pytest.raises(ValueError, match="bs=6, processes=4"):
        mesh.rank_rows(6, 4, 0)
    with pytest.raises(ValueError, match="microbatch of 2 rows .* 4 processes"):
        mesh.rank_rows(8, 4, 0, accum=4)
    # one process: nothing is split
    batch = {"x": torch.arange(4)}
    assert mesh.shard_batch(batch) is batch and mesh.world_size() == 1 and mesh.rank() == 0


# ---- the entry points as two processes ----------------------------------------------

def _two_processes(module, argv, cwd):
    """``python -m module argv --multihost`` as processes 0 and 1 of a
    group at a ``file://`` store under ``cwd``; returns their outputs after
    both exited 0."""
    store = f"file://{cwd}/store"
    env = dict(os.environ, **ENV, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *argv, "--multihost", "--coordinator_address", store,
         "--num_processes", "2", "--process_id", str(r)],
        cwd=cwd, env=dict(env, LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


@pytest.fixture(scope="module")
def entry_run(tmp_path_factory):
    """``python -m cfpnet_torch.train --device cpu --multihost`` on the tiny
    synthetic run, as two processes in one working directory."""
    cwd = tmp_path_factory.mktemp("multihost")
    return cwd, _two_processes("cfpnet_torch.train", ENTRY, cwd)


def test_multihost_training_entry_point(entry_run):
    """Both processes exit 0 with the same loss and metrics; one set of
    checkpoints, weights and log lines is written, rank 0's."""
    cwd, outs = entry_run
    lines = [[line for line in out.splitlines() if line.startswith("epoch 0:")]
             for out in outs]
    assert len(lines[0]) == 1 and lines[0] == lines[1], outs
    assert sorted(os.listdir(cwd / "checkpoints" / "dp")) == sorted(
        os.listdir(cwd / "weights" / "dp"))
    assert len(os.listdir(cwd / "checkpoints" / "dp")) == 2  # {ep}_{rmse} and best
    with open(cwd / "results" / "dp" / "train_log.jsonl") as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds == ["header", "val", "epoch"]


def test_multihost_epoch_line_counts_the_all_reduces(entry_run):
    """Rank 0's epoch line carries the epoch's counters: the all-reduces of
    its two steps and their bytes, at least each step's gradients once (the
    model, the loss and validation reduce more), and the two steps, eager
    (a process group steps eager); no kernel on the CPU."""
    from cfpnet_torch.config import parse_config

    cwd, _ = entry_run
    with open(cwd / "results" / "dp" / "train_log.jsonl") as f:
        (epoch,) = [line for line in map(json.loads, f) if line["kind"] == "epoch"]
    config = parse_config(ENTRY[:ENTRY.index("--device")]).replace(mode="train")
    model = make_model(config, tiny=True, device="cpu")
    grad_bytes = sum(p.numel() * p.element_size() for p in model.parameters()
                     if p.requires_grad)
    counted = epoch["counters"]
    assert sorted(counted) == ["parallel.all_reduce", "parallel.all_reduce_bytes",
                               "train.eager_steps"]
    assert counted["train.eager_steps"] == epoch["steps"] == 2
    assert counted["parallel.all_reduce"] >= 2
    assert counted["parallel.all_reduce_bytes"] >= epoch["steps"] * grad_bytes > 0


def test_multihost_sweep_with_shard_eval(entry_run, monkeypatch):
    """``python -m cfpnet_torch.evaluate_all --multihost --shard_eval`` over
    the run's weights as two processes: the images split between them, the
    merged metrics printed by both and written by rank 0 alone, the same as
    one process's sweep."""
    from cfpnet_torch import evaluate_all

    cwd, _ = entry_run
    argv = ENTRY[:ENTRY.index("--logging")] + ["--test_dataset", "synthetic",
                                               "--selected_epoch", "best"]
    outs = _two_processes("cfpnet_torch.evaluate_all",
                          argv + ["--save_dir", "sharded", "--shard_eval"], cwd)
    rows = [[line for line in out.splitlines() if line.startswith("Metrics:")] for out in outs]
    assert len(rows[0]) == 1 and rows[0] == rows[1]
    monkeypatch.chdir(cwd)
    one = evaluate_all.main(argv + ["--save_dir", "one"])
    with open(cwd / "sharded" / "results.csv") as f:
        sharded = f.read()
    with open(cwd / "one" / "results.csv") as f:
        assert sharded == f.read()
    assert one["rows"] and sorted(os.listdir(cwd / "sharded")) == ["results.csv",
                                                                  "results.xlsx"]


def test_dp_shards_spawns_a_process_a_device(tmp_path, monkeypatch, env):
    """``--dp_shards 0`` with two local devices (``local_device_count``
    patched: the CPU has one) spawns two processes, which train as a group
    of two; with ``--dp_shards 1``, or one device, nothing is spawned."""
    monkeypatch.chdir(tmp_path)
    spawned = []
    real = launch.spawn

    def spawn(target, world, args=(), timeout=None):
        spawned.append(world)
        return real(target, world, args, timeout=TIMEOUT)

    monkeypatch.setattr(launch, "spawn", spawn)
    monkeypatch.setattr(pt_train_main, "local_device_count", lambda device: 2)
    assert pt_train_main.main(ENTRY + ["--dp_shards", "0"]) is None
    assert spawned == [2]
    with open(tmp_path / "results" / "dp" / "train_log.jsonl") as f:
        assert [json.loads(line)["kind"] for line in f] == ["header", "val", "epoch"]
    state = pt_train_main.main(ENTRY + ["--dp_shards", "1", "--no_logging"])
    assert spawned == [2] and state.step == 2 and not torch.distributed.is_initialized()
