"""The port's training loop and entry point on the CPU at the tiny size: the loader-based
``evaluate`` (batched equals bs 1, ``has_valid_depth`` skipped, ``image_u8``
equals the normalized image), grouped eval over a mixed-rig ZJUL5 set,
``run_training``'s checkpoints and logs, a resume that equals the
uninterrupted run bit for bit, the JAX package's stale ``best_rmse`` in the
epoch checkpoint, ``weights.opt_state_from_optax`` against optax in float64,
the entry point's refusals, its one-card options (``--device_pipeline``,
``--grad_accum``, ``--remat``, ``--debug_nans``), a planted NaN, and the
device pipeline's resume bit for bit."""

import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from cfpnet_torch import weights
from cfpnet_torch.config import Config as PtConfig
from cfpnet_torch.data import datasets as pt_ds
from cfpnet_torch.data.geometry import ZoneGeometry
from cfpnet_torch.data.pipeline import DataLoader
from cfpnet_torch.models.deltar import make_model
from cfpnet_torch.train import __main__ as pt_train_main
from cfpnet_torch.train import checkpoint as pt_ckpt
from cfpnet_torch.train import loop as pt_loop
from cfpnet_torch.train import optim as pt_optim
from cfpnet_tpu.config import Config as JxConfig
from cfpnet_tpu.train import optim as jx_optim
from tests.torch_port_util import enable_x64

TINY = dict(n_bins=16, input_height=48, input_width=64, native_height=64, native_width=96,
            train_zone_num=2, eval_zone_num_cfg=2, train_patch_px=16, eval_patch_px=16,
            zone_sample_num=16, sample_uniform=True,
            attention_layer=["hist2image", "combine1", "image"], change_embedding=True,
            disable_clip_grad=True, hist_encoder_10x=True, bs=2, epochs=1, tiny_model=True,
            dataset="synthetic", dataset_eval="synthetic")


@pytest.fixture(scope="module")
def model():
    """The tiny model on the CPU with the deterministic weights."""
    cfg = PtConfig(**TINY)
    m = make_model(cfg, tiny=True, device="cpu")
    m.load_state_dict(weights.deterministic_state_dict(cfg, tiny=True), strict=True)
    return m


class Flagged:
    """A dataset whose chosen samples lack ground truth: flagged, and given
    an absurd depth that would move the metrics were they not skipped."""

    def __init__(self, base, invalid=(), u8=False):
        self.base, self.invalid, self.u8 = base, set(invalid), u8

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        s = dict(self.base[i])
        if self.u8:  # the image as uint8, and the normalized image of that uint8
            raw = s.pop("image") * pt_ds.IMAGENET_STD + pt_ds.IMAGENET_MEAN
            s["image_u8"] = np.clip(np.round(raw * 255.0), 0, 255).astype(np.uint8)
        if i in self.invalid:
            s["depth"] = np.full_like(s["depth"], 9.5)
        s["has_valid_depth"] = np.bool_(i not in self.invalid)
        return s


def _eval(model, dataset, bs=1, cfg=None):
    cfg = cfg or PtConfig(**TINY)
    return pt_loop.evaluate(model, cfg, DataLoader(dataset, bs, device="cpu"))


def test_batched_eval_equals_bs1(model):
    """--eval_bs 2 over 5 images (a ragged tail, one sample flagged):
    per-image metrics, image-weighted, as at bs 1."""
    ds = Flagged(pt_ds.SyntheticDataset(PtConfig(**TINY), "online_eval", 5), invalid={3})
    m1, m2, m3 = (_eval(model, ds, bs) for bs in (1, 2, 3))
    assert set(m1) == set(pt_loop.EVAL_METRIC_KEYS)
    for k in m1:
        # a1..a3 count pixels under a threshold: one pixel flipping under the
        # batch's other order of sums moves them by 1/(valid px)
        tol = 2e-4 if k in ("a1", "a2", "a3") else 1e-5
        assert m2[k] == pytest.approx(m1[k], rel=tol) == m3[k], k


def test_has_valid_depth_false_is_skipped(model):
    cfg = PtConfig(**TINY)
    base = pt_ds.SyntheticDataset(cfg, "online_eval", 2)
    everything = _eval(model, Flagged(base))
    skipped = _eval(model, Flagged(base, invalid={1}))
    only0 = _eval(model, Flagged(pt_ds.SyntheticDataset(cfg, "online_eval", 1)))
    assert skipped["rmse"] != pytest.approx(everything["rmse"])
    assert skipped == only0


def test_image_u8_equals_the_normalized_image(model):
    """``image_u8`` normalized on the device (``steps.eval_batch_image``)
    gives the metrics of the host's normalized image of the same uint8."""
    base = pt_ds.SyntheticDataset(PtConfig(**TINY), "online_eval", 3)
    u8 = Flagged(base, u8=True)

    class HostNormalized(Flagged):
        def __getitem__(self, i):
            s = u8[i]
            s["image"] = pt_ds.sample_image_f32(s)
            del s["image_u8"]
            return s

    got = _eval(model, u8, bs=2)
    want = _eval(model, HostNormalized(base), bs=2)
    assert got == want


# ---- grouped eval over a mixed-rig ZJUL5 set -------------------------------------

@pytest.fixture
def zju_mixed(tmp_path):
    """Five 64x96 captures of 2x2 zones from two rigs (offsets (2, -3) and
    (0, 0)) in one data.json."""
    import h5py

    rng = np.random.default_rng(9)
    rigs = [ZoneGeometry(64, 96, 2, 16, 16, offset_y=2, offset_x=-3).zone_rects(),
            ZoneGeometry(64, 96, 2, 16, 16).zone_rects()]
    names = []
    for i, rig in enumerate((0, 1, 0, 1, 1)):
        with h5py.File(tmp_path / f"cap{i}.h5", "w") as f:
            f["rgb"] = (rng.random((64, 96, 3)) * 255).astype(np.uint8)
            f["depth"] = rng.uniform(0.3, 8.0, (64, 96)).astype(np.float32)
            f["hist_data"] = np.stack([rng.uniform(0.5, 3.5, 4), rng.uniform(0.05, 0.3, 4)],
                                      axis=1).astype(np.float32)
            f["fr"] = rigs[rig]
            f["mask"] = np.ones(4, bool)
        names.append({"filename": f"cap{i}.h5"})
    (tmp_path / "data.json").write_text(json.dumps({"test": names}))
    return PtConfig(**TINY).replace(data_path_eval=str(tmp_path), dataset_eval="zjuL5",
                                    filenames_file_eval=str(tmp_path / "data.json"), eval_bs=2)


def test_grouped_eval_equals_the_groups_merged(model, zju_mixed):
    """One step pair per rig; the metrics equal each group's own sweep merged
    image-weighted, and the hook sees global dataset indices."""
    ds = pt_ds.make_dataset(zju_mixed, "online_eval")
    assert [g[1] for g in ds.geometry_groups] == [[0, 2], [1, 3, 4]]
    seen = []
    got = pt_loop.make_grouped_eval(model, zju_mixed, ds, device="cpu")(
        lambda i, pred, batch, j: seen.append((i, pred.shape, batch["image_u8"].shape[0])))
    assert sorted(s[0] for s in seen) == list(range(5))
    assert all(s[1] == (64, 96) and s[2] == 2 for s in seen)
    parts = []
    for geoms, indices, _ in ds.geometry_groups:
        sub = pt_loop._Subset(ds, indices)
        sub.scale_geoms = geoms
        loader = DataLoader(sub, 2, device="cpu")
        parts.append((len(indices), pt_loop.evaluate(model, zju_mixed, loader)))
    total = sum(n for n, _ in parts)
    for k in pt_loop.EVAL_METRIC_KEYS:
        assert got[k] == pytest.approx(sum(n * m[k] for n, m in parts) / total, rel=1e-12), k


# ---- the loop-level eval against the JAX package's ----------------------------------

class Float64:
    """A dataset's samples in float64, ``image_u8`` normalized on the host
    (the same numpy arithmetic for both packages), so that the JAX model and
    the port's run in float64; the geometry groups are passed through."""

    def __init__(self, base):
        self.base = base

    def __getattr__(self, name):
        return getattr(self.base, name)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        s = dict(self.base[i])
        if "image_u8" in s:
            raw = s.pop("image_u8").astype(np.float64) / 255.0
            s["image"] = (raw - pt_ds.IMAGENET_MEAN.astype(np.float64)) / pt_ds.IMAGENET_STD
        return {k: v.astype(np.float64) if v.dtype.kind == "f" else v for k, v in s.items()}


@pytest.fixture(scope="module")
def twin_f64():
    """The tiny flax model and the port's on the same random weights, in
    float64."""
    import jax.numpy as jnp

    from cfpnet_tpu.models.deltar import make_model as jx_make_model
    from cfpnet_tpu.models.deltar import model_geometries as jx_geometries
    from tests.torch_port_util import random_tree

    cfg = JxConfig(**TINY)
    model = jx_make_model(cfg, tiny=True)
    Z = cfg.eval_zone_num ** 2
    with enable_x64():
        shapes = jax.eval_shape(
            lambda r: model.init({"params": r, "fusion": r},
                                 jnp.zeros((1, cfg.native_height, cfg.native_width, 3)),
                                 jnp.ones((1, Z, cfg.zone_sample_num)),
                                 jnp.ones((1, Z), bool), jx_geometries(cfg, "online_eval")),
            jax.random.key(0))
        variables = random_tree(shapes, 3, kernel_std=0.05)
    port = make_model(PtConfig(**TINY), tiny=True, device="cpu").double()
    port.load_state_dict(weights.from_flax(variables["params"], variables["batch_stats"],
                                           PtConfig(**TINY)), strict=True)
    return model, variables, port


def _close_metrics(got, want):
    assert set(got) == set(want) == set(pt_loop.EVAL_METRIC_KEYS)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-7, abs=1e-12), k


def test_evaluate_equals_jax_evaluate_f64(twin_f64):
    """``--eval_bs 2`` over 5 images, a ragged tail and one sample without
    ground truth: the nine metrics of the port's ``evaluate`` equal those
    of the JAX package's on the same samples and weights."""
    from cfpnet_tpu.data.pipeline import DataLoader as JxDataLoader
    from cfpnet_tpu.train import loop as jx_loop

    model, variables, port = twin_f64
    ds = Float64(Flagged(pt_ds.SyntheticDataset(PtConfig(**TINY), "online_eval", 5),
                         invalid={2}))
    got = pt_loop.evaluate(port, PtConfig(**TINY), DataLoader(ds, 2, device="cpu"))
    with enable_x64():
        want = jx_loop.evaluate(model, JxConfig(**TINY), variables["params"],
                                variables["batch_stats"], JxDataLoader(ds, 2))
    _close_metrics(got, want)


def test_grouped_eval_equals_jax_grouped_eval_f64(twin_f64, zju_mixed):
    """The mixed-rig ZJUL5 set: the port's ``make_grouped_eval`` equals the
    JAX package's, each over its own package's ``ZJUL5Dataset``."""
    from cfpnet_tpu.data.datasets import ZJUL5Dataset as JxZJUL5
    from cfpnet_tpu.train import loop as jx_loop

    model, variables, port = twin_f64
    jx_cfg = JxConfig(**{**TINY, **{k: getattr(zju_mixed, k) for k in (
        "data_path_eval", "dataset_eval", "filenames_file_eval", "eval_bs")}})
    pt_set = Float64(pt_ds.ZJUL5Dataset(zju_mixed))
    jx_set = Float64(JxZJUL5(jx_cfg))
    assert len(pt_set.geometry_groups) == len(jx_set.geometry_groups) == 2
    got = pt_loop.make_grouped_eval(port, zju_mixed, pt_set, device="cpu")()
    with enable_x64():
        want = jx_loop.make_grouped_eval(model, jx_cfg, jx_set)(variables["params"],
                                                                 variables["batch_stats"])
    _close_metrics(got, want)


# ---- run_training ------------------------------------------------------------------

def _run(tmp_path, monkeypatch, **kw):
    monkeypatch.chdir(tmp_path)
    cfg = PtConfig(**TINY).replace(**{**dict(epochs=2, synthetic_length=4, name="t",
                                             save_dir="results/t", validate_every=1), **kw})
    trace = []
    state = pt_loop.run_training(cfg, tiny=True, device="cpu", trace=trace)
    return cfg, state, trace


def _log(cfg):
    with open(os.path.join(cfg.save_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_run_training_checkpoints_logs_and_last_epoch(tmp_path, monkeypatch):
    """2 epochs x 2 steps at --validate_every 5: only the last epoch
    validates, and it always checkpoints: ``{ep}_{rmse:.3f}``, ``best``,
    ``weights/``, and the JSONL header, val and epoch lines."""
    cfg, state, trace = _run(tmp_path, monkeypatch, validate_every=5)
    assert state.step == 4 and [t["step"] for t in trace] == [0, 1, 2, 3]
    log = _log(cfg)
    assert log[0]["kind"] == "header" and log[0]["tof_path"] in ("native", "numpy")
    val = [line for line in log if line["kind"] == "val"]
    assert [v["epoch"] for v in val] == [1]
    assert set(pt_loop.EVAL_METRIC_KEYS) <= set(val[0])
    rmse = val[0]["rmse"]
    assert sorted(os.listdir("checkpoints/t")) == sorted([f"1_{rmse:.3f}", "best"])
    assert sorted(os.listdir("weights/t")) == sorted([f"1_{rmse:.3f}", "best"])
    epochs = [line for line in log if line["kind"] == "epoch"]
    assert [e["steps"] for e in epochs] == [2, 2] and all(e["train_s"] > 0 for e in epochs)
    assert all(len(e["loader_wait_ms"]) == len(e["producer_ms"]) == 2 for e in epochs)
    assert all(np.isfinite(e["loss"]) for e in epochs)
    sd = pt_ckpt.load_weights("weights/t/best")
    assert all(torch.equal(sd[k], v) for k, v in state.model.state_dict().items())


def test_no_logging_writes_nothing(tmp_path, monkeypatch):
    _run(tmp_path, monkeypatch, no_logging=True, epochs=1)
    assert sorted(os.listdir(tmp_path)) == []


def _state(state):
    opt = state.tx.state_dict()
    return dict(model=state.model.state_dict(), step=state.step,
                **{f"{g}.{k}": opt[g][k] for g in opt for k in ("mu", "nu")})


def _same(a, b):
    assert a["step"] == b["step"]
    for key in a:
        if isinstance(a[key], dict):
            assert a[key].keys() == b[key].keys()
            for k in a[key]:
                assert torch.equal(a[key][k], b[key][k]), (key, k)


def test_resume_equals_the_uninterrupted_run_bit_for_bit(tmp_path, monkeypatch):
    """A 2-epoch run with per-batch zone offsets, and the same run resumed
    from its epoch-0 checkpoint: the resumed epoch takes the same batches,
    offsets and learning rates, its losses and the final parameters,
    statistics, moments and step are equal bit for bit; the checkpoint
    loads back bit for bit."""
    cfg, full, trace = _run(tmp_path, monkeypatch, train_zone_random_offset=1,
                            synthetic_length=8)
    assert {t["zone_offset"] for t in trace} != {0}
    ckpt0 = next(c for c in os.listdir("checkpoints/t") if c.startswith("0_"))
    last = next(c for c in os.listdir("checkpoints/t") if c.startswith("1_"))
    fresh = pt_loop.create_train_state(make_model(cfg, tiny=True, device="cpu"), cfg, 8)
    _, next_epoch, _ = pt_ckpt.load_checkpoint(f"checkpoints/t/{last}", fresh)
    assert next_epoch == 2
    _same(_state(fresh), _state(full))

    resumed_trace = []
    resumed = pt_loop.run_training(cfg.replace(resume=f"checkpoints/t/{ckpt0}"), tiny=True,
                                   device="cpu", trace=resumed_trace)
    tail = [t for t in trace if t["epoch"] == 1]
    assert len(tail) == len(resumed_trace) == 4
    for a, b in zip(tail, resumed_trace):
        assert {k: a[k] for k in ("epoch", "step", "zone_offset", "lr", "indices")} == {
            k: b[k] for k in ("epoch", "step", "zone_offset", "lr", "indices")}
        assert torch.equal(a["loss"], b["loss"])
    _same(_state(resumed), _state(full))


def test_epoch_checkpoint_keeps_the_stale_best_rmse(tmp_path, monkeypatch):
    """The JAX package's checkpoint semantics, kept: ``{ep}_{rmse}`` is saved
    with best_rmse from before the epoch's update, so a run resumed from
    epoch 0's checkpoint (best_rmse inf) overwrites ``best`` at epoch 1
    with a worse model (rmse 2.0 against 1.0)."""
    rmses = iter([1.0, 2.0, 2.0])
    monkeypatch.setattr(pt_loop, "evaluate", lambda *a, **k: {"rmse": next(rmses)})
    cfg, _, _ = _run(tmp_path, monkeypatch)

    def saved(name):
        ckpt = torch.load(f"checkpoints/t/{name}", weights_only=True)
        return ckpt["epoch"], ckpt["best_rmse"]

    assert saved("0_1.000") == (0, float("inf"))
    assert saved("1_2.000") == (1, 1.0)
    assert saved("best") == (0, 1.0)
    pt_loop.run_training(cfg.replace(resume="checkpoints/t/0_1.000"), tiny=True, device="cpu")
    assert saved("best") == (1, 2.0)


# ---- optax state -------------------------------------------------------------------

@pytest.mark.parametrize("clip", [False, True])
def test_opt_state_from_optax_then_one_step_equals_optax_f64(clip):
    """optax state with seeded non-zero moments at count 7 on the tiny
    model's parameter tree (shapes from ``flax_param_spec``, no JAX model),
    carried into the port's ``AdamW``; one step of each on the same
    gradients: equal parameters and moments in float64."""
    cfg = JxConfig(**{k: v for k, v in TINY.items()}).replace(disable_clip_grad=not clip)
    pt_cfg = PtConfig(**TINY).replace(disable_clip_grad=not clip)
    rng = np.random.default_rng(31)
    params, grads = {}, {}
    for col, path, shape in weights.flax_param_spec(pt_cfg, tiny=True):
        if col != "params":
            continue
        for tree, scale in ((params, 0.1), (grads, 0.01)):
            node = tree
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = scale * rng.standard_normal(shape)
    with enable_x64():
        tx = jx_optim.make_optimizer(cfg, total_steps=40)
        state = tx.init(params)

        def seeded(path, leaf):
            name = jax.tree_util.keystr(path)
            if name.endswith(".count"):
                return np.asarray(7, np.asarray(leaf).dtype)
            if ".mu" in name:
                return 1e-3 * rng.standard_normal(np.shape(leaf))
            if ".nu" in name:
                return 1e-5 * rng.random(np.shape(leaf))
            return np.asarray(leaf)

        state = jax.tree_util.tree_map_with_path(seeded, state)
        numpy_state = jax.tree_util.tree_map(np.asarray, state)
        updates, new_state = jax.jit(tx.update)(grads, state, params)
        ref = jax.tree_util.tree_map(np.asarray, jax.jit(optax.apply_updates)(params, updates))
        ref_state = jax.tree_util.tree_map(np.asarray, new_state)

    model = make_model(pt_cfg, tiny=True, device="cpu").double()
    model.load_state_dict({**model.state_dict(), **weights.from_flax(params, None, pt_cfg)})
    opt = pt_optim.make_optimizer(model, pt_cfg, 40)
    opt.load_state_dict(weights.opt_state_from_optax(numpy_state, pt_cfg))
    assert opt.count == 7
    named = dict(model.named_parameters())
    for k, g in weights.from_flax(grads, None, pt_cfg).items():
        named[k].grad = g
    opt.step()
    want = weights.from_flax(ref, None, pt_cfg)
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=1e-7, atol=1e-15,
                                   err_msg=k)
    got, want_state = opt.state_dict(), weights.opt_state_from_optax(ref_state, pt_cfg)
    for g in got:
        assert got[g]["count"] == want_state[g]["count"] == 8
        for key in ("mu", "nu"):
            for k, v in got[g][key].items():
                np.testing.assert_allclose(v.numpy(), want_state[g][key][k].numpy(),
                                           rtol=1e-7, atol=1e-20, err_msg=f"{g} {key} {k}")


def test_opt_state_from_optax_refuses_other_states():
    with pytest.raises(ValueError, match="multi_transform"):
        weights.opt_state_from_optax((optax.EmptyState(),), PtConfig(**TINY))


# ---- the entry point ---------------------------------------------------------------

ENTRY = ["--tiny_model", "--n_bins", "16", "--native_height", "64", "--native_width", "96",
         "--input_height", "48", "--input_width", "64", "--train_zone_num", "2",
         "--eval_zone_num_cfg", "2", "--train_patch_px", "16", "--eval_patch_px", "16",
         "--sample_uniform", "--change_embedding", "--attention_layer", "hist2image",
         "combine1", "image", "--dataset", "synthetic", "--dataset_eval", "synthetic",
         "--synthetic_length", "2", "--bs", "2", "--epochs", "1", "--name", "entry",
         "--save_dir", "results/entry", "--device", "cpu"]


@pytest.mark.parametrize("flags,item", [
    (["--multihost"], "§A 9"), (["--spatial_shards", "2"], "§A 9"),
    (["--device_pipeline", "--train_zone_random_offset", "1"], "drop one of the two flags")])
def test_entry_point_refusals(flags, item, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=item):
        pt_train_main.main(ENTRY + flags)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flags", [
    ["--device_pipeline"], ["--grad_accum", "2"], ["--remat"], ["--debug_nans"],
    ["--compute_dtype", "bfloat16", "--device_pipeline", "--grad_accum", "2", "--remat",
     "--debug_nans"]])
def test_entry_point_runs_the_one_card_options(flags, tmp_path, monkeypatch):
    """``--device_pipeline``, ``--grad_accum``, ``--remat`` and
    ``--debug_nans``, alone and together in bf16: a finite step, the batch
    made on the device under ``--device_pipeline``, anomaly mode only
    during a ``--debug_nans`` run."""
    monkeypatch.chdir(tmp_path)
    made, anomaly = [], []
    real = pt_loop.preprocess_batch

    def prep(batch, *a):
        made.append(sorted(batch))
        anomaly.append(torch.is_anomaly_enabled())
        return real(batch, *a)

    monkeypatch.setattr(pt_loop, "preprocess_batch", prep)
    trace = []
    real_run = pt_loop.run_training
    monkeypatch.setattr(pt_train_main, "run_training",
                        lambda cfg, **kw: real_run(cfg, trace=trace, **kw))
    state = pt_train_main.main(ENTRY + flags)
    assert state.step == 1 and np.isfinite(float(trace[0]["loss"]))
    assert made == ([["depth", "image_raw"]] if "--device_pipeline" in flags else [])
    assert all(a == ("--debug_nans" in flags) for a in anomaly)
    assert not torch.is_anomaly_enabled()


def test_debug_nans_names_the_step_of_a_planted_nan(tmp_path, monkeypatch):
    """A NaN planted in the image of the second step's batch: with
    ``--debug_nans`` the run stops there with ``FloatingPointError`` naming
    step 1; without it the run goes on with a NaN loss."""
    monkeypatch.chdir(tmp_path)
    real = pt_ds.SyntheticDataset.__getitem__
    calls = []

    def planted(self, i):
        s = real(self, i)
        if self.mode == "train":
            calls.append(i)
            if len(calls) == 3:  # the first sample of the second batch
                s["image"][0, 0, 0] = np.nan
        return s

    monkeypatch.setattr(pt_ds.SyntheticDataset, "__getitem__", planted)
    argv = ENTRY + ["--synthetic_length", "4"]  # two steps
    with pytest.raises(FloatingPointError, match="step 1"):
        pt_train_main.main(argv + ["--debug_nans"])
    assert not torch.is_anomaly_enabled()
    calls.clear()
    trace = []
    real_run = pt_loop.run_training
    monkeypatch.setattr(pt_train_main, "run_training",
                        lambda cfg, **kw: real_run(cfg, trace=trace, **kw))
    pt_train_main.main(argv)
    assert [np.isfinite(float(t["loss"])) for t in trace] == [True, False]


def test_device_pipeline_resume_equals_the_uninterrupted_run_bit_for_bit(tmp_path,
                                                                         monkeypatch):
    """``--device_pipeline`` over 2 epochs, and the same run resumed from its
    epoch-0 checkpoint: the draws come from (seed, step), so the resumed
    epoch's losses and the final state are equal bit for bit; the losses
    are finite and differ from the host pipeline's."""
    cfg, full, trace = _run(tmp_path, monkeypatch, device_pipeline=True, synthetic_length=8,
                            drop_hist=0.34, noise_prob=0.3, noise_sigma=0.2, noise_mean=0.17)
    assert all(np.isfinite(float(t["loss"])) for t in trace) and len(trace) == 8
    ckpt0 = next(c for c in os.listdir("checkpoints/t") if c.startswith("0_"))
    resumed_trace = []
    resumed = pt_loop.run_training(cfg.replace(resume=f"checkpoints/t/{ckpt0}"), tiny=True,
                                   device="cpu", trace=resumed_trace)
    tail = [t for t in trace if t["epoch"] == 1]
    assert len(tail) == len(resumed_trace) == 4
    for a, b in zip(tail, resumed_trace):
        assert a["indices"] == b["indices"] and torch.equal(a["loss"], b["loss"])
    _same(_state(resumed), _state(full))
    host = pt_loop.run_training(cfg.replace(device_pipeline=False, epochs=1, no_logging=True),
                                tiny=True, device="cpu", trace=(host_trace := []))
    assert host.step == 4
    assert not any(torch.equal(a["loss"], b["loss"]) for a, b in zip(trace, host_trace))


def test_entry_point_runs_with_accepted_no_ops(tmp_path, monkeypatch):
    """``--use_pallas`` and ``--safe_dw_vjp`` change nothing; ``--logging``
    overrides an argfile's ``--no_logging``."""
    monkeypatch.chdir(tmp_path)
    argfile = tmp_path / "args.txt"
    argfile.write_text("--no_logging\n--validate_every 1\n")
    state = pt_train_main.main([f"@{argfile}", "--use_pallas", "--safe_dw_vjp", "--logging"]
                               + ENTRY)
    assert state.step == 1
    assert sorted(os.listdir("checkpoints/entry"))[-1] == "best"
    assert os.path.exists("results/entry/train_log.jsonl")
