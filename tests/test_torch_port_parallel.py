"""The port's data parallelism against the JAX package on the CPU: two gloo
processes (``cfpnet_torch/parallel``) on the tiny model in float64, each on
its rows of a global batch, held against the JAX package's one-process step
on the whole batch, which ``tests/test_parallel.py`` holds against its
8-device mesh step. rtol 1e-7.

One run of two processes (``two_ranks``, the process side
``tests/test_torch_port_multihost.py::rank_worker``, which imports no JAX)
makes every case: train-mode BatchNorm over the two halves, the plain step,
``--grad_accum 2``, ``--device_pipeline`` with the JAX draws injected, one
self-supervised step, ``evaluate_sharded`` and the train loader's rows. The
tests compare its results with the JAX functions here. Crop offsets are
pinned as in ``test_torch_port_train.py``: the processes record theirs, and
the JAX model replays them."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cfpnet_torch import weights
from cfpnet_torch.config import Config as PtConfig
from cfpnet_torch.data import datasets as pt_ds
from cfpnet_torch.models.deltar import model_geometries as pt_geometries
from cfpnet_torch.parallel import launch, mesh, spatial
from cfpnet_torch.train import steps as pt_steps
from cfpnet_tpu.config import Config as JxConfig
from cfpnet_tpu.data import datasets as jx_ds
from cfpnet_tpu.data import pipeline as jx_pipe
from cfpnet_tpu.data import tof_sim_jax
from cfpnet_tpu.data.geometry import geometry_for as jx_geometry_for
from cfpnet_tpu.models.deltar import make_model as jx_make_model
from cfpnet_tpu.models.deltar import model_geometries
from cfpnet_tpu.parallel.mesh import make_mesh
from cfpnet_tpu.train import loop as jx_loop
from cfpnet_tpu.train import optim as jx_optim
from cfpnet_tpu.train import selfsup as jx_selfsup
from cfpnet_tpu.train import steps as jx_steps
from tests.test_torch_port_device_pipeline import depth_maps, jax_draws
from tests.test_torch_port_multihost import (ENV, TIMEOUT, TINY, Float64, _after, _port,
                                             recorded_offsets, to_f64)
from tests.test_torch_port_selfsup import _capture_grads, _pose_variables
from tests.test_torch_port_train import _batch
from tests.torch_port_util import close, enable_x64, random_tree

STEP = dict(TINY, bs=4, disable_clip_grad=False)  # the clip on, over the reduced gradients
PIPELINE = dict(drop_hist=0.3, noise_prob=0.3, noise_mean=0.1, noise_sigma=0.2)
SELFSUP = dict(STEP, selfsup=True, dataset="synthetic")
SEED = 7


def _variables(model, cfg, geoms, batch, seed=3):
    with enable_x64():
        shapes = jax.eval_shape(
            lambda r: model.init({"params": r, "fusion": r}, jnp.asarray(batch["image"]),
                                 jnp.asarray(batch["hist_data"]), jnp.asarray(batch["mask"]),
                                 geoms, train=True), jax.random.key(0))
        return random_tree(shapes, seed, kernel_std=0.05)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The flax variables and the cases, the two processes' results by rank
    (``rank_worker``), and what the JAX side needs."""
    cfg = JxConfig(**STEP)
    model = jx_make_model(cfg, tiny=True)
    geoms = model_geometries(cfg, "train")
    plain = _batch(cfg, 40, batch=4)
    variables = _variables(model, cfg, geoms, plain)
    state = weights.from_flax(variables["params"], variables["batch_stats"], PtConfig(**STEP))

    raw = dict(image_raw=np.random.default_rng(3).random((4, 48, 64, 3)).astype(np.float32),
               depth=depth_maps(5, batch=4, h=48, w=64)[..., None])
    key = jax.random.key(11)
    Z = cfg.train_zone_num ** 2

    scfg = JxConfig(**SELFSUP)
    pt_scfg = PtConfig(**SELFSUP)
    pairs = pt_ds.collate([pt_ds.SyntheticPairDataset(pt_scfg, "train")[i] for i in range(4)])
    depth_vars = _variables(model, scfg, geoms, pairs, seed=4)
    _, pose = _pose_variables(8, pairs["image_raw"].shape)
    joint = dict(params={"depth": depth_vars["params"], "pose": pose},
                 batch_stats=depth_vars["batch_stats"])

    rng = np.random.default_rng(9)
    bn = {}
    for channel_dim, shape in ((1, (4, 6, 5, 7)), (-1, (4, 5, 7, 6))):
        bn[channel_dim] = dict(
            C=6, eps=1e-3, x=3.0 + 2.0 * rng.standard_normal(shape),
            g=rng.standard_normal(shape),
            start=dict(weight=rng.uniform(0.5, 1.5, 6), bias=0.2 * rng.standard_normal(6),
                       running_mean=0.3 * rng.standard_normal(6),
                       running_var=rng.uniform(0.5, 1.5, 6)))
    inp = dict(
        state=state, bn=bn,
        plain=dict(config=STEP, batch=plain, seed=SEED),
        grad_accum=dict(config=dict(STEP, grad_accum=2), batch=_batch(cfg, 41, batch=4),
                        seed=SEED + 1),
        device_pipeline=dict(config=dict(STEP, device_pipeline=True, **PIPELINE), batch=raw,
                             draws=jax_draws(key, 4, Z), seed=SEED),
        selfsup=dict(config=SELFSUP, batch=pairs, seed=SEED + 2,
                     state=weights.selfsup_from_flax(joint["params"], joint["batch_stats"],
                                                     pt_scfg)),
        evaluate=dict(config=dict(TINY, eval_bs=2), length=5),
        loader=dict(config=dict(TINY, bs=4, seed=5), length=10))
    tmp = tmp_path_factory.mktemp("two_ranks")
    torch.save(inp, tmp / "inputs.pt")
    with pytest.MonkeyPatch.context() as mp:  # the processes start with this environment
        for k, v in ENV.items():
            mp.setenv(k, v)
        launch.spawn("tests.test_torch_port_multihost:rank_worker", 2,
                     (str(tmp / "inputs.pt"), str(tmp)), timeout=4 * TIMEOUT)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in (0, 1)]
    assert [(r["world"], r["rank"], r["jax_imported"]) for r in ranks] == [(2, 0, False),
                                                                            (2, 1, False)]
    return dict(inp=inp, ranks=ranks, model=model, geoms=geoms, variables=variables,
                joint=joint, key=key, pipeline_geometry=jx_geometry_for(
                    JxConfig(**STEP, device_pipeline=True, **PIPELINE), "train"))


@contextlib.contextmanager
def jax_offsets(drawn):
    """The JAX model's ``jax.random.randint`` replaying the processes' crop
    offsets while inside (``test_torch_port_train.RecordedOffsets``)."""
    it = iter([(o, hi) for (off, his) in drawn for o, hi in zip(off, his)])

    def randint(key, shape, minval, maxval, *args, **kw):
        off, hi = next(it)
        assert (minval, maxval) == (0, hi), (minval, maxval, hi)
        return jnp.asarray(off, kw.get("dtype", int))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "randint", randint)
        yield it


def _global(parts, accum=1):
    """The global batch of the processes' local batches (``rank_rows``)."""
    out = {}
    for k in parts[0]:
        rows = np.concatenate([mesh.rank_rows(4, 2, r, accum) for r in (0, 1)])
        glued = np.concatenate([p[k].numpy() for p in parts])
        out[k] = glued[np.argsort(rows)]
    return out


def _jx_state(cfg, model, params, batch_stats, tx=None, cls=jx_steps.TrainState):
    return cls.create(apply_fn=model.apply, params=params, batch_stats=batch_stats,
                      tx=tx or jx_optim.make_optimizer(cfg, total_steps=20))


def _assert_state(got, state, cfg, what, to_port=weights.from_flax):
    """A process's state_dict after the step against the JAX state's,
    through the weight bridge ``to_port``."""
    ref = to_port(jax.tree_util.tree_map(np.asarray, state.params),
                  jax.tree_util.tree_map(np.asarray, state.batch_stats), PtConfig(**STEP))
    assert set(ref) == set(got)
    # the schedules may differ in the last bit of their cosine: 2^-22 of max_lr
    for k, s in got.items():
        np.testing.assert_allclose(s.numpy(), ref[k].numpy(), rtol=1e-7,
                                   atol=cfg.lr * 2.0 ** -22, err_msg=f"{what}: {k}")


@pytest.fixture(scope="module")
def jax_step(two_ranks):
    """The JAX package's one-process step on the tiny model (clip on),
    traced once with the offsets of step seed ``SEED``: (step, its start)."""
    cfg = JxConfig(**STEP)
    v = two_ranks["variables"]
    with enable_x64():
        step = jax.jit(jx_steps.make_train_step(two_ranks["model"], cfg, two_ranks["geoms"],
                                                jit=False))
    return cfg, step, _jx_state(cfg, two_ranks["model"], v["params"], v["batch_stats"])


def _jax_result(jax_step, batch, offsets):
    """The JAX step on ``batch`` with the crop offsets ``offsets``."""
    _, step, start = jax_step
    with jax_offsets(offsets), enable_x64():
        return step(start, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))


def _assert_step(got, ref, cfg, name):
    """A step's loss and state (a process's or a grid's) against the JAX
    step's (state, loss)."""
    state, loss = ref
    close(float(got["loss"]), float(loss))
    _assert_state(got["state"], state, cfg, name)


@pytest.fixture(scope="module")
def jax_plain(two_ranks, jax_step):
    """The JAX step's (state, loss) on the plain case's global batch."""
    inp = two_ranks["inp"]["plain"]
    return _jax_result(jax_step, {k: v.numpy() for k, v in to_f64(inp["batch"]).items()},
                       two_ranks["ranks"][0]["plain"]["offsets"])


@pytest.fixture(scope="module")
def jax_accum(two_ranks):
    """The JAX step under ``--grad_accum 2`` with its microbatch loop
    unrolled (``pre_split``, as ``test_torch_port_train.py``), compiled
    once: (config, state, loss) on the case's global batch."""
    cfg = JxConfig(**dict(STEP, grad_accum=2))
    batch = {k: v.numpy() for k, v in to_f64(two_ranks["inp"]["grad_accum"]["batch"]).items()}
    v = two_ranks["variables"]
    with jax_offsets(two_ranks["ranks"][0]["grad_accum"]["offsets"]) as left, enable_x64():
        step = jx_steps.make_train_step(two_ranks["model"], cfg, two_ranks["geoms"], jit=False,
                                        pre_split=True)
        split = {k: jnp.asarray(a.reshape((2, 2) + a.shape[1:])) for k, a in batch.items()}
        state, loss = jax.jit(step)(_jx_state(cfg, two_ranks["model"], v["params"],
                                              v["batch_stats"]), split, jax.random.key(0))
        assert next(left, None) is None
    return cfg, (state, loss)


def _held_against_jax(two_ranks, jax_step, name, ref=None):
    cfg = jax_step[0]
    r0, r1 = two_ranks["ranks"][0][name], two_ranks["ranks"][1][name]
    # one trace serves both cases: the same step seed, the same offsets
    assert r0["offsets"] == r1["offsets"] == two_ranks["ranks"][0]["plain"]["offsets"]
    assert len(r0["offsets"]) == 3
    batch = _global([r0["batch"], r1["batch"]])
    if ref is None:
        ref = _jax_result(jax_step, batch, r0["offsets"])
    for r in (r0, r1):
        _assert_step(r, ref, cfg, name)
    return batch


def test_dp_world_size_equals_make_mesh():
    """``dp_world_size`` is the size of the JAX ``make_mesh`` over the same
    number of devices (conftest's 8 virtual CPU devices)."""
    for n in (1, 2, 3, 4, 8):
        for dp in (0, 1, 2, 3, 5, 8, 9):
            for bs in (None, 1, 2, 4, 6, 7, 12, 16):
                want = make_mesh(dp, devices=jax.devices()[:n], batch_size=bs).devices.size
                assert mesh.dp_world_size(dp, n, bs) == want, (n, dp, bs)


@pytest.mark.parametrize("channel_dim", [1, -1])
def test_batchnorm_over_two_ranks_equals_flax_on_the_batch(two_ranks, channel_dim):
    """Train-mode BatchNorm, each process on half the batch: the output,
    the gradients of x, scale and bias (of sum(y * g)), and the running
    statistics equal flax BatchNorm on the whole batch."""
    import flax.linen as nn

    case = two_ranks["inp"]["bn"][channel_dim]
    got = [r["bn"][channel_dim] for r in two_ranks["ranks"]]
    s = case["start"]
    variables = {"params": {"scale": s["weight"], "bias": s["bias"]},
                 "batch_stats": {"mean": s["running_mean"], "var": s["running_var"]}}
    bn = nn.BatchNorm(momentum=0.9, epsilon=case["eps"], axis=channel_dim, dtype=jnp.float64,
                      param_dtype=jnp.float64)
    with enable_x64():
        def f(params, x):
            return bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                            use_running_average=False, mutable=["batch_stats"])

        y, vjp, upd = jax.vjp(f, variables["params"], jnp.asarray(case["x"]), has_aux=True)
        dparams, dx = vjp(jnp.asarray(case["g"]))
    close(np.concatenate([g["y"].numpy() for g in got]), np.asarray(y))
    close(np.concatenate([g["dx"].numpy() for g in got]), np.asarray(dx))
    for g in got:
        close(g["dscale"].numpy(), np.asarray(dparams["scale"]))
        close(g["dbias"].numpy(), np.asarray(dparams["bias"]))
        close(g["mean"].numpy(), np.asarray(upd["batch_stats"]["mean"]))
        close(g["var"].numpy(), np.asarray(upd["batch_stats"]["var"]))


def test_two_rank_step_equals_the_jax_step_f64(two_ranks, jax_step, jax_plain):
    """The plain step (bs 4 as 2 + 2 rows): the global loss on both
    processes, every parameter and running statistic after it."""
    batch = _held_against_jax(two_ranks, jax_step, "plain", jax_plain)
    for k, v in to_f64(two_ranks["inp"]["plain"]["batch"]).items():
        np.testing.assert_array_equal(batch[k], v.numpy(), k)


def test_two_rank_device_pipeline_step_equals_jax_f64(two_ranks, jax_step):
    """``--device_pipeline``: each process makes its rows of the batch from
    its raw rows with the global batch's draws (the JAX function's own,
    injected), equal to the JAX transform's rows (histograms, masks, depths
    bit for bit, the image within 1e-6, as
    ``test_torch_port_device_pipeline.py``); then the step on them equals
    the JAX step on the batch they make."""
    inp = two_ranks["inp"]["device_pipeline"]
    batch = _held_against_jax(two_ranks, jax_step, "device_pipeline")
    ref = tof_sim_jax.device_preprocess(  # in float32, as its draws were made
        jnp.asarray(inp["batch"]["image_raw"]), jnp.asarray(inp["batch"]["depth"][..., 0]),
        two_ranks["key"], two_ranks["pipeline_geometry"], max_distance=4.0,
        zone_sample_num=16, train=True, sample_uniform=True, **PIPELINE)
    for k in ("depth", "hist_data", "mask"):
        np.testing.assert_array_equal(batch[k], np.asarray(ref[k]).astype(batch[k].dtype), k)
    np.testing.assert_allclose(batch["image"], np.asarray(ref["image"]), rtol=0, atol=1e-6)
    assert not np.array_equal(batch["image"][:2], batch["image"][2:])


def test_two_rank_grad_accum_step_equals_jax_f64(two_ranks, jax_accum):
    """``--grad_accum 2`` at bs 4: each process holds its row of each
    microbatch (``rank_rows``), the statistics thread through the two
    global microbatches; against the JAX step with its microbatch loop
    unrolled (``jax_accum``)."""
    cfg, ref = jax_accum
    r0, r1 = (r["grad_accum"] for r in two_ranks["ranks"])
    assert r0["offsets"] == r1["offsets"] and len(r0["offsets"]) == 6
    batch = _global([r0["batch"], r1["batch"]], accum=2)
    np.testing.assert_array_equal(batch["image"],
                                  two_ranks["inp"]["grad_accum"]["batch"]["image"])
    for r in (r0, r1):
        _assert_step(r, ref, cfg, "grad_accum")


def _spatial_step(two_ranks, name, dp, sp, dtype="float32"):
    """One step of case ``name`` in this process on a ``dp x sp`` grid of
    CPU devices (``--spatial_shards sp``): its loss, offsets and state."""
    sc = two_ranks["inp"][name]
    cfg = PtConfig(**sc["config"]).replace(spatial_shards=sp, safe_dw_vjp=True)
    port = _port(two_ranks["inp"]["state"], cfg)
    state = pt_steps.create_train_state(port, cfg, total_steps=20)
    grid = spatial.make_mesh_2d(dp, sp, ["cpu"] * (dp * sp))
    with recorded_offsets() as drawn:
        loss = pt_steps.make_train_step(port, cfg, pt_geometries(cfg, "train"), grid)(
            state, to_f64(sc["batch"]), sc["seed"])
    return _after(port, dict(loss=loss, offsets=drawn))


@pytest.mark.parametrize("dp,sp", [(1, 2), (2, 2)])
def test_spatial_step_equals_the_jax_step_f64(two_ranks, jax_step, jax_plain, dp, sp):
    """The plain step (bs 4) in one process with each image's rows split
    over ``sp`` shards and the batch over ``dp`` data groups: the loss,
    every parameter and running statistic of the JAX step, the crop
    offsets drawn once a fusion for the whole batch."""
    got = _spatial_step(two_ranks, "plain", dp, sp)
    assert got["offsets"] == two_ranks["ranks"][0]["plain"]["offsets"]
    _assert_step(got, jax_plain, jax_step[0], f"spatial {dp}x{sp}")


@pytest.mark.parametrize("dp,sp", [(1, 2), (2, 2)])
def test_spatial_grad_accum_step_equals_jax_f64(two_ranks, jax_accum, dp, sp):
    """``--grad_accum 2`` on the grid: microbatch-major rows (microbatch i
    is rows [2i, 2i + 2), its images over the data groups), against the
    unrolled JAX step."""
    cfg, ref = jax_accum
    got = _spatial_step(two_ranks, "grad_accum", dp, sp)
    assert got["offsets"] == two_ranks["ranks"][0]["grad_accum"]["offsets"]
    _assert_step(got, ref, cfg, f"spatial grad_accum {dp}x{sp}")


def test_two_rank_selfsup_step_equals_jax_f64(two_ranks):
    """One self-supervised step (clip on) at bs 4 as 2 + 2 pairs: the four
    terms (global means), every depth and pose gradient after the
    all-reduce, every parameter and statistic, against
    ``make_selfsup_train_step`` on the whole batch."""
    from cfpnet_torch.train.selfsup import LOSS_TERMS

    inp = two_ranks["inp"]["selfsup"]
    cfg = JxConfig(**SELFSUP)
    joint = two_ranks["joint"]
    r0, r1 = (r["selfsup"] for r in two_ranks["ranks"])
    assert r0["offsets"] == r1["offsets"]
    with jax_offsets(r0["offsets"]) as left, enable_x64():
        batch = {k: jnp.asarray(v if v.dtype == bool else v.astype(np.float64))
                 for k, v in inp["batch"].items()}
        tx = optax.chain(_capture_grads(), jx_optim.make_optimizer(cfg, total_steps=20))
        start = _jx_state(cfg, two_ranks["model"], joint["params"], joint["batch_stats"], tx,
                          cls=jx_selfsup.SelfSupState)
        step = jx_selfsup.make_selfsup_train_step(two_ranks["model"], cfg, two_ranks["geoms"],
                                                  jx_geometry_for(cfg, "train"))
        state, m = step(start, batch, jax.random.key(0))
        assert next(left, None) is None
    to_port = weights.selfsup_from_flax
    ref_grads = to_port(jax.tree_util.tree_map(np.asarray, state.opt_state[0]), None,
                        PtConfig(**SELFSUP))
    norm = np.sqrt(sum((g.numpy() ** 2).sum() for g in ref_grads.values()))
    for r in (r0, r1):
        for k in LOSS_TERMS:
            close(float(r["terms"][k]), float(m[k]))
        for k, g in r["grads"].items():
            np.testing.assert_allclose(g.numpy(), ref_grads[k].numpy(), rtol=1e-7,
                                       atol=1e-12 * norm, err_msg=k)
        _assert_state(r["state"], state, cfg, "selfsup", to_port=to_port)


@pytest.mark.parametrize("name", ["plain", "grad_accum", "device_pipeline", "selfsup"])
def test_the_ranks_end_bit_identical(two_ranks, name):
    """After each step both processes hold the same parameters, BatchNorm
    statistics and gradients, and the same loss, bit for bit."""
    r0, r1 = (r[name] for r in two_ranks["ranks"])
    for part in ("state", "grads"):
        assert set(r0[part]) == set(r1[part])
        for k in r0[part]:
            assert torch.equal(r0[part][k], r1[part][k]), (part, k)
    losses = [r["terms"]["loss"] if name == "selfsup" else r["loss"] for r in (r0, r1)]
    assert torch.equal(*losses)


def test_evaluate_sharded_equals_jax_evaluate_f64(two_ranks):
    """5 images at ``--eval_bs 2`` strided over the two processes (3 + 2, a
    ragged batch on each): both return the same merged metrics, equal to
    the JAX package's ``evaluate`` of the 5 images; the save hook saw each
    dataset index once."""
    got = [r["evaluate"] for r in two_ranks["ranks"]]
    assert got[0]["metrics"] == got[1]["metrics"]
    assert got[0]["indices"] == [0, 2, 4] and got[1]["indices"] == [1, 3]
    cfg = JxConfig(**dict(TINY, eval_bs=2))
    v = two_ranks["variables"]
    ds = Float64(pt_ds.SyntheticDataset(PtConfig(**dict(TINY, eval_bs=2)), "online_eval", 5))
    with enable_x64():
        want = jx_loop.evaluate(jx_make_model(cfg, tiny=True), cfg, v["params"],
                                v["batch_stats"], jx_pipe.DataLoader(ds, 2))
    assert set(want) == set(got[0]["metrics"]) and len(want) == 9
    for k in want:
        assert got[0]["metrics"][k] == pytest.approx(want[k], rel=1e-7, abs=1e-12), k


@pytest.mark.parametrize("accum", [1, 2])
def test_loader_rank_rows_concatenate_to_the_jax_batch(two_ranks, accum):
    """Each process's train loader decodes its rows of each global batch:
    laid out by ``rank_rows`` (contiguous; under ``--grad_accum 2`` its
    share of each microbatch), they are the JAX loader's batches, indices
    and arrays."""
    inp = two_ranks["inp"]["loader"]
    cfg = JxConfig(**inp["config"])
    jx = jx_pipe.DataLoader(jx_ds.SyntheticDataset(cfg, "train", inp["length"]), cfg.bs,
                            shuffle=True, drop_last=True, seed=cfg.seed)
    jx_order = np.asarray(jx._index_order())  # epoch 0's
    want = list(jx)
    parts = [r["loaders"][accum] for r in two_ranks["ranks"]]
    assert len(want) == len(parts[0]) == len(parts[1]) == 2
    order = np.argsort(np.concatenate([mesh.rank_rows(4, 2, r, accum) for r in (0, 1)]))
    for b, ref in enumerate(want):
        (i0, b0), (i1, b1) = parts[0][b], parts[1][b]
        idx = np.concatenate([i0, i1])[order]
        np.testing.assert_array_equal(idx, jx_order[4 * b:4 * b + 4])
        assert set(b0) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(np.concatenate([b0[k], b1[k]])[order],
                                          np.asarray(ref[k]), k)


def test_new_modules_import_no_jax():
    """The data-parallel modules, the entry point that spawns processes and
    the processes' test module are among the files that
    ``test_port_imports_no_jax`` scans (the test module here), and import
    nothing of the JAX stack; the spawned processes had no JAX loaded
    (``two_ranks``)."""
    from tests.test_torch_port_bridge import FORBIDDEN, ROOT, _imports

    scanned = set((ROOT / "cfpnet_torch").rglob("*.py"))
    for rel in ("cfpnet_torch/parallel/__init__.py", "cfpnet_torch/parallel/mesh.py",
                "cfpnet_torch/parallel/launch.py", "cfpnet_torch/parallel/spatial.py",
                "cfpnet_torch/train/__main__.py", "tests/test_torch_port_multihost.py"):
        assert rel.startswith("tests/") or (ROOT / rel) in scanned, rel
        assert not set(_imports(ROOT / rel)) & set(FORBIDDEN), rel
