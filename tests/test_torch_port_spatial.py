"""The port's spatial partitioning (``--spatial_shards``,
``cfpnet_torch/parallel/spatial.py``) against the JAX package on the CPU.

One process drives a grid of repeated CPU devices (``["cpu"] * n``), as the
library allows; each image's rows are split over the grid's shards. In
float64 at rtol 1e-7:

- each row-sharded op against its one-device port op and against
  flax/``lax``: stride-2 and depthwise TF-SAME convs, the decoder's
  symmetric 3x3 conv, train-mode BatchNorm (output, gradients, running
  statistics), squeeze-excite, the align-corners resize and the SILog
  loss, over heights 2, 13, 15 and 64 and 2, 3 and 4 shards (at height 2
  some shards own no rows);
- the tiny eval forward on grids (1, 2), (2, 2) and (2, 4) against the
  JAX forward (at 1/32 of 64 rows, 2 rows over 4 shards);
- ``evaluate`` with ``spatial_shards=4`` against the JAX ``evaluate``;
- the mesh and batch refusals against JAX's own on the same inputs (the
  conftest's 8 virtual CPU devices), and ``run_training``'s;
- ``run_training`` on a 2 x 2 grid against the one-device run.

The train step on a grid is held against the JAX step in
``tests/test_torch_port_parallel.py``; its bf16 form in
``tests/test_torch_port_train_bf16.py``; the sweep in
``tests/test_torch_port_sweep.py``. JAX compiles each function once, at
module scope."""

import functools
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from cfpnet_torch import weights
from cfpnet_torch.config import Config as PtConfig
from cfpnet_torch.data import datasets as pt_ds
from cfpnet_torch.data.pipeline import DataLoader
from cfpnet_torch.models.decoder import UpSampleBN
from cfpnet_torch.models.deltar import make_model as pt_make_model
from cfpnet_torch.models.efficientnetv2 import Conv2dSame, SqueezeExcite
from cfpnet_torch.models.layers import BatchNorm
from cfpnet_torch.ops.interp import resize_bilinear_align_corners
from cfpnet_torch.parallel import mesh, spatial
from cfpnet_torch.train import __main__ as pt_train_main
from cfpnet_torch.train import loop as pt_loop
from cfpnet_torch.train import steps as pt_steps
from cfpnet_torch.train.losses import silog_loss, silog_loss_rows
from cfpnet_tpu.config import Config as JxConfig
from cfpnet_tpu.models.deltar import make_model as jx_make_model
from cfpnet_tpu.models.deltar import model_geometries
from cfpnet_tpu.models.efficientnetv2 import SqueezeExcite as JxSqueezeExcite
from cfpnet_tpu.ops.interp import resize_bilinear_align_corners as jx_resize
from cfpnet_tpu.parallel import mesh as jx_mesh
from cfpnet_tpu.train import loop as jx_loop
from cfpnet_tpu.train import losses as jx_losses
from cfpnet_tpu.train import steps as jx_steps
from tests.test_torch_port_multihost import TINY, Float64
from tests.torch_port_util import close, enable_x64, random_tree, t

HEIGHTS = (2, 13, 15, 64)
SHARDS = (2, 3, 4)
W = 7  # the maps' width: never split


def _grid(dp, sp):
    return spatial.make_mesh_2d(dp, sp, ["cpu"] * (dp * sp))


def _rng(*key):
    return np.random.default_rng(list(key))


def _nhwc(x):
    return np.ascontiguousarray(np.moveaxis(x, 1, -1))


def test_row_bounds_split_evenly_and_allow_empty_shards():
    assert spatial.row_bounds(15, 2) == [0, 7, 15]
    assert spatial.row_bounds(13, 2) == [0, 6, 13]
    assert spatial.row_bounds(2, 4) == [0, 0, 1, 1, 2]  # shards 0 and 2 own no rows
    for H in range(0, 20):
        for sp in SHARDS:
            b = spatial.row_bounds(H, sp)
            sizes = np.diff(b)
            assert b[0] == 0 and b[-1] == H and sizes.max() - sizes.min() <= 1


@pytest.mark.parametrize("sp", SHARDS)
@pytest.mark.parametrize("H", HEIGHTS)
def test_rows_reads_any_window_with_zeros_outside(H, sp):
    x = torch.from_numpy(_rng(H, sp).standard_normal((2, 3, H, W)))
    X = spatial.scatter(x, _grid(2, sp))
    padded = torch.cat([torch.zeros(2, 3, 3, W, dtype=x.dtype), x,
                        torch.zeros(2, 3, 3, W, dtype=x.dtype)], 2)
    for d in range(2):
        for a in range(-3, H + 3):
            for b in (a, a + 1, min(a + 4, H + 3)):
                got = spatial.rows(X[d], a, b, "cpu")
                assert torch.equal(got, padded[d:d + 1, :, a + 3:b + 3]), (d, a, b)
    assert torch.equal(spatial.gather(X, "cpu"), x)


# ---- row-sharded ops against the one-device op and flax/lax ---------------------
# Each case's inputs depend on the height alone, so that JAX computes (and
# compiles) each reference once a height, whatever the shard count.

CONVS = {  # name: (module, lax padding)
    "same_stride2": (lambda: Conv2dSame(4, 6, 3, 2), "SAME"),
    "same_stride2_k5": (lambda: Conv2dSame(4, 6, 5, 2), "SAME"),
    "same_depthwise": (lambda: Conv2dSame(4, 4, 3, 1, groups=4), "SAME"),
    "symmetric_3x3": (lambda: nn.Conv2d(4, 6, 3, padding=1), ((1, 1), (1, 1))),
}


def _conv_case(name, H):
    torch.manual_seed(H)
    return CONVS[name][0]().double(), t(_rng(H, 1).standard_normal((4, 4, H, W)))


@functools.lru_cache(maxsize=None)
def _lax_conv(name, H):
    conv, x = _conv_case(name, H)
    w = conv.weight.detach().numpy()
    with enable_x64():
        y = jax.lax.conv_general_dilated(
            jnp.asarray(_nhwc(x.numpy())), jnp.asarray(np.transpose(w, (2, 3, 1, 0))),
            conv.stride, CONVS[name][1], dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=conv.groups)
        if conv.bias is not None:
            y = y + jnp.asarray(conv.bias.detach().numpy())
        return np.moveaxis(np.asarray(y), -1, 1)


@pytest.mark.parametrize("sp", SHARDS)
@pytest.mark.parametrize("H", HEIGHTS)
@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv_rows_equal_the_conv_and_lax(name, H, sp):
    """Stride-2 TF-SAME (the padding of the global height), the depthwise
    SAME conv and the decoder's symmetric 3x3 conv: each shard's window of
    the map, zeros outside it."""
    conv, x = _conv_case(name, H)
    with torch.no_grad():
        got = spatial.gather(spatial.apply_rows(conv, spatial.scatter(x, _grid(2, sp)), None),
                             "cpu").numpy()
        close(got, conv(x).numpy())
    close(got, _lax_conv(name, H))


def _bn_case(H):
    rng = _rng(H, 2)
    x = 3.0 + 2.0 * rng.standard_normal((4, 5, H, W))
    start = dict(weight=rng.uniform(0.5, 1.5, 5), bias=0.2 * rng.standard_normal(5),
                 running_mean=0.3 * rng.standard_normal(5), running_var=rng.uniform(0.5, 1.5, 5))
    return x, rng.standard_normal(x.shape), start


@functools.lru_cache(maxsize=None)
def _flax_bn(H):
    x, _, start = _bn_case(H)
    bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-3, axis=-1, dtype=jnp.float64,
                       param_dtype=jnp.float64)
    with enable_x64():
        y, upd = bn.apply({"params": {"scale": start["weight"], "bias": start["bias"]},
                           "batch_stats": {"mean": start["running_mean"],
                                           "var": start["running_var"]}},
                          jnp.asarray(_nhwc(x)), use_running_average=False,
                          mutable=["batch_stats"])
    return np.asarray(y), np.asarray(upd["batch_stats"]["mean"]), np.asarray(
        upd["batch_stats"]["var"])


@pytest.mark.parametrize("sp", SHARDS)
@pytest.mark.parametrize("H", HEIGHTS)
def test_batchnorm_rows_equal_flax_in_training(H, sp):
    """Train-mode BatchNorm over every shard of two data groups: the
    output and running statistics against flax on the whole batch; the
    gradients of x, scale and bias against the one-device BatchNorm."""
    x, g, start = _bn_case(H)

    def port():
        bn = BatchNorm(5, 1e-3).double().train()
        bn.load_state_dict({k: t(v) for k, v in start.items()})
        return bn

    sharded, one = port(), port()
    xs, x1 = t(x).requires_grad_(), t(x).requires_grad_()
    grid = _grid(2, sp)
    y = spatial.gather(sharded.forward_rows(spatial.scatter(xs, grid), grid), "cpu")
    (y * t(g)).sum().backward()
    y1 = one(x1)
    (y1 * t(g)).sum().backward()
    for a, b in ((y, y1), (xs.grad, x1.grad), (sharded.weight.grad, one.weight.grad),
                 (sharded.bias.grad, one.bias.grad), (sharded.running_mean, one.running_mean),
                 (sharded.running_var, one.running_var)):
        close(a.detach().numpy(), b.detach().numpy())
    ref, mean, var = _flax_bn(H)
    close(_nhwc(y.detach().numpy()), ref)
    close(sharded.running_mean.numpy(), mean)
    close(sharded.running_var.numpy(), var)


def _se_case(H):
    rng = _rng(H, 3)
    x = rng.standard_normal((4, 6, H, W))
    se = SqueezeExcite(6, 2).double()
    with torch.no_grad():
        for p in se.parameters():
            p.copy_(t(0.5 * rng.standard_normal(tuple(p.shape))))
    return se, x


@functools.lru_cache(maxsize=None)
def _flax_se(H):
    se, x = _se_case(H)
    params = {n: {"kernel": np.transpose(getattr(se, n).weight.detach().numpy(), (2, 3, 1, 0)),
                  "bias": getattr(se, n).bias.detach().numpy()}
              for n in ("conv_reduce", "conv_expand")}
    with enable_x64():
        return np.asarray(JxSqueezeExcite(2).apply({"params": params}, jnp.asarray(_nhwc(x))))


@pytest.mark.parametrize("sp", SHARDS)
@pytest.mark.parametrize("H", HEIGHTS)
def test_squeeze_excite_rows_take_the_global_mean(H, sp):
    se, x = _se_case(H)
    grid = _grid(2, sp)
    with torch.no_grad():
        got = spatial.gather(se.forward_rows(spatial.scatter(t(x), grid), grid), "cpu").numpy()
        close(got, se(t(x)).numpy())
    close(_nhwc(got), _flax_se(H))


def _resize_sizes(H):
    """Up 2x (the decoder), up by an odd size (the loss), and to the same
    height."""
    return ((2 * H, 2 * W), (2 * H + 3, W + 2), (H, 2 * W))


@functools.lru_cache(maxsize=None)
def _jax_resize(H):
    x = _rng(H, 4).standard_normal((4, H, W, 3))
    with enable_x64():
        return x, [np.asarray(jx_resize(jnp.asarray(x), h, w)) for h, w in _resize_sizes(H)]


@pytest.mark.parametrize("sp", SHARDS)
@pytest.mark.parametrize("H", HEIGHTS)
def test_resize_rows_equal_the_resize(H, sp):
    """Each shard takes its rows of the interpolation matrix."""
    x, refs = _jax_resize(H)
    grid = _grid(2, sp)
    for (out_h, out_w), ref in zip(_resize_sizes(H), refs):
        got = spatial.gather(spatial.resize_rows(spatial.scatter(t(x), grid, dim=1), out_h,
                                                 out_w), "cpu", dim=1).numpy()
        close(got, resize_bilinear_align_corners(t(x), out_h, out_w).numpy())
        close(got, ref)


@functools.lru_cache(maxsize=None)
def _silog_case(H):
    rng = _rng(H, 5)
    pred = rng.uniform(0.5, 4.0, (4, (H + 1) // 2, W, 1))
    target = rng.uniform(0.3, 6.0, (4, H, 2 * W, 1))
    target[rng.random(target.shape) < 0.2] = 0.0
    with enable_x64():
        ref = jx_losses.silog_loss(jnp.asarray(pred), jnp.asarray(target),
                                   jnp.asarray(target > 1e-3))
    return pred, target, float(ref)


@pytest.mark.parametrize("sp", SHARDS)
@pytest.mark.parametrize("H", HEIGHTS[1:])
def test_silog_rows_equal_the_loss(H, sp):
    """The interpolated SILog loss over masked pixels, its two passes over
    the shards' sums, and its gradient."""
    pred, target, ref = _silog_case(H)
    grid = _grid(2, sp)
    ps, p1 = t(pred).requires_grad_(), t(pred).requires_grad_()
    tgt = spatial.scatter(t(target), grid, dim=1)
    got = silog_loss_rows(spatial.scatter(ps, grid, dim=1), tgt,
                          spatial.each(lambda d: d > 1e-3, tgt), grid)
    one = silog_loss(p1, t(target), t(target) > 1e-3)
    got.backward()
    one.backward()
    close(float(got.detach()), float(one.detach()))
    close(ps.grad.numpy(), p1.grad.numpy())
    close(float(got.detach()), ref)


def test_upsample_block_rows_equal_the_block():
    """``UpSampleBN``: resize to the skip's global size, concat, two 3x3
    convs and BatchNorms, in training."""
    torch.manual_seed(1)
    up = UpSampleBN(6 + 4, 5).double().train()
    twin = UpSampleBN(6 + 4, 5).double().train()
    twin.load_state_dict(up.state_dict())
    rng = _rng(6)
    x, skip = t(rng.standard_normal((2, 6, 4, W))), t(rng.standard_normal((2, 4, 8, 2 * W)))
    grid = _grid(2, 3)
    got = spatial.gather(up.forward_rows(spatial.scatter(x, grid), spatial.scatter(skip, grid),
                                         grid), "cpu")
    close(got.detach().numpy(), twin(x, skip).detach().numpy())
    close(up.state_dict()["_net.4.running_var"].numpy(),
          twin.state_dict()["_net.4.running_var"].numpy())


# ---- the tiny model ---------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The flax tiny model in float64 on random weights, its eval forward
    and eval steps (each compiled once), the port's tiny model on the same
    weights, and two images."""
    cfg = JxConfig(**TINY)
    geoms = model_geometries(cfg, "online_eval")
    rng = np.random.default_rng(0)
    Z = cfg.eval_zone_num ** 2
    img = rng.standard_normal((2, cfg.native_height, cfg.native_width, 3))
    hist = np.abs(rng.standard_normal((2, Z, cfg.zone_sample_num))) * 2 + 0.5
    mask = rng.random((2, Z)) > 0.25
    model = jx_make_model(cfg, tiny=True)
    with enable_x64():
        shapes = jax.eval_shape(
            lambda r: model.init({"params": r, "fusion": r}, jnp.asarray(img), jnp.asarray(hist),
                                 jnp.asarray(mask), geoms), jax.random.key(0))
        variables = random_tree(shapes, 1, kernel_std=0.05)
        fwd = jax.jit(lambda v, i, h, m: model.apply(v, i, h, m, geoms, train=False))
        ref = [np.asarray(a) for a in fwd(variables, img, hist, mask)[:3]]
    port = pt_make_model(PtConfig(**TINY), tiny=True, device="cpu").double()
    port.load_state_dict(weights.from_flax(variables["params"], variables["batch_stats"], cfg),
                         strict=True)
    return dict(cfg=cfg, geoms=geoms, model=model, variables=variables, port=port,
                inputs=(img, hist, mask), ref=ref)


@pytest.mark.parametrize("dp,sp", [(1, 2), (2, 2), (2, 4)])
def test_tiny_eval_forward_on_a_grid_equals_jax_f64(tiny, dp, sp):
    """bin edges, pred and prob of the row-sharded forward; at (2, 4) the
    1/32 scale's 2 rows leave two of the four shards empty."""
    img, hist, mask = tiny["inputs"]
    grid = _grid(dp, sp)
    placed = spatial.shard_batch_spatial(dict(image=t(img), hist_data=t(hist), mask=t(mask)),
                                         grid)
    with torch.no_grad():
        edges, pred, prob, none = tiny["port"](placed["image"], placed["hist_data"],
                                               placed["mask"], tiny["geoms"], grid=grid)
    assert none is None
    assert [[x.shape[1] for x in parts] for parts in pred] == [
        list(np.diff(spatial.row_bounds(32, sp)))] * dp
    got = [edges.numpy(), spatial.gather(pred, "cpu", 1).numpy(),
           spatial.gather(prob, "cpu", 1).numpy()]
    for g, r in zip(got, tiny["ref"]):
        assert g.shape == r.shape
        close(g, r)


def test_evaluate_with_four_shards_equals_jax_evaluate_f64(tiny, capsys):
    """5 images at ``--eval_bs 2`` (a ragged last batch) on four devices
    with ``spatial_shards=4`` (a 1 x 4 grid): the nine metrics of the JAX
    ``evaluate``; the save hook sees each image once."""
    cfg = PtConfig(**dict(TINY, eval_bs=2, spatial_shards=4))
    ds = Float64(pt_ds.SyntheticDataset(cfg, "online_eval", 5))
    seen = []
    got = pt_loop.evaluate(tiny["port"], cfg, DataLoader(ds, 2, device="cpu"),
                           per_image_hook=lambda i, p, b, j: seen.append((i, p.shape)),
                           devices=["cpu"] * 4)
    assert seen == [(i, (64, 96)) for i in range(5)]
    v = tiny["variables"]
    with enable_x64():
        want = jx_loop.evaluate(tiny["model"], tiny["cfg"].replace(eval_bs=2), v["params"],
                                v["batch_stats"], jx_pipe_loader(ds, 2))
    assert set(want) == set(got) and len(want) == 9
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-7, abs=1e-12), k
    # 2 images a batch over 6 devices at 2 shards: a 2 x 2 grid, 2 idle, said
    pt_loop.evaluate(tiny["port"], cfg.replace(spatial_shards=2),
                     DataLoader(ds, 2, device="cpu"), devices=["cpu"] * 6)
    assert "dp=2 x sp=2 uses 4 of 6 devices (2 idle)" in capsys.readouterr().out


def jx_pipe_loader(ds, bs):
    from cfpnet_tpu.data import pipeline as jx_pipe

    return jx_pipe.DataLoader(ds, bs)


# ---- refusals ------------------------------------------------------------------

def _same_error(jax_call, port_call, kind):
    with pytest.raises(kind) as want:
        jax_call()
    with pytest.raises(kind) as got:
        port_call()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dp,sp,n,bs", [(0, 2, 8, None), (2, 0, 8, None), (3, 3, 8, None),
                                        (1, 9, 8, None), (2, 2, 8, 3), (4, 2, 8, 6)])
def test_make_mesh_2d_refuses_as_jax(dp, sp, n, bs):
    _same_error(lambda: jx_mesh.make_mesh_2d(dp, sp, jax.devices()[:n], batch_size=bs),
                lambda: spatial.make_mesh_2d(dp, sp, ["cpu"] * n, batch_size=bs), ValueError)


def _np_batch(bs, H):
    rng = np.random.default_rng(bs * 100 + H)
    return dict(image=rng.standard_normal((bs, H, 6, 3)), depth=rng.random((bs, H, 6, 1)),
                hist_data=rng.random((bs, 4, 16)), mask=rng.random((bs, 4)) > 0.5)


@pytest.mark.parametrize("dp,sp,bs,H", [(2, 2, 3, 8), (2, 3, 4, 8), (1, 4, 2, 6)])
def test_shard_batch_spatial_refuses_as_jax(dp, sp, bs, H):
    batch = _np_batch(bs, H)
    _same_error(lambda: jx_mesh.shard_batch_spatial(batch, jx_mesh.make_mesh_2d(dp, sp)),
                lambda: spatial.shard_batch_spatial({k: t(v) for k, v in batch.items()},
                                                    _grid(dp, sp)), ValueError)


@pytest.mark.parametrize("dp,sp,bs,accum,H", [(1, 2, 6, 4, 8), (2, 2, 6, 2, 8),
                                              (2, 2, 4, 4, 8), (1, 3, 4, 2, 8)])
def test_presplit_refuses_as_jax(dp, sp, bs, accum, H):
    batch = _np_batch(bs, H)
    _same_error(lambda: jx_mesh.shard_batch_spatial_presplit(batch, jx_mesh.make_mesh_2d(dp, sp),
                                                             accum),
                lambda: spatial.shard_batch_spatial_presplit(
                    {k: t(v) for k, v in batch.items()}, _grid(dp, sp), accum), ValueError)


def test_presplit_takes_microbatch_major_rows():
    """Microbatch i is rows [i * mb, (i + 1) * mb), its images split over
    the data groups, as JAX's ``P(None, 'data', 'spatial')`` pre-split."""
    batch = {k: t(v) for k, v in _np_batch(8, 8).items()}
    parts = spatial.shard_batch_spatial_presplit(batch, _grid(2, 2), 2)
    assert len(parts) == 2
    for i, part in enumerate(parts):
        for d in range(2):
            rows = slice(4 * i + 2 * d, 4 * i + 2 * d + 2)
            assert torch.equal(spatial.rows(part["image"][d], 0, 8, "cpu", 1),
                               batch["image"][rows])
            assert torch.equal(part["mask"][d], batch["mask"][rows])


def test_several_processes_are_refused_as_jax(monkeypatch):
    """Single-controller: in a process group of more than one process the
    placement raises ``NotImplementedError``, as JAX's does under more
    than one process; so do the loop and the driver, before any work."""
    batch = _np_batch(2, 8)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    monkeypatch.setattr(spatial, "world_size", lambda: 2)
    _same_error(lambda: jx_mesh.shard_batch_spatial(batch, jx_mesh.make_mesh_2d(1, 2)),
                lambda: spatial.shard_batch_spatial({k: t(v) for k, v in batch.items()},
                                                    _grid(1, 2)), NotImplementedError)
    with pytest.raises(NotImplementedError):
        pt_loop.spatial_eval_grid(PtConfig(spatial_shards=2), 2, "cpu", ["cpu"] * 2)
    monkeypatch.setattr(spatial, "world_size", lambda: 1)
    with pytest.raises(NotImplementedError, match="single-controller"):
        pt_train_main.main(["--spatial_shards", "2", "--multihost", "--device", "cpu"])


@pytest.mark.parametrize("extra,kind", [
    (dict(), ValueError),  # no --safe_dw_vjp
    (dict(safe_dw_vjp=True, device_pipeline=True), NotImplementedError),
    (dict(safe_dw_vjp=True, spatial_shards=16), ValueError),  # more cells than devices
    (dict(safe_dw_vjp=True, grad_accum=3), ValueError)])  # 3 does not divide bs 2
def test_run_training_refuses_as_jax(extra, kind, tmp_path, monkeypatch):
    """The JAX ``run_training``'s refusals, raised before any work, with
    the conftest's 8 devices on the JAX side and 8 CPU devices here."""
    monkeypatch.chdir(tmp_path)
    kw = {**TINY, "spatial_shards": 2, "dataset": "synthetic", "synthetic_length": 4,
          "no_logging": True, **extra}
    with pytest.raises(kind) as want:
        jx_loop.run_training(JxConfig(**kw), tiny=True)
    with pytest.raises(kind) as got:
        pt_loop.run_training(PtConfig(**kw), tiny=True, device="cpu", devices=["cpu"] * 8)
    if kind is ValueError and "safe_dw_vjp" not in kw:
        assert "--safe_dw_vjp" in str(got.value) and "--safe_dw_vjp" in str(want.value)
    else:
        assert str(got.value) == str(want.value)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("selfsup", [False, True])
def test_the_training_driver_keeps_a_spatial_run_in_process(selfsup, monkeypatch):
    """``python -m cfpnet_torch.train --spatial_shards 2 --dp_shards 2``
    spawns no process (``--dp_shards`` is the grid's data axis, as in the
    JAX loop) and hands the run to the loop; with ``--selfsup`` to the
    self-supervised loop, which trains on one device and validates through
    ``evaluate``, on the grid."""
    seen = []
    monkeypatch.setattr(pt_train_main, "run_training",
                        lambda config, device: seen.append(("train", config)))
    monkeypatch.setattr(pt_train_main, "run_selfsup_training",
                        lambda config, device: seen.append(("selfsup", config)))
    monkeypatch.setattr(pt_train_main, "local_device_count", lambda device: 4)
    monkeypatch.setattr(pt_train_main.launch, "spawn",
                        lambda *a, **kw: pytest.fail("a spatial run spawned processes"))
    pt_train_main.main(["--spatial_shards", "2", "--dp_shards", "2", "--safe_dw_vjp",
                        "--device", "cpu"] + (["--selfsup"] if selfsup else []))
    ((kind, config),) = seen
    assert kind == ("selfsup" if selfsup else "train")
    assert (config.spatial_shards, config.dp_shards) == (2, 2)
    from cfpnet_torch.train import selfsup as pt_selfsup

    assert pt_selfsup.evaluate is pt_loop.evaluate


# ---- run_training on a grid --------------------------------------------------------

def test_run_training_on_a_grid_equals_one_device(tmp_path, monkeypatch):
    """Two steps (bs 2) and a validation (``--eval_bs 2``) on a 2 x 2 grid
    of four devices, in float32: the losses and the validation metrics of
    the one-device run, up to float32 sums. (The step itself is held
    against JAX's in float64 in ``tests/test_torch_port_parallel.py``.)"""
    monkeypatch.chdir(tmp_path)
    cfg = PtConfig(**dict(TINY, epochs=1, synthetic_length=4, dataset="synthetic",
                          dataset_eval="synthetic", eval_bs=2))
    init = pt_make_model(cfg, tiny=True, device="cpu").state_dict()
    runs = {}
    for name, kw in (("one", {}), ("grid", dict(spatial_shards=2, safe_dw_vjp=True))):
        trace = []
        pt_loop.run_training(cfg.replace(name=name, save_dir=name, **kw), tiny=True,
                             device="cpu", init_state_dict=init, trace=trace,
                             devices=["cpu"] * 4)
        with open(tmp_path / name / "train_log.jsonl") as f:
            val = [line for line in map(json.loads, f) if line["kind"] == "val"]
        runs[name] = ([float(s["loss"]) for s in trace], val)
    (l1, v1), (lg, vg) = runs["one"], runs["grid"]
    assert len(l1) == 2 and len(v1) == len(vg) == 1
    np.testing.assert_allclose(lg, l1, rtol=1e-5)
    for k in pt_loop.EVAL_METRIC_KEYS:
        assert vg[0][k] == pytest.approx(v1[0][k], rel=1e-4, abs=1e-6), k


def test_the_spatial_module_imports_no_jax():
    from tests.test_torch_port_bridge import FORBIDDEN, ROOT, _imports

    path = ROOT / "cfpnet_torch" / "parallel" / "spatial.py"
    assert path in set((ROOT / "cfpnet_torch").rglob("*.py"))
    assert not set(_imports(path)) & set(FORBIDDEN)
