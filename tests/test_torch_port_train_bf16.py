"""The port's ``--compute_dtype bfloat16`` train step against the JAX
package's on the CPU, at the tiny size.

The same numpy weights (``random_tree``, float32, carried across by
``weights.from_flax``) and the same numpy batch go through both packages,
with the crop offsets pinned on both sides (the port's generator's draws at
``SEED``, handed to the JAX model through ``jax.random.randint``, and to the
port at every step). The JAX side is compiled with
``xla_allow_excess_precision`` off, as ``tests/test_torch_port_bf16.py``
compiles it: XLA on the CPU otherwise keeps fused bf16 intermediates in
float32, which a bf16 program does not.

- (a) The port's bf16 loss and gradients against ``jax.value_and_grad`` of
  ``make_loss_fn`` with ``compute_dtype="bfloat16"``, each no farther from
  it than twice JAX's own bf16 step is from JAX's float32 step.
- (b) Four steps on one batch, as ``tests/test_bf16.py``'s mixed-precision
  test: finite, falling losses within rtol 0.05 of the port's float32 ones
  and of JAX's bf16 ones; every parameter, both moments and every running
  statistic stay float32.
- (a') The same loss and gradients with the rows split over a 2 x 2 grid
  (``--spatial_shards``) within (a)'s bound of the port's one-device bf16
  step.
- (c) ``BatchNorm`` in training mode on bf16 gives bf16 and lands a running
  mean increment below one bf16 ulp in float32 (the port's copy of
  ``tests/test_bf16.py::test_bn_running_stats_accumulate_f32``); float32
  gives the same bits as before.
- (d) ``python -m cfpnet_torch.train --compute_dtype bfloat16 --device cpu``
  trains an epoch and writes float32 weights and moments.
- (e) ``evaluate_time --train --compute_dtype bfloat16`` on the CPU, and the
  bench's train keys.
"""

import contextlib
import itertools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cfpnet_torch import weights
from cfpnet_torch.config import Config as PtConfig
from cfpnet_torch.models import fusion as pt_fusion
from cfpnet_torch.models.deltar import make_model as pt_make_model
from cfpnet_torch.models.layers import BatchNorm
from cfpnet_torch.parallel import spatial
from cfpnet_torch.train import __main__ as pt_train_main
from cfpnet_torch.train import steps as pt_steps
from cfpnet_tpu.config import Config as JxConfig
from cfpnet_tpu.models.deltar import make_model as jx_make_model
from cfpnet_tpu.models.deltar import model_geometries
from cfpnet_tpu.train import optim as jx_optim
from cfpnet_tpu.train import steps as jx_steps
from tests.test_torch_port_loop import ENTRY
from tests.test_torch_port_train import TINY, _batch, _flag
from tests.torch_port_util import random_tree

STRICT = {"xla_allow_excess_precision": False}  # each op rounds to its dtype
SEED = 11  # the step seed whose crop offsets both packages take
DTYPES = ("float32", "bfloat16")


def _draws(pt_cfg):
    """The crop offsets the port's train step draws at ``SEED``, one
    (offset, (y range, x range)) a fusion scale, in the decoder's order."""
    gen = pt_steps.step_generator(SEED)
    h, w, nh, nw = (pt_cfg.input_height, pt_cfg.input_width, pt_cfg.native_height,
                    pt_cfg.native_width)
    out = []
    for s in (16, 8, 4):
        H, W, mH, mW = h // s, w // s, nh // s, nw // s
        out.append((pt_fusion.crop_offsets(H, W, mH, mW, gen), (mH - H + 1, mW - W + 1)))
    return out


@contextlib.contextmanager
def pinned(draws):
    """The port's training crops take ``draws`` at every step, and the JAX
    model's ``jax.random.randint`` the same offsets (traced once: a
    compiled step keeps them)."""
    port_calls = itertools.cycle(draws)
    jax_calls = iter([(o, hi) for off, his in draws for o, hi in zip(off, his)])
    real = pt_fusion.crop_offsets

    def crop(H, W, maxH, maxW, generator=None):
        if generator is None:
            return real(H, W, maxH, maxW)
        off, his = next(port_calls)
        assert his == (maxH - H + 1, maxW - W + 1)
        return off

    def randint(key, shape, minval, maxval, *args, **kw):
        off, hi = next(jax_calls)
        assert (minval, maxval) == (0, hi), (minval, maxval, hi)
        return jnp.asarray(off, kw.get("dtype", int))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pt_fusion, "crop_offsets", crop)
        mp.setattr(jax.random, "randint", randint)
        yield


@pytest.fixture(scope="module")
def twin():
    """The tiny JAX model's float32 variables, one batch, the pinned draws,
    and ``jax.value_and_grad(make_loss_fn)`` compiled once in each dtype."""
    cfg, pt_cfg = JxConfig(**TINY), PtConfig(**TINY)
    geoms = model_geometries(cfg, "train")
    b = _batch(cfg, 1)
    b["depth"] = b["depth"].astype(np.float32)
    model = jx_make_model(cfg, tiny=True)
    shapes = jax.eval_shape(
        lambda r: model.init({"params": r, "fusion": r}, jnp.asarray(b["image"]),
                             jnp.asarray(b["hist_data"]), jnp.asarray(b["mask"]), geoms,
                             train=True), jax.random.key(0))
    variables = random_tree(shapes, 3, kernel_std=0.05, dtype=np.float32)
    batch = {k: jnp.asarray(a) for k, a in b.items()}
    draws = _draws(pt_cfg)
    grad_fns = {}
    for dt in DTYPES:
        fn = jax.jit(jax.value_and_grad(
            jx_steps.make_loss_fn(model, cfg.replace(compute_dtype=dt), geoms), has_aux=True))
        with pinned(draws):
            grad_fns[dt] = fn.lower(variables["params"], variables["batch_stats"], batch,
                                    jax.random.key(0)).compile(compiler_options=STRICT)
    return dict(cfg=cfg, pt_cfg=pt_cfg, geoms=geoms, numpy_batch=b, batch=batch,
                variables=variables, draws=draws, grad_fns=grad_fns)


def _port(twin, dtype="float32"):
    cfg = twin["pt_cfg"].replace(compute_dtype=dtype)
    port = pt_make_model(cfg, tiny=True, device="cpu")
    v = twin["variables"]
    port.load_state_dict(weights.from_flax(v["params"], v["batch_stats"], cfg), strict=True)
    return port, cfg


def _pt_batch(twin):
    return {k: torch.from_numpy(a) for k, a in twin["numpy_batch"].items()}


def _jax_loss_and_grads(twin, dtype):
    v = twin["variables"]
    (loss, _), grads = twin["grad_fns"][dtype](v["params"], v["batch_stats"], twin["batch"],
                                               jax.random.key(0))
    g = weights.from_flax(jax.tree_util.tree_map(np.asarray, grads), None, twin["pt_cfg"])
    return float(loss), {k: t.double() for k, t in g.items()}


def _distance(a, b):
    """(relative loss difference, global relative L2 distance of the
    gradients) of (loss, grads) ``a`` from ``b``."""
    num = sum(float(((a[1][k] - g) ** 2).sum()) for k, g in b[1].items())
    den = sum(float((g ** 2).sum()) for g in b[1].values())
    return abs(a[0] - b[0]) / abs(b[0]), math.sqrt(num / den)


def _assert_f32_state(state):
    """Every parameter, both AdamW moments and every running statistic of a
    ``TrainState`` are float32."""
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
    assert {t.dtype for t in state.model.buffers()} == {torch.float32}
    for moments in (state.tx.mu, state.tx.nu):
        assert len(moments) == len(state.tx.params)
        assert {t.dtype for t in moments.values()} == {torch.float32}


def _port_loss_and_grads(twin, dtype, grid=None):
    """The port's loss and float32 gradients in ``dtype`` (on ``grid``,
    ``--spatial_shards``, where given), and the dtypes of the first
    convolution's input and weight during a one-device forward."""
    port, cfg = _port(twin, dtype)
    conv = next(m for m in port.modules() if isinstance(m, torch.nn.Conv2d))
    seen = []
    hook = conv.register_forward_pre_hook(
        lambda m, args: seen.append((args[0].dtype, m.weight.dtype)))
    batch = _pt_batch(twin)
    if grid is not None:
        batch = spatial.shard_batch_spatial(batch, grid)
    with pinned(twin["draws"]):
        loss = pt_steps.make_loss_fn(port, cfg, twin["geoms"], grid)(
            batch, pt_steps.step_generator(SEED))
    hook.remove()
    loss.backward()
    assert loss.dtype == torch.float32
    grads = dict(port.named_parameters())
    assert {p.grad.dtype for p in grads.values()} == {torch.float32}
    return (float(loss.detach()), {k: p.grad.double() for k, p in grads.items()}), set(seen)


def test_bf16_loss_and_gradients_match_jax(twin):
    """(a) Measured on this CPU: the port's bf16 loss is 9.0e-5 relative
    from JAX's bf16 loss, and its gradients 0.036 in global relative L2
    distance; JAX's own bf16 step is 1.2e-4 and 0.038 from JAX's float32
    step. The bound is twice the latter. A step that ran in float32 would
    be about as near JAX's bf16 one, so the port's bf16 step must also be
    away from the port's own float32 step (measured 2.5e-5 in the loss, 0.021
    in the gradients; a float32 step reads 0), by at least a quarter of
    JAX's bf16-vs-float32 distance, and its first convolution must see bf16
    activations and weights."""
    got, seen = _port_loss_and_grads(twin, "bfloat16")
    assert seen == {(torch.bfloat16, torch.bfloat16)}
    got32, seen32 = _port_loss_and_grads(twin, "float32")
    assert seen32 == {(torch.float32, torch.float32)}
    jax16, jax32 = _jax_loss_and_grads(twin, "bfloat16"), _jax_loss_and_grads(twin, "float32")
    assert set(got[1]) == set(jax16[1])
    loss_d, grad_d = _distance(got, jax16)
    jax_loss_d, jax_grad_d = _distance(jax16, jax32)
    own_loss_d, own_grad_d = _distance(got, got32)
    print(f"port bf16 vs JAX bf16: loss {loss_d:.3g}, grads {grad_d:.3g}; "
          f"JAX bf16 vs JAX f32: loss {jax_loss_d:.3g}, grads {jax_grad_d:.3g}; "
          f"port bf16 vs port f32: loss {own_loss_d:.3g}, grads {own_grad_d:.3g}")
    assert 0 < jax_loss_d and 0 < jax_grad_d  # the bf16 steps did run in bf16
    assert loss_d <= 2 * jax_loss_d
    assert grad_d <= 2 * jax_grad_d
    assert own_grad_d >= 0.25 * jax_grad_d


def test_bf16_spatial_step_within_the_bf16_tolerance(twin):
    """The bf16 loss and gradients with each image's rows over a 2 x 2 grid
    (``--spatial_shards 2``, ``parallel/spatial.py``): no farther from the
    port's one-device bf16 step than (a)'s bound, twice JAX's own bf16 step's
    distance from its float32 step; and as far from the port's float32
    step as (a) asks of a bf16 step."""
    grid = spatial.make_mesh_2d(2, 2, ["cpu"] * 4)
    got, _ = _port_loss_and_grads(twin, "bfloat16", grid)
    one, _ = _port_loss_and_grads(twin, "bfloat16")
    got32, _ = _port_loss_and_grads(twin, "float32")
    jax_loss_d, jax_grad_d = _distance(_jax_loss_and_grads(twin, "bfloat16"),
                                       _jax_loss_and_grads(twin, "float32"))
    loss_d, grad_d = _distance(got, one)
    print(f"spatial bf16 vs one-device bf16: loss {loss_d:.3g}, grads {grad_d:.3g}")
    assert loss_d <= 2 * jax_loss_d and grad_d <= 2 * jax_grad_d
    assert _distance(got, got32)[1] >= 0.25 * jax_grad_d


def test_four_bf16_steps_learn_and_keep_f32_state(twin):
    """(b) Four steps on one batch in each dtype, OneCycle over 6 steps."""
    losses = {}
    for dt in DTYPES:
        port, cfg = _port(twin, dt)
        state = pt_steps.create_train_state(port, cfg, total_steps=6)
        step = pt_steps.make_train_step(port, cfg, twin["geoms"])
        batch = _pt_batch(twin)
        with pinned(twin["draws"]):
            losses[dt] = [float(step(state, batch, SEED)) for _ in range(4)]
        _assert_f32_state(state)
    # JAX's bf16 step: the compiled loss and gradients, then optax's update
    v = twin["variables"]
    params, stats = v["params"], v["batch_stats"]
    tx = jx_optim.make_optimizer(twin["cfg"], total_steps=6)
    opt_state = tx.init(params)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    jax16 = []
    for _ in range(4):
        (loss, upd), grads = twin["grad_fns"]["bfloat16"](params, stats, twin["batch"],
                                                          jax.random.key(0))
        params, opt_state = update(grads, opt_state, params)
        stats = upd["batch_stats"]
        jax16.append(float(loss))
    b16 = np.asarray(losses["bfloat16"])
    print(f"port bf16 {b16}, port f32 {losses['float32']}, JAX bf16 {jax16}")
    assert np.isfinite(b16).all() and b16[-1] < b16[0]
    np.testing.assert_allclose(b16, losses["float32"], rtol=0.05)
    np.testing.assert_allclose(b16, jax16, rtol=0.05)


@pytest.mark.parametrize("channel_dim", [1, -1])
def test_batchnorm_bf16_output_and_f32_statistics(channel_dim):
    """(c) bf16 in, bf16 weight and bias, float32 statistics: the output is
    bf16 and within a bf16 ulp of flax's on the same values, and the
    running mean's increment, 0.1 x 2^-7 ~ 7.8e-4 (below the bf16 ulp at
    1.0, 2^-7), lands in float32 where a bf16 accumulator keeps 1.0."""
    import flax.linen as nn

    rows = np.arange(64)[:, None] % 2 * 2 - 1  # +-1 by row
    xf = 1.0 + 2.0 ** -7 * np.arange(1, 5) + 2.0 ** -5 * rows  # exact in bf16
    x = torch.from_numpy(xf).to(torch.bfloat16)
    assert torch.equal(x.double(), torch.from_numpy(xf))
    x_in = x if channel_dim == -1 else x.T[None, :, :, None].contiguous()  # [1, C, 64, 1]
    bn = BatchNorm(4, channel_dim=channel_dim).train()
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.0, 0.5, 2.0, -1.0]))
        bn.bias.copy_(torch.tensor([0.0, 0.25, -0.5, 1.0]))
        bn.running_mean.fill_(1.0)  # where a bf16 accumulator's ulp is 2^-7
    params = {n: p.detach().to(torch.bfloat16) for n, p in bn.named_parameters()}
    y = torch.func.functional_call(bn, params, (x_in,))
    assert y.dtype == torch.bfloat16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    delta = bn.running_mean.double().numpy() - 1.0
    want = 0.1 * (xf.mean(0) - 1.0)
    np.testing.assert_allclose(delta, want, rtol=1e-3)
    frozen = (0.9 * torch.ones(4, dtype=torch.bfloat16)
              + 0.1 * torch.from_numpy(xf.mean(0)).to(torch.bfloat16)).double() - 1.0
    assert not np.allclose(delta, frozen.numpy(), atol=1e-6)

    fbn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    jx = jnp.asarray(xf, jnp.bfloat16)
    variables = {"params": {"scale": jnp.asarray(params["weight"].float().numpy(), jnp.bfloat16),
                            "bias": jnp.asarray(params["bias"].float().numpy(), jnp.bfloat16)},
                 "batch_stats": {"mean": jnp.ones(4, jnp.float32),
                                 "var": jnp.ones(4, jnp.float32)}}
    ref, updates = fbn.apply(variables, jx, mutable=["batch_stats"])
    assert ref.dtype == jnp.bfloat16
    got = y.float().numpy() if channel_dim == -1 else y[0, :, :, 0].T.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.abs(got - ref).max() <= 2.0 ** -7 * np.abs(ref).max()
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(updates["batch_stats"]["mean"]), rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batchnorm_train_mode_same_bits_in_wide_dtypes(dtype):
    """(c) In float32 and float64 the output is the training formula's, bit
    for bit: the cast to the output's dtype changes nothing there."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 7, 6, generator=gen, dtype=dtype)
    bn = BatchNorm(5).to(dtype).train()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(5, generator=gen, dtype=dtype) + 0.5)
        bn.bias.copy_(torch.randn(5, generator=gen, dtype=dtype))
    y = bn(x)
    mean = x.mean((0, 2, 3))
    var = torch.clamp_min((x * x).mean((0, 2, 3)) - mean * mean, 0.0)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    want = (x - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + bn.bias.view(1, -1, 1, 1)
    assert y.dtype == dtype and torch.equal(y, want)


def test_entry_point_trains_in_bf16(tmp_path, monkeypatch):
    """(d) ``python -m cfpnet_torch.train --compute_dtype bfloat16 --device
    cpu`` on the tiny config: one epoch, finite validation metrics, float32
    weights in the weights file and float32 weights and moments in the
    checkpoint."""
    monkeypatch.chdir(tmp_path)
    state = pt_train_main.main(ENTRY + ["--compute_dtype", "bfloat16"])
    assert state.step == 1
    _assert_f32_state(state)
    with open("results/entry/train_log.jsonl") as f:
        log = [json.loads(line) for line in f]
    (val,) = [line for line in log if line["kind"] == "val"]
    assert all(math.isfinite(val[k]) for k in ("rmse", "abs_rel", "a1", "silog"))
    (epoch,) = [line for line in log if line["kind"] == "epoch"]
    assert math.isfinite(epoch["loss"])
    names = sorted(os.listdir("weights/entry"))
    assert "best" in names and len(names) == 2
    for name in names:
        sd = torch.load(f"weights/entry/{name}", weights_only=True)
        assert {v.dtype for v in sd.values()} == {torch.float32}
        ckpt = torch.load(f"checkpoints/entry/{name}", weights_only=True)
        assert {v.dtype for v in ckpt["model"].values()} == {torch.float32}
        moments = [v for g in ckpt["opt_state"].values() for key in ("mu", "nu")
                   for v in g[key].values()]
        assert moments and {v.dtype for v in moments} == {torch.float32}


def test_evaluate_time_train_bf16_on_cpu():
    """(e) ``python -m cfpnet_torch.evaluate_time --train --compute_dtype
    bfloat16`` on the CPU (host clock) at the tiny size names the dtype it
    ran."""
    from cfpnet_torch import evaluate_time

    argv = ["--train", "--device", "cpu", "--tiny_model", "--niters", "2", "--bs", "2",
            "--compute_dtype", "bfloat16"] + [a for k, v in TINY.items()
                                              if k not in ("bs", "epochs") for a in _flag(k, v)]
    out = evaluate_time.main(argv)
    assert out["train_dtype"] == "bfloat16" and out["train_ms_bs2"] > 0


def test_bench_train_keys_follow_the_root():
    """(e) The bench's train keys: the bf16 step without a suffix (the
    root's ``train_ms_bs16``, ``train_img_s``, ``train_dtype`` bfloat16),
    the float32 step under ``_f32``."""
    from cfpnet_torch import bench

    assert [(sfx, dt) for sfx, dt in bench.DTYPES] == [("", torch.bfloat16),
                                                       ("_f32", torch.float32)]
    keys = {sfx: bench.train_fields(16, 500.0, 3.35e12, sfx) for sfx, _ in bench.DTYPES}
    assert set(keys[""]) == {"train_ms_bs16", "train_img_s", "tfps_train"}
    assert set(keys["_f32"]) == {"train_ms_bs16_f32", "train_img_s_f32", "tfps_train_f32"}
    assert keys[""]["train_img_s"] == 32.0 and keys[""]["tfps_train"] == pytest.approx(6.7)
