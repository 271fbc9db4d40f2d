"""The port's train step against the JAX package on the CPU: train-mode
BatchNorm, the SILog loss, the OneCycle schedules and group labels, the
optax AdamW, the positional-encoding crop, the kernels' gradients, the tiny
model's loss and every gradient leaf against ``jax.value_and_grad`` of
``cfpnet_tpu/train/steps.py::make_loss_fn``, two steps of
``make_train_step``, and the refusals. float64 unless a test says
otherwise; rtol 1e-7.

The JAX step draws its crop offsets from its 'fusion' RNG, which the port
cannot match draw for draw: the tests record the offsets the port's
generator draws (``models/fusion.py::crop_offsets``) and hand the same ones
to the JAX model by replacing ``jax.random.randint`` for the trace.

    python tests/test_torch_port_train.py

writes ``tests/golden/torch_port_train_step.npz``, the JAX package's one
production train step that ``chip_smoke.py`` holds the card against
(``write_train_golden``).
"""

import contextlib
import os
import sys

if __name__ == "__main__":  # the golden writer runs JAX on the CPU, in float64
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cfpnet_torch import weights
from cfpnet_torch.config import Config as PtConfig
from cfpnet_torch.kernels import dwconv as pt_dwconv
from cfpnet_torch.kernels import linear_attention as pt_la
from cfpnet_torch.models import fusion as pt_fusion
from cfpnet_torch.models.deltar import make_model as pt_make_model
from cfpnet_torch.models.layers import BatchNorm
from cfpnet_torch.ops.attention import linear_attention as pt_attention_plain
from cfpnet_torch.ops.dwconv import depthwise_conv2d as pt_dwconv_plain
from cfpnet_torch.train import losses as pt_losses
from cfpnet_torch.train import optim as pt_optim
from cfpnet_torch.train import steps as pt_steps
from cfpnet_tpu.config import Config as JxConfig
from cfpnet_tpu.models.deltar import make_model as jx_make_model
from cfpnet_tpu.models.deltar import model_geometries
from cfpnet_tpu.ops.attention import linear_attention as jx_attention
from cfpnet_tpu.train import losses as jx_losses
from cfpnet_tpu.train import optim as jx_optim
from cfpnet_tpu.train import steps as jx_steps
from tests.torch_port_util import close, enable_x64, random_tree, t

TINY = dict(n_bins=16, input_height=48, input_width=64, native_height=64, native_width=96,
            train_zone_num=2, eval_zone_num_cfg=2, train_patch_px=16, eval_patch_px=16,
            zone_sample_num=16, sample_uniform=True,
            attention_layer=["hist2image", "combine1", "image"], change_embedding=True,
            disable_clip_grad=True, hist_encoder_10x=True, bs=2, epochs=1)


# ---- pinned crop offsets ---------------------------------------------------

class RecordedOffsets:
    """Records the port's crop offsets (``models/fusion.py::crop_offsets``)
    while installed, and replays them, in order, as the JAX model's
    ``jax.random.randint`` draws (y then x for each fusion scale)."""

    def __init__(self, monkeypatch):
        self.drawn = []
        real = pt_fusion.crop_offsets

        def record(H, W, maxH, maxW, generator=None):
            off = real(H, W, maxH, maxW, generator)
            self.drawn.append((off, (maxH - H + 1, maxW - W + 1)))
            return off

        monkeypatch.setattr(pt_fusion, "crop_offsets", record)
        self.monkeypatch = monkeypatch

    def replay_in_jax(self):
        draws = [(o, hi) for (off, his) in self.drawn for o, hi in zip(off, his)]
        it = iter(draws)

        def randint(key, shape, minval, maxval, *args, **kw):
            off, hi = next(it)
            assert (minval, maxval) == (0, hi), (minval, maxval, hi)
            return jnp.asarray(off, kw.get("dtype", int))

        self.monkeypatch.setattr(jax.random, "randint", randint)
        return it


# ---- the tiny model on the same weights ------------------------------------

def _batch(cfg, seed, batch=2):
    """A train batch in float32 values (the JAX loss casts image and
    hist_data to its compute dtype, float32, even under x64)."""
    rng = np.random.default_rng(seed)
    h, w = cfg.input_height, cfg.input_width
    Z = cfg.train_zone_num ** 2
    depth = rng.uniform(0.3, 6.0, (batch, h, w, 1))
    depth[rng.random(depth.shape) < 0.1] = 0.0
    return dict(image=rng.standard_normal((batch, h, w, 3)).astype(np.float32),
                hist_data=(np.abs(rng.standard_normal((batch, Z, cfg.zone_sample_num))) * 2
                           + 0.5).astype(np.float32),
                mask=rng.random((batch, Z)) > 0.25, depth=depth)


@pytest.fixture(scope="module")
def tiny():
    """The flax tiny model's f64 variables and the port's tiny model
    carrying them, both in float64."""
    cfg = JxConfig(**TINY)
    geoms = model_geometries(cfg, "train")
    b = _batch(cfg, 0)
    model = jx_make_model(cfg, tiny=True)
    with enable_x64():
        shapes = jax.eval_shape(
            lambda r: model.init({"params": r, "fusion": r}, jnp.asarray(b["image"]),
                                 jnp.asarray(b["hist_data"]), jnp.asarray(b["mask"]), geoms,
                                 train=True), jax.random.key(0))
        # kernels of std 0.05 keep activations O(1) (test_torch_port_model.py)
        variables = random_tree(shapes, 3, kernel_std=0.05)
    return dict(cfg=cfg, pt_cfg=PtConfig(**TINY), geoms=geoms, model=model, variables=variables)


def _port(tiny, **options):
    port = pt_make_model(tiny["pt_cfg"].replace(**options), tiny=True, device="cpu").double()
    v = tiny["variables"]
    port.load_state_dict(weights.from_flax(v["params"], v["batch_stats"], tiny["pt_cfg"]),
                         strict=True)
    return port


def _pt_batch(b, dtype=torch.float64):
    return {k: t(a) if a.dtype == bool else t(a).to(dtype) for k, a in b.items()}


def _jx_batch(b):
    return {k: jnp.asarray(a) for k, a in b.items()}


def _bn_stats(state_dict):
    return {k: v for k, v in state_dict.items() if k.endswith(("running_mean", "running_var"))}


def test_tiny_loss_and_every_gradient_match_jax_f64(tiny, monkeypatch):
    """The acceptance gate: loss and the gradient of every parameter leaf
    (mapped to the port's names and layouts by ``weights.from_flax``), and
    the BatchNorm statistics the step leaves, against
    ``jax.value_and_grad(make_loss_fn)``."""
    cfg, geoms = tiny["cfg"], tiny["geoms"]
    b = _batch(cfg, 1)
    port = _port(tiny)
    offsets = RecordedOffsets(monkeypatch)
    loss_fn = pt_steps.make_loss_fn(port, tiny["pt_cfg"], geoms)
    loss = loss_fn(_pt_batch(b), pt_steps.step_generator(11))
    loss.backward()
    assert len(offsets.drawn) == 3 and port.training
    left = offsets.replay_in_jax()
    v = tiny["variables"]
    with enable_x64():
        jx_loss = jx_steps.make_loss_fn(tiny["model"], cfg, geoms)
        (ref_loss, updates), grads = jax.jit(jax.value_and_grad(jx_loss, has_aux=True))(
            v["params"], v["batch_stats"], _jx_batch(b), jax.random.key(0))
    assert next(left, None) is None  # the JAX model drew as many offsets
    close(float(loss.detach()), float(ref_loss))
    ref_grads = weights.from_flax(jax.tree_util.tree_map(np.asarray, grads), None,
                                  tiny["pt_cfg"])
    named = dict(port.named_parameters())
    assert set(ref_grads) == set(named)
    for k, p in named.items():
        g, ref = p.grad.numpy(), ref_grads[k].numpy()
        np.testing.assert_allclose(g, ref, rtol=1e-7, atol=1e-12, err_msg=k)
    ref_stats = weights.from_flax({}, jax.tree_util.tree_map(np.asarray,
                                                             updates["batch_stats"]),
                                  tiny["pt_cfg"])
    for k, s in _bn_stats(port.state_dict()).items():
        np.testing.assert_allclose(s.numpy(), ref_stats[k].numpy(), rtol=1e-7, atol=1e-12,
                                   err_msg=k)


def test_two_train_steps_match_jax_f64(tiny, monkeypatch):
    """Two steps of ``make_train_step`` (grad clipping on, to reach it):
    the parameters and BatchNorm statistics after each, against two steps of
    the JAX package's ``make_train_step`` with optax."""
    cfg = tiny["cfg"].replace(disable_clip_grad=False)
    pt_cfg = tiny["pt_cfg"].replace(disable_clip_grad=False)
    geoms = tiny["geoms"]
    port = _port(tiny)
    state = pt_steps.create_train_state(port, pt_cfg, total_steps=20)
    step = pt_steps.make_train_step(port, pt_cfg, geoms)
    v = tiny["variables"]
    with enable_x64():
        tx = jx_optim.make_optimizer(cfg, total_steps=20)
        jx_state = jx_steps.TrainState.create(apply_fn=tiny["model"].apply, params=v["params"],
                                              batch_stats=v["batch_stats"], tx=tx)
    for i in range(2):
        b = _batch(cfg, 20 + i)
        offsets = RecordedOffsets(monkeypatch)
        loss = step(state, _pt_batch(b), seed=100 + i)
        offsets.replay_in_jax()
        with enable_x64():
            jx_step = jx_steps.make_train_step(tiny["model"], cfg, geoms, jit=False)
            jx_state, ref_loss = jax.jit(jx_step)(jx_state, _jx_batch(b), jax.random.key(i))
        monkeypatch.undo()
        assert state.step == int(jx_state.step) == i + 1
        close(float(loss), float(ref_loss))
        ref = weights.from_flax(jax.tree_util.tree_map(np.asarray, jx_state.params),
                                jax.tree_util.tree_map(np.asarray, jx_state.batch_stats), pt_cfg)
        # the schedules may differ in the last bit of their cosine
        # (test_onecycle_schedules_match_jax): up to 2^-22 of max_lr a step
        atol = (i + 1) * cfg.lr * 2.0 ** -22
        for k, s in port.state_dict().items():
            np.testing.assert_allclose(s.numpy(), ref[k].numpy(), rtol=1e-7, atol=atol,
                                       err_msg=f"step {i + 1}: {k}")


# ---- modules --------------------------------------------------------------

@pytest.mark.parametrize("channel_dim", [1, -1])
def test_batchnorm_train_mode_matches_flax_f64(channel_dim):
    """Output, running mean and running variance after two training
    forwards (flax: fast variance, biased, momentum 0.9 the old value's
    weight), and the eval forward after them."""
    import flax.linen as nn

    rng = np.random.default_rng(channel_dim + 5)
    C, eps = 6, 1e-3
    shape = (3, C, 5, 7) if channel_dim == 1 else (3, 5, 7, C)
    bn = nn.BatchNorm(momentum=0.9, epsilon=eps, axis=channel_dim, dtype=jnp.float64,
                      param_dtype=jnp.float64)
    port = BatchNorm(C, eps, channel_dim=channel_dim).double()
    scale, bias = rng.uniform(0.5, 1.5, C), 0.2 * rng.standard_normal(C)
    mean, var = 0.3 * rng.standard_normal(C), rng.uniform(0.5, 1.5, C)
    port.load_state_dict({"weight": t(scale), "bias": t(bias), "running_mean": t(mean),
                          "running_var": t(var)})
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    port.train()
    with enable_x64():
        for i in range(2):
            x = 3.0 + 2.0 * rng.standard_normal(shape)
            y, upd = bn.apply(variables, jnp.asarray(x), use_running_average=False,
                              mutable=["batch_stats"])
            variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
            close(port(t(x)).detach().numpy(), np.asarray(y))
            close(port.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]))
            close(port.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]))
        y = bn.apply(variables, jnp.asarray(x), use_running_average=True)
    port.eval()
    close(port(t(x)).detach().numpy(), np.asarray(y))


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("interpolate", [True, False])
def test_silog_loss_matches_jax_f64(masked, interpolate):
    rng = np.random.default_rng(int(masked) * 2 + int(interpolate))
    target = rng.uniform(0.2, 8.0, (2, 12, 16, 1))
    pred = rng.uniform(0.2, 8.0, (2, 6, 8, 1) if interpolate else target.shape)
    mask = target > 1.0 if masked else None
    with enable_x64():
        ref = jx_losses.silog_loss(jnp.asarray(pred), jnp.asarray(target),
                                   None if mask is None else jnp.asarray(mask), interpolate)
        ref_grad = jax.grad(lambda p: jx_losses.silog_loss(
            p, jnp.asarray(target), None if mask is None else jnp.asarray(mask),
            interpolate))(jnp.asarray(pred))
    p = t(pred).requires_grad_()
    got = pt_losses.silog_loss(p, t(target), None if mask is None else t(mask), interpolate)
    got.backward()
    close(float(got.detach()), float(ref))
    close(p.grad.numpy(), np.asarray(ref_grad))


# ---- optimizer -------------------------------------------------------------

@pytest.mark.parametrize("total", [1000, 37])
def test_onecycle_schedules_match_jax(total):
    """Every step of the cycle and past it: the same float32 arithmetic.
    The port's cosine is correctly rounded and XLA's is not always, so the
    two may differ by one bit of cos + 1 (2^-23), times the half amplitude
    of the phase: atol 2^-22 of max_lr, and of 1 for the momentum."""
    lr_fn, mom_fn = pt_optim.onecycle_schedules(3e-4, total, 25.0, 100.0)
    jx_lr, jx_mom = jx_optim.onecycle_schedules(3e-4, total, 25.0, 100.0)
    steps = np.arange(total + 3)
    ref_lr, ref_mom = np.asarray(jax.vmap(jx_lr)(steps)), np.asarray(jax.vmap(jx_mom)(steps))
    got_lr = np.array([lr_fn(int(s)) for s in steps], np.float32)
    got_mom = np.array([mom_fn(int(s)) for s in steps], np.float32)
    np.testing.assert_allclose(got_lr, ref_lr, rtol=2e-7, atol=3e-4 * 2.0 ** -22)
    np.testing.assert_allclose(got_mom, ref_mom, rtol=2e-7, atol=2.0 ** -22)
    assert (got_lr == ref_lr).mean() > 0.99 and (got_mom == ref_mom).mean() > 0.99


@pytest.mark.parametrize("hist_encoder_10x", [True, False])
def test_param_group_labels_match_jax(tiny, hist_encoder_10x):
    """The port's labels by parameter name against the JAX labels of the
    same flax paths (mapped by ``weights.name_map``)."""
    params = tiny["variables"]["params"]
    ref = jx_optim.param_group_labels(params, hist_encoder_10x)
    port = pt_make_model(tiny["pt_cfg"], tiny=True, device="meta")
    names = [n for n, _ in port.named_parameters()]
    got = pt_optim.param_group_labels(names, hist_encoder_10x)
    table = weights.name_map(tiny["pt_cfg"], weights.V2_TINY_STAGES)
    for name in names:
        node = ref
        for key in table[name][0]:
            node = node[key]
        assert got[name] == node, name
    assert {"backbone", "rest"} == set(got.values())


@pytest.mark.parametrize("clip", [False, True])
def test_adamw_matches_optax_f64(clip):
    """Three steps of ``make_optimizer`` on parameters under each top-level
    module, gradients of norm above and below the clip, against optax."""
    cfg = JxConfig(lr=3e-4, wd=0.1, div_factor=25.0, final_div_factor=100.0,
                   hist_encoder_10x=False, disable_clip_grad=not clip)
    rng = np.random.default_rng(7)
    shapes = {"img_encoder": {"conv": (3, 4, 2), "bn": (4,)}, "hist_encoder": {"w": (5,)},
              "decoder": {"w": (2, 3), "b": (3,)}}
    params = {m: {k: rng.standard_normal(s) for k, s in d.items()} for m, d in shapes.items()}
    names = [f"{m}.{k}" for m, d in shapes.items() for k in d]
    pt_params = {n: torch.nn.Parameter(t(params[n.split(".")[0]][n.split(".")[1]]).clone())
                 for n in names}
    opt = pt_optim.AdamW(pt_params.items(), cfg.lr, 30, wd=cfg.wd, hist_encoder_10x=False,
                         clip_grad=clip)
    with enable_x64():
        tx = jx_optim.make_optimizer(cfg, total_steps=30)
        state = tx.init(params)
        for i, scale in enumerate((1.0, 1e-3, 0.3)):  # the middle step's norm is below 0.1
            grads = {m: {k: scale * rng.standard_normal(s) for k, s in d.items()}
                     for m, d in shapes.items()}
            updates, state = tx.update(grads, state, params)
            params = optax.apply_updates(params, updates)
            for n, p in pt_params.items():
                p.grad = t(grads[n.split(".")[0]][n.split(".")[1]])
            opt.step()
            for n, p in pt_params.items():
                ref = np.asarray(params[n.split(".")[0]][n.split(".")[1]])
                np.testing.assert_allclose(p.detach().numpy(), ref, rtol=1e-13, atol=1e-15,
                                           err_msg=f"step {i + 1}: {n}")
    assert opt.count == 3


@torch.no_grad()
def _adamw_step_with_python_floats(opt):
    """``AdamW.step`` with every per-step scalar a Python float
    (``hyperparams``) passed to the Scalar overloads of ``_foreach_*``: the
    reference of the update on device scalars."""
    grads = {id(p): p.grad for p in opt.params if p.grad is not None}
    if opt.clip_grad:
        grads = opt._clip(grads)
    h = opt.hyperparams(opt.params[0].dtype)
    for group, params in opt.groups.items():
        params = [p for p in params if id(p) in grads]
        g = [grads[id(p)] for p in params]
        mu = [opt.mu[id(p)] for p in params]
        nu = [opt.nu[id(p)] for p in params]
        torch._foreach_mul_(mu, h["b1"])
        torch._foreach_add_(mu, torch._foreach_mul(g, h["one_b1"]))
        torch._foreach_mul_(nu, h["b2"])
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), h["one_b2"]))
        den = torch._foreach_sqrt(torch._foreach_div(nu, h["bc2"]))
        torch._foreach_add_(den, h["eps"])
        u = torch._foreach_div(torch._foreach_div(mu, h["bc1"]), den)
        torch._foreach_add_(u, torch._foreach_mul(params, h["wd"]))
        torch._foreach_mul_(u, -h["lr"][group])
        torch._foreach_add_(params, u)
    opt.count += 1


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_adamw_device_scalars_equal_python_floats(dtype, clip):
    """50 steps of ``AdamW.step`` (scalars as 0-d views of one tensor)
    against the same steps with Python-float scalars, over 60 OneCycle
    steps, so that the schedules cross from the warm-up phase (17 steps)
    into the anneal: parameters and both moments equal bit for bit after
    every step, gradients of norm above and below the clip."""
    torch.manual_seed(5)
    shapes = {"img_encoder.conv": (3, 4, 2), "img_encoder.bn": (4,), "hist_encoder.w": (5,),
              "decoder.w": (2, 3), "decoder.b": (3,)}
    start = {n: torch.randn(s, dtype=dtype) for n, s in shapes.items()}
    sides = []
    for _ in range(2):
        params = {n: torch.nn.Parameter(v.clone()) for n, v in start.items()}
        sides.append((params, pt_optim.AdamW(params.items(), 3e-3, 60, clip_grad=clip)))
    (got, opt), (want, ref) = sides
    for i in range(50):
        scale = 1.0 if i % 3 == 0 else 1e-3  # every third step's norm is above the clip
        for n, s in shapes.items():
            g = scale * torch.randn(s, dtype=dtype)
            got[n].grad, want[n].grad = g.clone(), g.clone()
        opt.step()
        _adamw_step_with_python_floats(ref)
        for n in shapes:
            for a, b in ((got[n], want[n]), (opt.mu[id(got[n])], ref.mu[id(want[n])]),
                         (opt.nu[id(got[n])], ref.nu[id(want[n])])):
                assert torch.equal(a, b), (i, n)
    assert opt.count == ref.count == 50
    assert opt.step_scalars(dtype) == [
        -v for v in opt.hyperparams(dtype)["lr"].values()] + [
        opt.hyperparams(dtype)[k] for k in ("b1", "one_b1", "bc1", "bc2")]


# ---- the crop ---------------------------------------------------------------

@pytest.mark.parametrize("off", [(0, 0), (4, 9), (16, 32), (7, 0), (0, 32)])
def test_crop_matches_dynamic_slice(off):
    """The port's slice of the positional encoding at an offset against
    ``jax.lax.dynamic_slice`` at the same offset (maxH x maxW = 64 x 96,
    crop 48 x 64, the tiny config's scale-1 sizes)."""
    pos = np.random.default_rng(3).standard_normal((64, 96, 8))
    ref = np.asarray(jax.lax.dynamic_slice(jnp.asarray(pos), (off[0], off[1], 0), (48, 64, 8)))
    calls = []

    def pinned(H, W, maxH, maxW, generator=None):
        calls.append((H, W, maxH, maxW))
        return off

    fusion = pt_fusion.TransformerFusion(8, (64, 96), [], zone_sample_num=4)
    with torch.no_grad():
        fusion.positional_encodings.copy_(t(pos.reshape(-1, 8)))
    import unittest.mock

    with unittest.mock.patch.object(pt_fusion, "crop_offsets", pinned):
        x = torch.zeros(1, 48, 64, 8, dtype=torch.float64)
        geom = model_geometries(PtConfig(**TINY), "train")[4]
        out = fusion.double()(x, torch.zeros(1, geom.zone_num ** 2, 4, 8, dtype=torch.float64),
                              torch.ones(1, geom.zone_num ** 2, dtype=torch.bool), geom,
                              pt_steps.step_generator(0))
    assert calls == [(48, 64, 64, 96)]
    np.testing.assert_array_equal(out[0].detach().numpy(), ref)


def test_crop_offsets_cover_the_range():
    """The generator's offsets are uniform over [0, max - size], seeded by
    the step's seed; without a generator the crop is centered."""
    seen = {pt_fusion.crop_offsets(3, 5, 6, 7, pt_steps.step_generator(s)) for s in range(200)}
    assert seen == {(y, x) for y in range(4) for x in range(3)}
    assert (pt_fusion.crop_offsets(3, 5, 6, 7, pt_steps.step_generator(9))
            == pt_fusion.crop_offsets(3, 5, 6, 7, pt_steps.step_generator(9)))
    assert pt_fusion.crop_offsets(3, 5, 6, 7) == (1, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gathered_crop_equals_the_slice_bitwise(dtype):
    """A fusion's crop gathered at offsets held in a tensor
    (``DeviceCrops``: its starts, and its draws as it goes) against the
    slice at the same offsets, drawn from 20 steps' generators: the output
    and the positional encoding's gradient bit for bit."""
    geom = model_geometries(PtConfig(**TINY), "train")[4]
    fusion = pt_fusion.TransformerFusion(8, (64, 96), [], zone_sample_num=4).to(dtype)
    x = torch.randn(1, 48, 64, 8, dtype=dtype)
    upstream = torch.randn(1, 48, 64, 8, dtype=dtype)
    feat1 = torch.zeros(1, geom.zone_num ** 2, 4, 8, dtype=dtype)
    mask = torch.ones(1, geom.zone_num ** 2, dtype=torch.bool)

    def run(crops):
        fusion.zero_grad(set_to_none=True)
        out = fusion(x, feat1, mask, geom, crops)
        out.backward(upstream)
        return out.detach(), fusion.positional_encodings.grad

    seen = set()
    for seed in range(20):
        want = run(pt_steps.step_generator(seed))
        drawing = pt_fusion.DeviceCrops(generator=pt_steps.step_generator(seed))
        got = run(drawing)
        assert drawing.shapes == [(48, 64, 64, 96)]
        starts = pt_fusion.crop_starts(drawing.shapes, pt_steps.step_generator(seed))
        off = pt_fusion.crop_offsets(48, 64, 64, 96, pt_steps.step_generator(seed))
        assert starts == [off[0] * 96 + off[1]]
        seen.add(off)
        static = run(pt_fusion.DeviceCrops(starts=torch.tensor(starts)))
        for a, b, c in zip(got, static, want):
            assert torch.equal(a, c) and torch.equal(b, c), seed
    assert len(seen) > 15


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tiny_loss_with_gathered_crops_equals_sliced(tiny, dtype):
    """The tiny model's loss and every gradient with its three fusions'
    crops gathered (``DeviceCrops`` of the starts ``crop_starts`` draws)
    against the eager step's sliced crops, same generator seed: bit for
    bit; the running statistics too."""
    b = _pt_batch(_batch(tiny["cfg"], 41), dtype)
    got, want = [], []
    for out, crops in ((want, None), (got, "starts")):
        port = _port(tiny).to(dtype)
        loss_fn = pt_steps.make_loss_fn(port, tiny["pt_cfg"], tiny["geoms"])
        generator = pt_steps.step_generator(13)
        if crops:
            drawing = pt_fusion.DeviceCrops(generator=pt_steps.step_generator(13))
            loss_fn(b, drawing)  # records the crops' shapes
            assert len(drawing.shapes) == 3
            port = _port(tiny).to(dtype)
            loss_fn = pt_steps.make_loss_fn(port, tiny["pt_cfg"], tiny["geoms"])
            generator = pt_fusion.DeviceCrops(
                starts=torch.tensor(pt_fusion.crop_starts(drawing.shapes, generator)))
        loss = loss_fn(b, generator)
        loss.backward()
        out.append(loss.detach())
        out.extend(p.grad for p in port.parameters())
        out.extend(_bn_stats(port.state_dict()).values())
    assert len(got) == len(want)
    assert all(torch.equal(a, c) for a, c in zip(got, want))


def test_graph_routing_policy(tiny, monkeypatch):
    """The step is captured in a CUDA graph on a CUDA device with no grid,
    no process group and no ``--remat``; every other step, and every step
    on the CPU, runs eager and counts ``train.eager_steps``."""
    from cfpnet_torch import tracing

    cfg, cuda = tiny["pt_cfg"], torch.device("cuda")
    assert pt_steps.graph_engages(cuda, cfg)
    assert not pt_steps.graph_engages(torch.device("cpu"), cfg)
    assert not pt_steps.graph_engages(cuda, cfg, grid=object())
    assert not pt_steps.graph_engages(cuda, cfg.replace(remat=True))
    with monkeypatch.context() as m:
        m.setattr(pt_steps, "is_distributed", lambda: True)
        assert not pt_steps.graph_engages(cuda, cfg)
    b = _pt_batch(_batch(tiny["cfg"], 42))
    tracing.reset_counters("train.")
    for options in (dict(), dict(remat=True)):
        port = _port(tiny, **options)
        state = pt_steps.create_train_state(port, cfg, total_steps=20)
        step = pt_steps.make_train_step(port, cfg.replace(**options), tiny["geoms"])
        step(state, b, seed=1)
    assert tracing.counters("train.") == {"train.eager_steps": 2}


def test_each_step_returns_its_own_loss(tiny):
    """Two steps' losses are two tensors, each with its own step's value."""
    port = _port(tiny)
    state = pt_steps.create_train_state(port, tiny["pt_cfg"], total_steps=20)
    step = pt_steps.make_train_step(port, tiny["pt_cfg"], tiny["geoms"])
    b = _pt_batch(_batch(tiny["cfg"], 43))
    first = step(state, b, seed=1)
    kept = first.clone()
    second = step(state, b, seed=2)
    assert first is not second and first.data_ptr() != second.data_ptr()
    assert torch.equal(first, kept) and not torch.equal(first, second)


# ---- the kernels' gradients ---------------------------------------------------

@pytest.mark.parametrize("k", [7, 15, 31])
def test_dwconv_gradient_flipped_taps_f64(k):
    """dx as the conv of dy with the rotated taps, dW by ``torch.nn.grad.conv2d_weight``
    (here its CPU twin) and db, against autograd of the plain version and
    jax.vjp of the JAX package's depthwise conv, in float64."""
    from cfpnet_tpu.ops.dwconv import depthwise_conv2d as jx_dwconv

    rng = np.random.default_rng(k)
    B, H, W, C = 2, 11, 17, 8
    x, w, b, g = (rng.standard_normal(s) for s in ((B, H, W, C), (C, 1, k, k), (C,), (B, H, W, C)))
    # the identity itself: dx = conv(dy, rot180(w))
    xt, wt, bt = (t(a).requires_grad_() for a in (x, w, b))
    ref = torch.autograd.grad(pt_dwconv_plain(xt, wt, bt), (xt, wt, bt), t(g))
    close(pt_dwconv_plain(t(g), t(w).flip(-1, -2)).numpy(), ref[0].numpy(), rtol=1e-12)
    got = torch.autograd.grad(pt_dwconv.depthwise_conv2d(xt, wt, bt), (xt, wt, bt), t(g))
    for a, r in zip(got, ref):
        close(a.numpy(), r.numpy(), rtol=1e-12)
    with enable_x64():
        hwio = jnp.asarray(np.transpose(w, (2, 3, 1, 0)))
        _, vjp = jax.vjp(lambda xx, ww, bb: jx_dwconv(xx, ww, bb), jnp.asarray(x), hwio,
                         jnp.asarray(b))
        jdx, jdw, jdb = vjp(jnp.asarray(g))
    close(got[0].numpy(), np.asarray(jdx), rtol=1e-10, atol=1e-12)
    close(got[1].numpy(), np.transpose(np.asarray(jdw), (3, 2, 0, 1)), rtol=1e-10, atol=1e-12)
    close(got[2].numpy(), np.asarray(jdb), rtol=1e-10, atol=1e-12)


def test_dwconv_gradient_only_what_is_asked():
    """The backward computes no gradient that autograd does not ask for."""
    x = torch.randn(1, 6, 7, 4, dtype=torch.float64, requires_grad=True)
    w = torch.randn(4, 1, 7, 7, dtype=torch.float64)
    out = pt_dwconv.depthwise_conv2d(x, w, torch.zeros(4, dtype=torch.float64))
    (dx,) = torch.autograd.grad(out.sum(), (x,))
    close(dx.numpy(), pt_dwconv_plain(torch.ones_like(x), w.flip(-1, -2)).detach().numpy(),
          rtol=1e-12)


def test_attention_gradient_is_the_plain_versions(monkeypatch):
    """The gradient registered on the op ``cfpnet::linear_attention``, which
    the card runs too (the op's CPU implementation is the plain version
    here): dq, dk and dv equal autograd of the plain version (the backward
    recomputes it from the saved inputs) and jax.vjp of the JAX package's
    linear attention, in float64."""
    backwards = []
    backward = pt_la._backward

    def recording(ctx, grad):
        backwards.append(grad.shape)
        return backward(ctx, grad)

    monkeypatch.setattr(pt_la, "_backward", recording)
    pt_la.linear_attention_op.register_autograd(lambda ctx, g: pt_la._backward(ctx, g),
                                                setup_context=pt_la._setup_context)
    rng = np.random.default_rng(2)
    q, k, v, g = (rng.standard_normal(s) for s in ((2, 9, 4, 8), (2, 13, 4, 8), (2, 13, 4, 8),
                                                   (2, 9, 4, 8)))
    ins = [t(a).requires_grad_() for a in (q, k, v)]
    try:
        got = torch.autograd.grad(pt_la.linear_attention(*ins), ins, t(g))
    finally:
        pt_la.linear_attention_op.register_autograd(backward,
                                                    setup_context=pt_la._setup_context)
    assert backwards == [(2, 9, 4, 8)]
    ref = torch.autograd.grad(pt_attention_plain(*ins), ins, t(g))
    with enable_x64():
        _, vjp = jax.vjp(lambda a, b, c: jx_attention(a, b, c), *map(jnp.asarray, (q, k, v)))
        jref = vjp(jnp.asarray(g))
    for a, r, j in zip(got, ref, jref):
        np.testing.assert_array_equal(a.numpy(), r.numpy())
        close(a.numpy(), np.asarray(j))


# ---- --grad_accum and --remat ------------------------------------------------------

def _jx_state(tiny, cfg, total_steps=20):
    v = tiny["variables"]
    return jx_steps.TrainState.create(apply_fn=tiny["model"].apply, params=v["params"],
                                      batch_stats=v["batch_stats"],
                                      tx=jx_optim.make_optimizer(cfg, total_steps=total_steps))


def _assert_state_equals_jax(port, jx_state, pt_cfg, atol, what=""):
    ref = weights.from_flax(jax.tree_util.tree_map(np.asarray, jx_state.params),
                            jax.tree_util.tree_map(np.asarray, jx_state.batch_stats), pt_cfg)
    for k, s in port.state_dict().items():
        np.testing.assert_allclose(s.numpy(), ref[k].numpy(), rtol=1e-7, atol=atol,
                                   err_msg=f"{what}{k}")


def test_grad_accum_step_matches_jax_f64(tiny, monkeypatch):
    """One ``--grad_accum 2`` step at bs 4 (clipping on): two microbatches of
    2 in order, each with its own crop offsets, the statistics threaded
    through them, the summed gradients divided by 2 once; loss, parameters
    and statistics against the JAX step. The JAX step runs its microbatch
    loop unrolled (``pre_split``, the batch split [2, 2, ...] on the host:
    the same body), so that the recorded offsets replay in order."""
    cfg = tiny["cfg"].replace(grad_accum=2, disable_clip_grad=False)
    pt_cfg = tiny["pt_cfg"].replace(grad_accum=2, disable_clip_grad=False)
    geoms = tiny["geoms"]
    b = _batch(cfg, 30, batch=4)
    port = _port(tiny)
    state = pt_steps.create_train_state(port, pt_cfg, total_steps=20)
    offsets = RecordedOffsets(monkeypatch)
    loss = pt_steps.make_train_step(port, pt_cfg, geoms)(state, _pt_batch(b), seed=7)
    assert len(offsets.drawn) == 6 and offsets.drawn[:3] != offsets.drawn[3:]
    left = offsets.replay_in_jax()
    with enable_x64():
        jx_step = jx_steps.make_train_step(tiny["model"], cfg, geoms, jit=False, pre_split=True)
        split = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in _jx_batch(b).items()}
        jx_state, ref_loss = jax.jit(jx_step)(_jx_state(tiny, cfg), split, jax.random.key(0))
    assert next(left, None) is None
    assert state.step == int(jx_state.step) == 1
    close(float(loss), float(ref_loss))
    _assert_state_equals_jax(port, jx_state, pt_cfg, atol=cfg.lr * 2.0 ** -22)


def test_grad_accum_sums_then_divides_once(tiny):
    """The step's gradients are (g0 + g1) / 2 of the two microbatches'
    unscaled losses, bit for bit, and its loss their mean."""
    pt_cfg = tiny["pt_cfg"].replace(grad_accum=2)
    b = _pt_batch(_batch(tiny["cfg"], 31, batch=4))
    port = _port(tiny)
    loss_fn = pt_steps.make_loss_fn(port, pt_cfg, tiny["geoms"])
    generator, want, losses = pt_steps.step_generator(3), {}, []
    for i in range(2):
        part = loss_fn({k: v[2 * i:2 * i + 2] for k, v in b.items()}, generator)
        grads = torch.autograd.grad(part, list(port.parameters()))
        for (k, _), g in zip(port.named_parameters(), grads):
            want[k] = g if i == 0 else want[k] + g
        losses.append(part.detach())
    port = _port(tiny)  # the statistics as they were
    state = pt_steps.create_train_state(port, pt_cfg, total_steps=20)
    loss = pt_steps.make_train_step(port, pt_cfg, tiny["geoms"])(state, b, seed=3)
    assert torch.equal(loss, (losses[0] + losses[1]) / 2)
    for k, p in port.named_parameters():
        assert torch.equal(p.grad, want[k] / 2), k


def test_grad_accum_must_divide_the_batch(tiny):
    pt_cfg = tiny["pt_cfg"].replace(grad_accum=3)
    port = _port(tiny)
    state = pt_steps.create_train_state(port, pt_cfg, total_steps=20)
    step = pt_steps.make_train_step(port, pt_cfg, tiny["geoms"])
    with pytest.raises(ValueError, match="--grad_accum 3 does not divide batch size 4"):
        step(state, _pt_batch(_batch(tiny["cfg"], 32, batch=4)), seed=0)


def _loss_and_grads(port, pt_cfg, geoms, b, seed=11):
    loss = pt_steps.make_loss_fn(port, pt_cfg, geoms)(b, pt_steps.step_generator(seed))
    loss.backward()
    return (loss.detach(), {k: p.grad for k, p in port.named_parameters()},
            _bn_stats(port.state_dict()))


def test_remat_step_equals_the_plain_step_and_jax_f64(tiny, monkeypatch):
    """``--remat``: the image encoder recomputed in the backward. Loss,
    every gradient and every running statistic equal the plain step's bit
    for bit, and the JAX remat model's (``nn.remat``) at rtol 1e-7; the
    statistics moved once. A recompute that updates the statistics again
    (``frozen_running_stats`` taken out) moves the encoder's twice, and the
    comparison sees it."""
    from cfpnet_torch.models import deltar as pt_deltar

    cfg, pt_cfg, geoms = tiny["cfg"].replace(remat=True), tiny["pt_cfg"], tiny["geoms"]
    b = _batch(cfg, 33)
    plain = _loss_and_grads(_port(tiny), pt_cfg, geoms, _pt_batch(b))
    port = _port(tiny, remat=True)
    assert port.remat
    offsets = RecordedOffsets(monkeypatch)
    remat = _loss_and_grads(port, pt_cfg.replace(remat=True), geoms, _pt_batch(b))
    for got, want in zip(remat, plain):
        if isinstance(got, dict):
            assert got.keys() == want.keys()
            assert all(torch.equal(got[k], want[k]) for k in got)
        else:
            assert torch.equal(got, want)
    offsets.replay_in_jax()
    v = tiny["variables"]
    with enable_x64():
        jx_model = jx_make_model(cfg, tiny=True)
        jx_loss = jx_steps.make_loss_fn(jx_model, cfg, geoms)
        (ref_loss, updates), grads = jax.jit(jax.value_and_grad(jx_loss, has_aux=True))(
            v["params"], v["batch_stats"], _jx_batch(b), jax.random.key(0))
    monkeypatch.undo()
    close(float(remat[0]), float(ref_loss))
    ref_grads = weights.from_flax(jax.tree_util.tree_map(np.asarray, grads), None, pt_cfg)
    for k, g in remat[1].items():
        np.testing.assert_allclose(g.numpy(), ref_grads[k].numpy(), rtol=1e-7, atol=1e-12,
                                   err_msg=k)
    ref_stats = weights.from_flax({}, jax.tree_util.tree_map(np.asarray, updates["batch_stats"]),
                                  pt_cfg)
    for k, s in remat[2].items():
        np.testing.assert_allclose(s.numpy(), ref_stats[k].numpy(), rtol=1e-7, atol=1e-12,
                                   err_msg=k)

    # the planted fault: the recompute moves the statistics a second time
    import contextlib

    monkeypatch.setattr(pt_deltar, "frozen_running_stats", contextlib.nullcontext)
    twice = _loss_and_grads(_port(tiny, remat=True), pt_cfg.replace(remat=True), geoms,
                            _pt_batch(b))[2]
    moved = [k for k in twice if not np.allclose(twice[k].numpy(), ref_stats[k].numpy(),
                                                 rtol=1e-7, atol=1e-12)]
    assert moved and all(k.startswith("img_encoder.") for k in moved)


@pytest.mark.parametrize("option", [dict(remat=True), dict(grad_accum=2)])
def test_bf16_remat_and_grad_accum_keep_float32_masters(tiny, option):
    """In a bf16 step: the remat step equals the plain bf16 step bit for bit
    (the recompute runs on the bf16 copies the forward saw, not on the
    float32 masters put back by then); the ``--grad_accum 2`` step leaves
    float32 gradients on the float32 masters and moves them."""
    pt_cfg = tiny["pt_cfg"].replace(compute_dtype="bfloat16")
    b = _pt_batch(_batch(tiny["cfg"], 34, batch=4), torch.float32)

    def port():
        m = pt_make_model(pt_cfg.replace(**option), tiny=True, device="cpu")
        m.load_state_dict({k: v.float() for k, v in _port(tiny).state_dict().items()})
        return m

    if option.get("remat"):
        plain = _loss_and_grads(port().float(), pt_cfg, tiny["geoms"], b)
        m = port()
        assert m.remat
        remat = _loss_and_grads(m, pt_cfg.replace(remat=True), tiny["geoms"], b)
        assert torch.equal(remat[0], plain[0])
        assert all(torch.equal(remat[1][k], plain[1][k]) for k in plain[1])
        assert all(torch.equal(remat[2][k], plain[2][k]) for k in plain[2])
        return
    m = port()
    before = {k: p.detach().clone() for k, p in m.named_parameters()}
    cfg = pt_cfg.replace(**option)
    state = pt_steps.create_train_state(m, cfg, total_steps=20)
    loss = pt_steps.make_train_step(m, cfg, tiny["geoms"])(state, b, seed=5)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert {p.grad.dtype for p in m.parameters()} == {p.dtype for p in m.parameters()} == {
        torch.float32}
    assert sum(not torch.equal(p, before[k]) for k, p in m.named_parameters()) > 0.9 * len(before)


def test_train_mode_forward_returns_edges_and_pred(tiny):
    """``make_model`` gives an eval model (four outputs); in training mode
    the forward returns (bin_edges, pred), as the JAX model's does."""
    port = _port(tiny)
    assert not port.training
    b = _pt_batch(_batch(tiny["cfg"], 4))
    args = (b["image"], b["hist_data"], b["mask"], tiny["geoms"])
    assert len(port(*args)) == 4
    out = port.train()(*args, pt_steps.step_generator(0))
    assert len(out) == 2 and out[1].shape == (2, 24, 32, 1)


# ---- timing entry points on the CPU ------------------------------------------

def test_timed_train_step_on_cpu():
    """``python -m cfpnet_torch.evaluate_time --train`` on the CPU (host
    clock) at the tiny size: a positive time a step (the loop raises on a
    loss that is not finite) and the step's operations."""
    from cfpnet_torch import evaluate_time

    argv = ["--train", "--device", "cpu", "--tiny_model", "--niters", "2", "--profile_flops",
            "--bs", "2"] + [a for k, v in TINY.items() if k not in ("bs", "epochs")
                            for a in _flag(k, v)]
    out = evaluate_time.main(argv)
    assert out["train_ms_bs2"] > 0 and out["flops_train"] > 0


def _flag(key, value):
    if value is True:
        return [f"--{key}"]
    if value is False:
        return []
    return [f"--{key}", *map(str, value)] if isinstance(value, list) else [f"--{key}", str(value)]


def test_train_config_is_the_root_benchs():
    import bench as root_bench
    from cfpnet_torch import bench, evaluate_time

    want = root_bench.train_config(JxConfig())
    got = evaluate_time.train_config(bench.production_config())
    for key in ("bs", "input_height", "input_width", "train_zone_num", "drop_hist",
                "noise_mean", "noise_sigma", "noise_prob", "disable_clip_grad",
                "hist_encoder_10x", "mode"):
        assert getattr(got, key) == getattr(want, key), key


def test_flops_train_counts(tiny):
    """Three times the train forward and loss, the depthwise convs included
    at 2·k²·B·H·W·C a forward, and linear in the batch."""
    from torch.utils.flop_counter import FlopCounterMode

    from cfpnet_torch import evaluate_time
    from cfpnet_torch.models.convnext import LargeKernelDWConv

    cfg = tiny["pt_cfg"]
    one = evaluate_time.flops_train(cfg, 1, tiny=True)
    assert evaluate_time.flops_train(cfg, 3, tiny=True) == 3 * one
    model = pt_make_model(cfg, tiny=True, device="cpu")
    b = _pt_batch(_batch(cfg, 5, batch=1), torch.float32)
    dw = []
    for m in model.modules():
        if isinstance(m, LargeKernelDWConv):
            m.register_forward_hook(lambda mod, a, out: dw.append(
                2 * mod.weight.shape[-1] ** 2 * out.numel()))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        pt_steps.make_loss_fn(model, cfg, tiny["geoms"])(b, pt_steps.step_generator(0))
    assert len(dw) == 3 and one == 3 * (counter.get_total_flops() + sum(dw))


# ---- the golden production step -------------------------------------------------

def write_train_golden(path, x64: bool = True, compute_dtype: str = "float32"):
    """One production train step of the JAX package, float64 on the CPU
    (float32 with ``x64=False``: the reference's own rounding, which sets
    how far a float32 step can be from the golden; with ``compute_dtype``
    "bfloat16" its mixed-precision step on float32 masters, compiled with
    ``xla_allow_excess_precision`` off so that each op rounds to its dtype,
    as in tests/test_torch_port_bf16.py):
    ``chip_smoke.golden_train_config`` (bs 2 at 416x544), the deterministic
    weights, ``chip_smoke.golden_train_batch``, the crop offsets the port's
    generator draws at the golden seed (handed to the JAX model through
    ``jax.random.randint``). ``make_loss_fn`` under ``jax.value_and_grad``
    gives the loss and gradients, ``make_train_step`` the parameters and
    BatchNorm statistics after the step. Kept per parameter (port names and
    layouts): the gradient's sum and norm, its entries and the parameter
    after the step at ``chip_smoke.leaf_indices``; every running statistic."""
    import dataclasses

    import chip_smoke

    pt_cfg = chip_smoke.golden_train_config()
    cfg = JxConfig(**{f.name: getattr(pt_cfg, f.name) for f in dataclasses.fields(JxConfig)})
    cfg = cfg.replace(compute_dtype=compute_dtype)
    geoms = model_geometries(cfg, "train")
    b = chip_smoke.golden_train_batch(pt_cfg)
    offsets = chip_smoke.golden_crop_offsets(pt_cfg, chip_smoke.GOLDEN_TRAIN_SEED)
    model = jx_make_model(cfg)
    real_randint = jax.random.randint

    def replay():
        draws = iter([o for off in offsets for o in off])
        jax.random.randint = lambda key, shape, lo, hi, *a, **kw: jnp.asarray(next(draws))
        return draws

    dtype = np.float64 if x64 else np.float32
    options = {} if compute_dtype == "float32" else {"xla_allow_excess_precision": False}

    def run(fn, *args):
        return jax.jit(fn).lower(*args).compile(compiler_options=options)(*args)

    try:
        with enable_x64() if x64 else contextlib.nullcontext():
            shapes = jax.eval_shape(
                lambda r: model.init({"params": r, "fusion": r}, jnp.asarray(b["image"]),
                                     jnp.asarray(b["hist_data"]), jnp.asarray(b["mask"]),
                                     geoms, train=True), jax.random.key(0))
            variables = jax.tree_util.tree_map_with_path(
                lambda path, s: weights.det_leaf("/".join(p.key for p in path),
                                                 s.shape).astype(dtype), shapes)
            batch = _jx_batch(b)
            draws = replay()
            (loss, _), grads = run(jax.value_and_grad(
                jx_steps.make_loss_fn(model, cfg, geoms), has_aux=True),
                variables["params"], variables["batch_stats"], batch, jax.random.key(0))
            assert next(draws, None) is None
            tx = jx_optim.make_optimizer(cfg, chip_smoke.GOLDEN_TRAIN_TOTAL_STEPS)
            state = jx_steps.TrainState.create(apply_fn=model.apply, params=variables["params"],
                                               batch_stats=variables["batch_stats"], tx=tx)
            draws = replay()
            state, step_loss = run(jx_steps.make_train_step(model, cfg, geoms, jit=False),
                                   state, batch, jax.random.key(0))
            assert next(draws, None) is None
    finally:
        jax.random.randint = real_randint
    np.testing.assert_allclose(float(step_loss), float(loss),
                               rtol=0 if x64 else 1e-6 if compute_dtype == "float32" else 1e-3)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    g = weights.from_flax(to_np(grads), None, pt_cfg)
    after = weights.from_flax(to_np(state.params), to_np(state.batch_stats), pt_cfg)
    out = dict(loss=np.asarray(loss), crop_offsets=np.asarray(offsets),
               seed=chip_smoke.GOLDEN_TRAIN_SEED)
    for k, v in after.items():
        if k in g:
            flat, idx = g[k].numpy().ravel(), chip_smoke.leaf_indices(g[k].numel())
            out["grad_sum:" + k] = flat.sum()
            out["grad_norm:" + k] = np.linalg.norm(flat)
            out["grad_at:" + k] = flat[idx]
            out["param_at:" + k] = v.numpy().ravel()[idx]
        else:
            out["stat:" + k] = v.numpy()
    np.savez_compressed(path, **out)
    return out


def golden_tolerance(path, compute_dtype="float32"):
    """``chip_smoke.TRAIN_GOLDEN_TOL`` (float32) or ``TRAIN_GOLDEN_TOL_BF16``
    (``compute_dtype`` "bfloat16") from the same comparison on the CPU: the
    port's step in that dtype (``train_golden_errors(device="cpu")``) and
    the JAX package's own step in it (written to ``path``), each against
    the float64 golden; the tolerance of each kind is 4 times the larger,
    rounded up to two digits."""
    import math

    import chip_smoke

    write_train_golden(path, x64=False, compute_dtype=compute_dtype)
    ref = np.load(chip_smoke.GOLDEN_TRAIN)
    jax_errs = chip_smoke.golden_errors(np.load(path), ref)
    port_errs = chip_smoke.train_golden_errors(device="cpu", compute_dtype=compute_dtype)[0]
    tol = {}
    for k in sorted(port_errs):
        v = 4 * max(port_errs[k], jax_errs[k])
        e = math.floor(math.log10(v)) - 1
        tol[k] = math.ceil(v / 10 ** e) * 10 ** e
    return port_errs, jax_errs, tol


def _frozen_statistics(ref, start):
    return {k: start[k[5:]].double().numpy() for k in ref if k.startswith("stat:")}


def _zeroed_trunk_gradients(ref, start):
    return {k: 0 * ref[k] for k in ref if k.startswith(("grad_at:", "grad_norm:", "grad_sum:"))
            and not k.split(":", 1)[1].startswith(("depth_head.", "conv_out."))}


def _unmoved_trunk_parameters(ref, start):
    import chip_smoke

    names = [k[9:] for k in ref if k.startswith("param_at:")]
    return {"param_at:" + n: start[n].double().numpy().ravel()[
        chip_smoke.leaf_indices(start[n].numel())]
        for n in names if not n.startswith(("depth_head.", "conv_out."))}


@pytest.mark.parametrize("change,key", [
    (_frozen_statistics, "stat_median"),
    (_zeroed_trunk_gradients, "trunk_grad_norm_median"),
    (_unmoved_trunk_parameters, "trunk_param_at_median"),
])
def test_golden_budget_fails_a_step_that_left_a_class_unchanged(change, key):
    """The golden itself with one class set back to where the step started
    (running statistics frozen, trunk gradients zeroed, trunk parameters
    unmoved) is out of both card budgets, float32 and bf16, in that class's
    median: the largest errors of the bf16 budget are wide enough to pass
    such a step."""
    import chip_smoke

    ref = dict(np.load(chip_smoke.GOLDEN_TRAIN))
    start = weights.deterministic_state_dict(chip_smoke.golden_train_config())
    errs = chip_smoke.golden_errors({**ref, **change(ref, start)}, ref)
    assert set(errs) == set(chip_smoke.TRAIN_GOLDEN_TOL) == set(chip_smoke.TRAIN_GOLDEN_TOL_BF16)
    assert errs[key] > chip_smoke.TRAIN_GOLDEN_TOL_BF16[key] >= chip_smoke.TRAIN_GOLDEN_TOL[key]


@pytest.mark.slow
def test_golden_step_on_the_cpu_within_the_card_tolerance():
    """The port's float32 step on the CPU against the golden, within the
    tolerance the card is held to (full size: a minute and ~4 GB)."""
    import chip_smoke

    errs, launches, _ = chip_smoke.train_golden_errors(device="cpu")
    assert set(errs) == set(chip_smoke.TRAIN_GOLDEN_TOL)
    for k, v in errs.items():
        assert v <= chip_smoke.TRAIN_GOLDEN_TOL[k], (k, v)


if __name__ == "__main__":
    # python tests/test_torch_port_train.py              write the golden (float64)
    # python tests/test_torch_port_train.py --f32 PATH   the same step in float32
    # python tests/test_torch_port_train.py --tolerance  chip_smoke.TRAIN_GOLDEN_TOL
    #                                                    and TRAIN_GOLDEN_TOL_BF16
    import json
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:2] == ["--tolerance"]:
        out = {}
        with tempfile.TemporaryDirectory() as tmp:
            for dt, sfx in (("float32", "f32"), ("bfloat16", "bf16")):
                port, jax_own, tol = golden_tolerance(os.path.join(tmp, f"{sfx}.npz"), dt)
                out.update({f"port_{sfx}_cpu": port, f"jax_{sfx}_cpu": jax_own,
                            "tolerance" + ("" if dt == "float32" else "_bf16"): tol})
        print(json.dumps(out, indent=1))
        sys.exit(0)
    if sys.argv[1:2] == ["--f32"]:
        target, x64 = sys.argv[2], False
    else:
        target, x64 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                                   "torch_port_train_step.npz"), True
    written = write_train_golden(target, x64)
    print(f"wrote {target}: loss {float(written['loss'])}, {len(written)} arrays")
