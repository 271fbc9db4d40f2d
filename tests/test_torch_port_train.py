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


def _port(tiny):
    port = pt_make_model(tiny["pt_cfg"], tiny=True, device="cpu").double()
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
    """The card's autograd.Function, with its launch replaced by the plain
    version here: dq, dk and dv equal autograd of the plain version (the
    backward recomputes it from the saved inputs) and jax.vjp of the JAX
    package's linear attention, in float64."""
    launched = []

    def launch(q, k, v, eps):
        launched.append(q.shape)
        return pt_attention_plain(q, k, v, eps=eps)

    monkeypatch.setattr(pt_la, "_launch", launch)
    rng = np.random.default_rng(2)
    q, k, v, g = (rng.standard_normal(s) for s in ((2, 9, 4, 8), (2, 13, 4, 8), (2, 13, 4, 8),
                                                   (2, 9, 4, 8)))
    ins = [t(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(pt_la._LinearAttention.apply(*ins, 1e-6), ins, t(g))
    assert launched == [(2, 9, 4, 8)]
    ref = torch.autograd.grad(pt_attention_plain(*ins), ins, t(g))
    with enable_x64():
        _, vjp = jax.vjp(lambda a, b, c: jx_attention(a, b, c), *map(jnp.asarray, (q, k, v)))
        jref = vjp(jnp.asarray(g))
    for a, r, j in zip(got, ref, jref):
        np.testing.assert_array_equal(a.numpy(), r.numpy())
        close(a.numpy(), np.asarray(j))


# ---- what is not ported raises ------------------------------------------------

@pytest.mark.parametrize("option", [dict(grad_accum=2), dict(remat=True),
                                    dict(compute_dtype="bfloat16")])
def test_unported_options_raise(tiny, option):
    cfg = tiny["pt_cfg"].replace(**option)
    port = pt_make_model(cfg, tiny=True, device="meta")
    with pytest.raises(NotImplementedError):
        pt_steps.make_train_step(port, cfg, tiny["geoms"])
    with pytest.raises(NotImplementedError):
        pt_steps.create_train_state(port, cfg, 10)


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

def write_train_golden(path, x64: bool = True):
    """One production train step of the JAX package, float64 on the CPU
    (float32 with ``x64=False``: the reference's own rounding, which sets
    how far a float32 step can be from the golden):
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
            (loss, _), grads = jax.jit(jax.value_and_grad(
                jx_steps.make_loss_fn(model, cfg, geoms), has_aux=True))(
                    variables["params"], variables["batch_stats"], batch, jax.random.key(0))
            assert next(draws, None) is None
            tx = jx_optim.make_optimizer(cfg, chip_smoke.GOLDEN_TRAIN_TOTAL_STEPS)
            state = jx_steps.TrainState.create(apply_fn=model.apply, params=variables["params"],
                                               batch_stats=variables["batch_stats"], tx=tx)
            draws = replay()
            state, step_loss = jax.jit(jx_steps.make_train_step(model, cfg, geoms, jit=False))(
                state, batch, jax.random.key(0))
            assert next(draws, None) is None
    finally:
        jax.random.randint = real_randint
    np.testing.assert_allclose(float(step_loss), float(loss), rtol=0 if x64 else 1e-6)
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


def golden_tolerance(f32_path):
    """``chip_smoke.TRAIN_GOLDEN_TOL`` from the same comparison on the CPU in
    float32: the port's step (``train_golden_errors(device="cpu")``) and the
    JAX package's own float32 step (written to ``f32_path``), each against
    the float64 golden; the tolerance of each kind is 4 times the larger,
    rounded up to two digits."""
    import math

    import chip_smoke

    write_train_golden(f32_path, x64=False)
    ref = np.load(chip_smoke.GOLDEN_TRAIN)
    jax_f32 = chip_smoke.golden_errors(np.load(f32_path), ref)
    port_f32 = chip_smoke.train_golden_errors(device="cpu")[0]
    tol = {}
    for k in sorted(port_f32):
        v = 4 * max(port_f32[k], jax_f32[k])
        e = math.floor(math.log10(v)) - 1
        tol[k] = math.ceil(v / 10 ** e) * 10 ** e
    return port_f32, jax_f32, tol


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
    import json
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:2] == ["--tolerance"]:
        with tempfile.TemporaryDirectory() as tmp:
            port_f32, jax_f32, tol = golden_tolerance(os.path.join(tmp, "f32.npz"))
        print(json.dumps(dict(port_f32_cpu=port_f32, jax_f32_cpu=jax_f32, tolerance=tol),
                         indent=1))
        sys.exit(0)
    if sys.argv[1:2] == ["--f32"]:
        target, x64 = sys.argv[2], False
    else:
        target, x64 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                                   "torch_port_train_step.npz"), True
    written = write_train_golden(target, x64)
    print(f"wrote {target}: loss {float(written['loss'])}, {len(written)} arrays")
