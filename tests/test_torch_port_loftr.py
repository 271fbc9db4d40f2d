"""The port's LoFTR layer op (``cfpnet_torch/ops/loftr.py``, the CPU path of
``kernels/fused_loftr.py``) against ``cfpnet_tpu/ops/pallas_loftr.py``: the
XLA composite in float64, the TPU kernel itself in interpret mode in
float32, the LayerNorm clone, the custom VJP, the weight bridge, and the
dispatch rules.

The JAX package's ``layernorm_f32`` casts to float32 whatever the input
(under x64 too), so its float64 composite carries float32 rounding in both
LayerNorms. The float64 comparisons therefore run the composite with flax's
own ``nn.LayerNorm``, whose fast-variance arithmetic the clone copies and
which keeps float64 in float64."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cfpnet_torch import weights
from cfpnet_torch.kernels import fused_loftr as loftr_kernel
from cfpnet_torch.models import transformer as pt_tr
from cfpnet_torch.models.deltar import model_geometries
from cfpnet_torch.ops import dispatch
from cfpnet_torch.ops.attention import linear_attention
from cfpnet_torch.ops.loftr import LoFTRParams, layernorm_f32, loftr_apply
from cfpnet_tpu.models import transformer as jx_tr
from cfpnet_tpu.ops import pallas_loftr
from tests.torch_port_util import close, enable_x64, load, t

# the three shapes of tests/test_pallas_loftr.py, then C = 32, 64, 128 with 4 and 8 heads
SHAPES = [(6, 18, 18, 16, 4), (4, 24, 5, 16, 2), (2, 16, 8, 32, 8),
          (3, 11, 7, 32, 4), (2, 9, 13, 64, 8), (2, 5, 6, 128, 4)]


def _flax_layernorm(x, scale, bias, eps=1e-5):
    return nn.LayerNorm(epsilon=eps).apply({"params": {"scale": scale, "bias": bias}}, x)


@pytest.fixture
def flax_layernorm(monkeypatch):
    """``loftr_apply_xla`` and ``_fused_bwd`` with flax's LayerNorm in place
    of the float32-only clone, for float64 comparisons."""
    monkeypatch.setattr(pallas_loftr, "layernorm_f32", _flax_layernorm)


def _tree(C, seed, dtype=np.float64):
    """A flax ``LoFTREncoderLayer`` param dict at the scale of
    ``tests/test_pallas_loftr.py::make_params``."""
    rng = np.random.default_rng(seed)
    r = lambda *s: (0.1 * rng.standard_normal(s)).astype(dtype)
    ln = lambda: {"scale": (1 + 0.1 * rng.standard_normal(C)).astype(dtype), "bias": r(C)}
    return {"q_proj": {"kernel": r(C, C)}, "k_proj": {"kernel": r(C, C)},
            "v_proj": {"kernel": r(C, C)}, "merge": {"kernel": r(C, C)},
            "mlp_0": {"kernel": r(2 * C, 2 * C)}, "mlp_1": {"kernel": r(2 * C, C)},
            "norm1": ln(), "norm2": ln()}


def _jax_params(tree):
    return pallas_loftr.LoFTRParams(
        wq=tree["q_proj"]["kernel"], wk=tree["k_proj"]["kernel"], wv=tree["v_proj"]["kernel"],
        wm=tree["merge"]["kernel"], g1=tree["norm1"]["scale"], b1=tree["norm1"]["bias"],
        w0=tree["mlp_0"]["kernel"], w1=tree["mlp_1"]["kernel"], g2=tree["norm2"]["scale"],
        b2=tree["norm2"]["bias"])


def _inputs(N, L, S, C, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, L, C)).astype(dtype),
            rng.standard_normal((N, S, C)).astype(dtype))


@pytest.mark.parametrize("N,L,S,C,H", SHAPES)
def test_loftr_apply_matches_xla_composite_f64(flax_layernorm, N, L, S, C, H):
    tree = _tree(C, seed=C + H)
    x, src = _inputs(N, L, S, C, seed=N * L)
    with enable_x64():
        ref = np.asarray(pallas_loftr.loftr_apply_xla(
            jnp.asarray(x), jnp.asarray(src), jax.tree_util.tree_map(jnp.asarray, _jax_params(tree)),
            H))
    p = weights.loftr_params_from_flax(tree)
    got = loftr_apply(t(x), t(src), p, H)
    assert got.dtype == torch.float64
    close(got.numpy(), ref)
    # the kernel's wrapper takes the plain version for a CPU tensor
    close(loftr_kernel.fused_loftr(t(x), t(src), p, H).detach().numpy(), ref)


@pytest.mark.parametrize("N,L,S,C,H", SHAPES)
def test_loftr_apply_matches_pallas_interpret(N, L, S, C, H):
    """The TPU kernel itself in interpret mode, float32, at the tolerance of
    ``tests/test_pallas_loftr.py``."""
    tree = _tree(C, seed=C + H, dtype=np.float32)
    x, src = _inputs(N, L, S, C, seed=N * L, dtype=np.float32)
    ref = np.asarray(pallas_loftr._fused_loftr_impl(
        jnp.asarray(x), jnp.asarray(src), jax.tree_util.tree_map(jnp.asarray, _jax_params(tree)),
        H, interpret=True))
    got = loftr_apply(t(x), t(src), weights.loftr_params_from_flax(tree), H)
    assert got.dtype == torch.float32
    close(got.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_layernorm_f32():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 24)) * 3 + 1
    scale, bias = rng.random(24), rng.random(24)
    # float32: the JAX clone
    x32, s32, b32 = (a.astype(np.float32) for a in (x, scale, bias))
    ref32 = np.asarray(pallas_loftr.layernorm_f32(jnp.asarray(x32), jnp.asarray(s32),
                                                  jnp.asarray(b32)))
    got32 = layernorm_f32(t(x32), t(s32), t(b32))
    assert got32.dtype == torch.float32
    close(got32.numpy(), ref32, rtol=1e-6, atol=1e-6)
    # float64: flax's LayerNorm, since the clone returns float32 even under x64
    with enable_x64():
        assert pallas_loftr.layernorm_f32(jnp.asarray(x), jnp.asarray(scale),
                                          jnp.asarray(bias)).dtype == jnp.float32
        ref64 = np.asarray(_flax_layernorm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    got64 = layernorm_f32(t(x), t(scale), t(bias))
    assert got64.dtype == torch.float64
    close(got64.numpy(), ref64, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("N,L,S,C,H", [(3, 10, 7, 16, 4), (2, 9, 13, 64, 8)])
def test_fused_loftr_grad_matches_custom_vjp_f64(flax_layernorm, N, L, S, C, H):
    tree = _tree(C, seed=40 + C)
    x, src = _inputs(N, L, S, C, seed=41)
    g = np.random.default_rng(42).standard_normal((N, L, C))
    with enable_x64():
        jp = jax.tree_util.tree_map(jnp.asarray, _jax_params(tree))
        dx, dsrc, dp = pallas_loftr._fused_bwd(H, (jnp.asarray(x), jnp.asarray(src), jp),
                                               jnp.asarray(g))
    xt, st = t(x).requires_grad_(), t(src).requires_grad_()
    pt = LoFTRParams(*(t(np.asarray(a)).requires_grad_() for a in _jax_params(tree)))
    out = loftr_kernel.fused_loftr(xt, st, pt, H)
    out.backward(t(g))
    close(xt.grad.numpy(), np.asarray(dx))
    close(st.grad.numpy(), np.asarray(dsrc))
    for name, got, ref in zip(LoFTRParams._fields, pt, dp):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), rtol=1e-7, atol=1e-12,
                                   err_msg=name)


def test_loftr_params_from_flax_and_module():
    C = 32
    tree = _tree(C, seed=5)
    p = weights.loftr_params_from_flax(tree)
    ref = _jax_params(tree)
    for name, got, want in zip(LoFTRParams._fields, p, ref):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        if got.dim() == 2:  # an [in, out] view of [out, in] storage, as the kernel reads it
            assert got.t().is_contiguous(), name
    layer = load(pt_tr.LoFTREncoderLayer(C, 4), weights._loftr_entries(), tree)
    for name, got, want in zip(LoFTRParams._fields, layer.loftr_params(), p):
        assert torch.equal(got, want), name
        assert got.stride() == want.stride(), name


def test_module_grads_reach_linear_weights():
    """A LoFTR layer through dispatch (the fused op's CPU path) gives the
    gradients of its module path, in x, source and the module's weights."""
    C, H = 32, 4
    x, src = _inputs(2, 9, 5, C, seed=7)
    g = t(np.random.default_rng(8).standard_normal((2, 9, C)))
    layer = load(pt_tr.LoFTREncoderLayer(C, H), weights._loftr_entries(), _tree(C, seed=9))
    grads = []
    for fn in (layer.forward, layer.modules_forward):
        layer.zero_grad()
        xt, st = t(x).requires_grad_(), t(src).requires_grad_()
        fn(xt, st).backward(g)
        grads.append([xt.grad, st.grad] + [w.grad.clone() for w in layer.parameters()])
    for a, b in zip(*grads):
        close(a.numpy(), b.numpy(), atol=1e-11)


def test_loftr_layer_dispatch_rules(monkeypatch):
    """Off the CPU an unmasked layer reaches the kernel's checks (which take
    only CUDA tensors): nothing falls back. A masked one takes the layer's
    module path on its device, chosen before the kernel's wrapper is
    reached."""
    layer = pt_tr.LoFTREncoderLayer(32, 4).to("meta")
    x = torch.empty(2, 8, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        dispatch.loftr_layer(x, x, layer)
    mask = torch.ones(2, 8, dtype=torch.bool, device="meta")

    def no_kernel(*args, **kwargs):
        raise AssertionError("a masked layer reached the fused kernel's wrapper")

    monkeypatch.setattr(loftr_kernel, "fused_loftr", no_kernel)
    for out in (dispatch.loftr_layer(x, x, layer, x_mask=mask, source_mask=mask),
                layer(x, x, x_mask=mask)):
        assert out.device.type == "meta" and out.shape == x.shape


# the nine LoFTR-layer shapes of the 480x640 forward, (N, L, S, C, H)
MAIN_PATH = sorted(chip_smoke.main_path_shapes(
    chip_smoke.production_config(),
    model_geometries(chip_smoke.production_config(), "online_eval"))[2])


def _tf32(a):
    """Round f32 to TF32 (10 explicit mantissa bits) to nearest, ties away
    from zero, as cvt.rna.tf32.f32 does: add half a unit to the bits and
    clear the 13 low ones."""
    return ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, w):
    """a @ w as the CUDA kernel takes every product: each operand split into
    TF32 hi + lo, hi*hi + (lo*hi + hi*lo) summed in f32."""
    ah, wh = _tf32(a), _tf32(w)
    al, wl = _tf32(a - ah), _tf32(w - wh)
    return ah @ wh + (al @ wh + ah @ wl)


def _mm_tf32(a, w):
    """a @ w in one pass of TF32, for comparison."""
    return _tf32(a) @ _tf32(w)


def _loftr_emulated(x, src, p, nhead, mm, eps=1e-6):
    """``loftr_apply`` in f32 with its six products through ``mm``, as the
    kernel computes them; the attention's sums stay in f32."""
    N, L, C = x.shape
    S = src.shape[1]
    q = mm(x, p.wq).reshape(N, L, nhead, C // nhead)
    k = mm(src, p.wk).reshape(N, S, nhead, C // nhead)
    v = mm(src, p.wv).reshape(N, S, nhead, C // nhead)
    msg = linear_attention(q, k, v, eps=eps).reshape(N, L, C)
    msg = layernorm_f32(mm(msg, p.wm), p.g1, p.b1)
    h = torch.relu(mm(torch.cat([x, msg], dim=-1), p.w0))
    return layernorm_f32(mm(h, p.w1), p.g2, p.b2) + x


@pytest.mark.parametrize("N,L,S,C,H", MAIN_PATH)
def test_3xtf32_products_meet_the_card_tolerance(N, L, S, C, H):
    """The kernel's arithmetic (every product in 3xTF32), emulated on the
    CPU, against the JAX composite in f32 at the card's tolerance, on inputs
    and std-0.1 weights made as chip_smoke.py makes them; one pass of TF32
    is at least 20 times further off, which is why the kernel pays for three
    products."""
    rng = np.random.default_rng(chip_smoke.SEED + C * L)
    x = rng.standard_normal((N, L, C)).astype(np.float32)
    src = rng.standard_normal((N, S, C)).astype(np.float32)
    tree = _tree(C, seed=C + H, dtype=np.float32)
    ref = np.asarray(pallas_loftr.loftr_apply_xla(
        jnp.asarray(x), jnp.asarray(src), jax.tree_util.tree_map(jnp.asarray, _jax_params(tree)),
        H))
    p = weights.loftr_params_from_flax(tree)
    scale = np.abs(ref).max()
    err3 = np.abs(_loftr_emulated(t(x), t(src), p, H, _mm_3xtf32).numpy() - ref).max()
    err1 = np.abs(_loftr_emulated(t(x), t(src), p, H, _mm_tf32).numpy() - ref).max()
    print(f"N={N} L={L} S={S} C={C} H={H}: max|JAX| {scale:.3f}, 3xTF32 {err3:.3g}, "
          f"1xTF32 {err1:.3g}")
    assert err3 <= 1e-4 * scale
    assert err1 >= 20 * err3
