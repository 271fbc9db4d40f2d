"""``--compute_dtype bfloat16`` in the port's eval forward, on the CPU.

- Each kernel's plain twin in bf16 (``ops/attention.py``, ``ops/dwconv.py``,
  ``ops/loftr.py``: the CUDA kernels' bf16 variants round where these do)
  against its JAX Pallas kernel in interpret mode on the same bf16 inputs,
  made from a seed with numpy, within ``2^-7 * max |JAX|``, at two small
  shapes each; the dwconv twin also equals the f32 twin on the same
  bf16-valued inputs, rounded once.
- The tiny model cast by ``cast_to_compute_dtype`` against the JAX tiny
  model under the JAX drivers' tree cast, on the same ``from_flax`` weights:
  the port's bf16 prediction lies closer to JAX's bf16 than JAX's bf16 lies
  to its own f32, and each package's bf16 stays within
  ``tests/test_bf16.py``'s drift budget of its f32.
- The kernels' dtype checks take float32 and bfloat16 and refuse other and
  mixed dtypes; ``CapturedForward`` refuses inputs of the other dtype; the
  dispatch casts nothing; ``evaluate_time`` casts inputs and model.

The JAX side runs compiled with ``xla_allow_excess_precision`` off. By
default XLA on the CPU keeps bf16 intermediates of a fusion in float32 (it
drops the roundings between fused ops), so its "bf16" skips rounding points
that the Pallas bodies name and that a bf16 program on the TPU makes: in
interpret mode the attention kernel's ``V / S`` reaches its product
unrounded, and about 40% of its outputs land one bf16 ulp away from the
body as written. With the option off each op rounds to its dtype, and the
attention twin equals the Pallas kernel bit for bit at the shapes below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfpnet_torch import evaluate_time as pt_evaluate_time
from cfpnet_torch import weights
from cfpnet_torch.graphs import CapturedForward
from cfpnet_torch.kernels import dwconv as dwconv_kernel
from cfpnet_torch.kernels import fused_loftr as loftr_kernel
from cfpnet_torch.kernels import linear_attention as attention_kernel
from cfpnet_torch.models.deltar import cast_to_compute_dtype, compute_dtype
from cfpnet_torch.models.deltar import make_model as pt_make_model
from cfpnet_torch.ops import dispatch
from cfpnet_torch.ops.attention import linear_attention as pt_attention
from cfpnet_torch.ops.dwconv import depthwise_conv2d as pt_dwconv
from cfpnet_torch.ops.loftr import LoFTRParams as PtParams
from cfpnet_torch.ops.loftr import loftr_apply as pt_loftr
from cfpnet_tpu.config import Config
from cfpnet_tpu.models.deltar import make_model as jx_make_model
from cfpnet_tpu.models.deltar import model_geometries
from cfpnet_tpu.ops.pallas_attention import linear_attention_pallas
from cfpnet_tpu.ops.pallas_dwconv import depthwise_conv2d_pallas
from cfpnet_tpu.ops.pallas_loftr import LoFTRParams as JxParams
from cfpnet_tpu.ops.pallas_loftr import _fused_loftr_impl
from tests.torch_port_util import random_tree

BF16_TOL = 2.0 ** -7  # one bf16 ulp at the top of the range
STRICT = {"xla_allow_excess_precision": False}  # each op rounds to its dtype (module docstring)
DRIFT = dict(median_rel=0.06, median_abs=0.08)  # tests/test_bf16.py's budget
jbf16 = jnp.bfloat16


def _bf16_values(rng, *shape, scale=1.0):
    """Normal values already representable in bf16, as float32."""
    return np.array(jnp.asarray(scale * rng.standard_normal(shape), jbf16).astype(jnp.float32))


def _strict(fn, *args, **static):
    """``fn`` (a jitted function) compiled with every op rounded to its dtype."""
    return fn.lower(*args, **static).compile(compiler_options=STRICT)(*args)


def _pt(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _close(got: torch.Tensor, ref):
    assert got.dtype == torch.bfloat16
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= BF16_TOL * np.abs(ref).max(), err


@pytest.mark.parametrize("N,L,S,H,D", [(2, 37, 19, 4, 8), (1, 64, 50, 4, 16)])
def test_attention_twin_bf16_matches_pallas(N, L, S, H, D):
    rng = np.random.default_rng(0)
    q, k, v = (_bf16_values(rng, N, n, H * D) for n in (L, S, S))
    ref = _strict(linear_attention_pallas, *(jnp.asarray(a, jbf16) for a in (q, k, v)), nhead=H,
                  interpret=True)
    assert ref.dtype == jbf16
    got = pt_attention(*(_pt(a).reshape(N, -1, H, D) for a in (q, k, v)))
    _close(got.reshape(N, L, H * D), ref)


@pytest.mark.parametrize("B,Hh,W,C,k", [(1, 12, 14, 8, 7), (2, 9, 11, 4, 15)])
def test_dwconv_twin_bf16_matches_pallas(B, Hh, W, C, k):
    rng = np.random.default_rng(1)
    x, w, b = (_bf16_values(rng, B, Hh, W, C), _bf16_values(rng, k, k, 1, C, scale=0.05),
               _bf16_values(rng, C))
    ref = _strict(depthwise_conv2d_pallas, *(jnp.asarray(a, jbf16) for a in (x, w, b)),
                  interpret=True)
    w_pt = np.ascontiguousarray(w.reshape(k, k, C).transpose(2, 0, 1)[:, None])
    got = pt_dwconv(_pt(x), _pt(w_pt), _pt(b))
    _close(got, ref)
    # the f32 twin on the same bf16-valued inputs, rounded once
    f32 = pt_dwconv(torch.from_numpy(x), torch.from_numpy(w_pt), torch.from_numpy(b))
    assert torch.equal(got, f32.to(torch.bfloat16))


def _loftr_weights(rng, C):
    r = lambda *s: _bf16_values(rng, *s, scale=0.1)  # noqa: E731
    return dict(wq=r(C, C), wk=r(C, C), wv=r(C, C), wm=r(C, C),
                g1=_bf16_values(rng, C, scale=0.1) + np.float32(1), b1=r(C),
                w0=r(2 * C, 2 * C), w1=r(2 * C, C),
                g2=_bf16_values(rng, C, scale=0.1) + np.float32(1), b2=r(C))


@pytest.mark.parametrize("N,L,S,C,H", [(6, 18, 18, 32, 4), (2, 16, 8, 64, 8)])
def test_loftr_twin_bf16_matches_pallas(N, L, S, C, H):
    rng = np.random.default_rng(2)
    p = _loftr_weights(rng, C)
    x, src = _bf16_values(rng, N, L, C), _bf16_values(rng, N, S, C)
    ref = _strict(_fused_loftr_impl, jnp.asarray(x, jbf16), jnp.asarray(src, jbf16),
                  JxParams(**{k: jnp.asarray(v, jbf16) for k, v in p.items()}), nhead=H,
                  interpret=True)
    got = pt_loftr(_pt(x), _pt(src), PtParams(**{k: _pt(v) for k, v in p.items()}), H)
    _close(got, ref)


TINY = dict(n_bins=16, input_height=48, input_width=64, native_height=64, native_width=96,
            train_zone_num=2, eval_zone_num_cfg=2, train_patch_px=16, eval_patch_px=16,
            zone_sample_num=16, sample_uniform=True,
            attention_layer=["hist2image", "combine1", "image"], change_embedding=True,
            disable_clip_grad=True, hist_encoder_10x=True, bs=2, epochs=1)


def _median(a, b, ref):
    err = np.abs(a - b)
    return dict(median_rel=float(np.median(err / (np.abs(ref) + 1e-2))),
                median_abs=float(np.median(err)))


def test_tiny_model_bf16_tracks_jax_bf16():
    cfg = Config(**TINY)
    geoms = model_geometries(cfg, "online_eval")
    rng = np.random.default_rng(0)
    Z = cfg.eval_zone_num ** 2
    img = rng.standard_normal((2, cfg.native_height, cfg.native_width, 3)).astype(np.float32)
    hist = (np.abs(rng.standard_normal((2, Z, cfg.zone_sample_num))) * 2 + 0.5).astype(np.float32)
    mask = rng.random((2, Z)) > 0.25
    model = jx_make_model(cfg, tiny=True)
    shapes = jax.eval_shape(
        lambda r: model.init({"params": r, "fusion": r}, jnp.asarray(img), jnp.asarray(hist),
                             jnp.asarray(mask), geoms), jax.random.key(0))
    variables = random_tree(shapes, 1, kernel_std=0.05, dtype=np.float32)
    fwd = jax.jit(lambda v, i, h: model.apply(v, i, h, jnp.asarray(mask), geoms,
                                              train=False)[1])
    jx32 = np.asarray(fwd(variables, img, hist))[..., 0]
    cast = lambda a: a.astype(jbf16) if jnp.issubdtype(a.dtype, jnp.floating) else a  # noqa
    v16 = jax.tree_util.tree_map(cast, variables)
    jx16 = np.asarray(_strict(fwd, v16, jnp.asarray(img, jbf16), jnp.asarray(hist, jbf16)),
                      np.float32)[..., 0]

    port = pt_make_model(cfg, tiny=True, device="cpu")
    port.load_state_dict(weights.from_flax(variables["params"], variables["batch_stats"], cfg),
                         strict=True)
    with torch.no_grad():
        pt32 = port(torch.from_numpy(img), torch.from_numpy(hist), torch.from_numpy(mask),
                    geoms)[1].numpy()[..., 0]
        cast_to_compute_dtype(port, "bfloat16")
        floating = [t for t in list(port.parameters()) + list(port.buffers())
                    if t.is_floating_point()]
        assert floating and all(t.dtype == torch.bfloat16 for t in floating)
        stats = [b for n, b in port.named_buffers() if n.endswith("running_var")]
        assert stats and all(b.dtype == torch.bfloat16 for b in stats)
        out = port(_pt(img), _pt(hist), torch.from_numpy(mask), geoms)
    assert all(o.dtype == torch.float32 for o in out[:3])  # the depth tail promotes
    pt16 = out[1].numpy()[..., 0]
    assert np.isfinite(pt16).all()
    rel = lambda a, b: float(np.median(np.abs(a - b) / (np.abs(jx32) + 1e-2)))  # noqa: E731
    assert rel(pt16, jx16) < rel(jx16, jx32), (rel(pt16, jx16), rel(jx16, jx32))
    for a, b, ref in ((pt16, pt32, pt32), (jx16, jx32, jx32)):
        drift = _median(a, b, ref)
        assert all(drift[k] < v for k, v in DRIFT.items()), drift


def _kernel_checks():
    """(name, check, args for (dtype_a, dtype_b)) of each wrapper's check."""
    def att(a, b):
        return (torch.zeros(1, 8, 4, 8, dtype=a),) + (torch.zeros(1, 8, 4, 8, dtype=b),) * 2

    def dw(a, b):
        return torch.zeros(1, 9, 10, 4, dtype=a), torch.zeros(4, 1, 7, 7, dtype=b), None

    def loftr(a, b):
        C = 32
        p = PtParams(*(torch.zeros(s, dtype=b).t() if len(s) == 2 else torch.zeros(s, dtype=b)
                       for s in ((C, C),) * 4 + ((C,),) * 2 + ((2 * C, 2 * C), (C, 2 * C))
                       + ((C,),) * 2))
        return torch.zeros(2, 8, C, dtype=a), torch.zeros(2, 5, C, dtype=a), p, 4

    return [("linear_attention", attention_kernel._check, att),
            ("dwconv", dwconv_kernel._check, dw), ("fused_loftr", loftr_kernel._check, loftr)]


@pytest.mark.parametrize("name,check,args", _kernel_checks())
def test_kernel_dtype_checks(name, check, args):
    """float32 and bfloat16 pass the dtype check (these CPU tensors then
    fail the device check, a ValueError); other and mixed dtypes raise
    TypeError before it."""
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="cuda|CUDA|on "):
            check(*args(dtype, dtype))
    for a, b in ((torch.float64, torch.float64), (torch.float16, torch.float16),
                 (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
        with pytest.raises(TypeError, match=name):
            check(*args(a, b))


def test_captured_forward_refuses_the_other_dtype():
    """A graph captured in bf16 holds bf16 image and histogram buffers and
    refuses float32 inputs (and the reverse), before touching the graph."""
    for graph_dtype, other in ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
        captured = object.__new__(CapturedForward)
        captured.image = torch.zeros(1, 64, 96, 3, dtype=graph_dtype)
        captured.hist = torch.zeros(1, 4, 16, dtype=graph_dtype)
        captured.mask = torch.ones(1, 4, dtype=torch.bool)
        with pytest.raises(ValueError, match="captured for"):
            captured(torch.zeros(1, 64, 96, 3, dtype=other), torch.zeros(1, 4, 16, dtype=other),
                     torch.ones(1, 4, dtype=torch.bool))


def test_dispatch_keeps_the_dtype():
    """bf16 in, bf16 out on the CPU route: nothing is cast to hide a dtype."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 4, 8, generator=g).bfloat16()
    assert dispatch.attention(q, q, q).dtype == torch.bfloat16
    x = torch.randn(1, 9, 10, 4, generator=g).bfloat16()
    assert dispatch.dwconv2d(x, torch.randn(4, 1, 7, 7, generator=g).bfloat16()).dtype == x.dtype
    from cfpnet_torch.models.transformer import LoFTREncoderLayer

    layer = LoFTREncoderLayer(32, 4).to(torch.bfloat16)
    x = torch.randn(2, 8, 32, generator=g).bfloat16()
    assert dispatch.loftr_layer(x, x, layer).dtype == torch.bfloat16


def test_compute_dtype_names():
    assert compute_dtype("bfloat16") is torch.bfloat16 and compute_dtype("float32") is torch.float32
    assert compute_dtype(torch.bfloat16) is torch.bfloat16
    with pytest.raises(ValueError):
        compute_dtype("int8")


def test_evaluate_time_casts_inputs_and_model():
    """``timed_forward``'s cast, as the root one: image and histograms in the
    compute dtype, the mask bool, every floating parameter and statistic of
    the model in it; the CLI names the dtype that ran."""
    from cfpnet_torch.bench import smoke_config

    cfg = smoke_config()
    (image, hist, mask), _ = pt_evaluate_time.eval_batch(cfg, 2, "cpu", torch.bfloat16)
    assert image.dtype == hist.dtype == torch.bfloat16 and mask.dtype == torch.bool
    model = pt_evaluate_time.load_model(cfg, "cpu", dtype=torch.bfloat16)
    assert {t.dtype for t in model.state_dict().values()} == {torch.bfloat16}
