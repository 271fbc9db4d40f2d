"""Port modules against their flax counterparts in float64 on the CPU, with
the same numpy weights (mapped by the port's bridge tables) and inputs:
LoFTR layer, LSA, GSA, LoFTRNewCross9, Block14, the EffNetV2 tiny backbone,
TransformerFusion on the tiny config, and the decoder's UpSampleBN and
depth head."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfpnet_torch import weights
from cfpnet_torch.models import convnext as pt_convnext
from cfpnet_torch.models import decoder as pt_decoder
from cfpnet_torch.models import encoder as pt_encoder
from cfpnet_torch.models import fusion as pt_fusion
from cfpnet_torch.models import transformer as pt_tr
from cfpnet_torch.models.efficientnetv2 import V2_TINY_STAGES as PT_TINY_STAGES
from cfpnet_tpu.models import convnext as jx_convnext
from cfpnet_tpu.models import decoder as jx_decoder
from cfpnet_tpu.models import efficientnetv2 as jx_effnet
from cfpnet_tpu.models import fusion as jx_fusion
from cfpnet_tpu.models import transformer as jx_tr
from cfpnet_tpu.models.deltar import model_geometries
from tests.torch_port_util import close, enable_x64, load, random_tree, t, table_entries


def _flax(module, seed, *args, **kw):
    """(params, batch_stats) f64 numpy trees of ``module`` for ``args``."""
    shapes = jax.eval_shape(lambda r: module.init(r, *args, **kw), jax.random.key(0))
    tree = random_tree(shapes, seed)
    return tree["params"], tree.get("batch_stats", {})


def _apply(module, params, stats, *args, **kw):
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    return np.asarray(module.apply(variables, *args, **kw))


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("d_model,nhead,masked", [(32, 4, False), (64, 8, False), (32, 4, True)])
def test_loftr_layer(d_model, nhead, masked):
    x, src = _randn(1, 3, 11, d_model), _randn(2, 3, 7, d_model)
    x_mask = src_mask = None
    if masked:
        x_mask = np.random.default_rng(3).random((3, 11)) > 0.3
        src_mask = np.random.default_rng(4).random((3, 7)) > 0.3
        src_mask[:, 0] = True
    fx = jx_tr.LoFTREncoderLayer(d_model, nhead)
    with enable_x64():
        args = [jnp.asarray(x), jnp.asarray(src)]
        kw = {} if not masked else dict(x_mask=jnp.asarray(x_mask), source_mask=jnp.asarray(src_mask))
        params, _ = _flax(fx, 10, *args, **kw)
        ref = _apply(fx, params, None, *args, **kw)
    port = load(pt_tr.LoFTREncoderLayer(d_model, nhead), weights._loftr_entries(), params)
    kw = {} if not masked else dict(x_mask=t(x_mask), source_mask=t(src_mask))
    with torch.no_grad():
        close(port(t(x), t(src), **kw).numpy(), ref)


def _encoder_layer_entries():
    return [(f"encoder_layer.{k}", ("encoder_layer",) + fp, kind, col)
            for k, fp, kind, col in weights._loftr_entries()]


@pytest.mark.parametrize("H,W,ws", [(12, 13, 5), (10, 10, 5)])
def test_locally_grouped_attn(H, W, ws):
    x = _randn(5, 2, H * W, 32)
    fx = jx_tr.LocallyGroupedAttn(32, ws)
    with enable_x64():
        params, _ = _flax(fx, 11, jnp.asarray(x), (H, W))
        ref = _apply(fx, params, None, jnp.asarray(x), (H, W))
    port = load(pt_tr.LocallyGroupedAttn(32, ws), _encoder_layer_entries(), params)
    with torch.no_grad():
        close(port(t(x), (H, W)).numpy(), ref)


def test_global_subsample_attn():
    H, W, ws = 12, 13, 3
    x = _randn(6, 2, H * W, 32)
    fx = jx_tr.GlobalSubSampleAttn(32, ws)
    with enable_x64():
        params, _ = _flax(fx, 12, jnp.asarray(x), (H, W))
        ref = _apply(fx, params, None, jnp.asarray(x), (H, W))
    entries = _encoder_layer_entries() + [
        ("sr.weight", ("sr", "kernel"), "conv", "params"),
        ("sr.bias", ("sr", "bias"), "raw", "params"),
        ("norm.weight", ("norm", "scale"), "raw", "params"),
        ("norm.bias", ("norm", "bias"), "raw", "params")]
    port = load(pt_tr.GlobalSubSampleAttn(32, ws), entries, params)
    with torch.no_grad():
        close(port(t(x), (H, W)).numpy(), ref)


def test_newcross9():
    H, W, rect = 10, 12, (2, 7, 3, 9)
    x = _randn(7, 2, H * W, 32)
    fx = jx_tr.LoFTRNewCross9(32, 4)
    with enable_x64():
        params, stats = _flax(fx, 13, jnp.asarray(x), rect, H, W)
        ref = _apply(fx, params, stats, jnp.asarray(x), rect, H, W)
    port = load(pt_tr.LoFTRNewCross9(32, 4), weights._newcross_entries(), params, stats)
    with torch.no_grad():
        close(port(t(x), rect, H, W).numpy(), ref)


@pytest.mark.parametrize("k", [7, 15])
def test_block14(k):
    x = _randn(8, 2, 12, 14, 16)
    fx = jx_convnext.Block14(16, k)
    with enable_x64():
        params, stats = _flax(fx, 14, jnp.asarray(x))
        ref = _apply(fx, params, stats, jnp.asarray(x))
    port = load(pt_convnext.Block14(16, k), weights._block14_entries(), params, stats)
    with torch.no_grad():
        close(port(t(x)).numpy(), ref, atol=1e-11)


def test_effnetv2_tiny_backbone():
    x = _randn(9, 2, 40, 56, 3)
    fx = jx_effnet.EfficientNetV2Features(jx_effnet.V2_TINY_STEM, jx_effnet.V2_TINY_STAGES)
    with enable_x64():
        params, stats = _flax(fx, 15, jnp.asarray(x))
        ref = fx.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
        ref = [np.asarray(r) for r in ref]
    table = weights.name_map(_tiny_cfg(), PT_TINY_STAGES)
    entries = table_entries(table, "img_encoder.", ("img_encoder", "backbone"))
    port = load(pt_encoder.ImageEncoder(jx_effnet.V2_TINY_STEM, PT_TINY_STAGES), entries,
                params, stats)
    with torch.no_grad():
        got = port(t(x).permute(0, 3, 1, 2))
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        close(g.permute(0, 2, 3, 1).numpy(), r, atol=1e-11)


def _tiny_cfg():
    from cfpnet_torch.config import Config

    return Config(n_bins=16, native_height=64, native_width=96, eval_zone_num_cfg=2,
                  eval_patch_px=16, zone_sample_num=16,
                  attention_layer=["hist2image", "combine1", "image"], change_embedding=True)


@pytest.mark.parametrize("scale,dim,k", [(4, 8, 31), (8, 16, 15)])
def test_transformer_fusion_tiny(tiny_config, scale, dim, k):
    cfg = tiny_config
    geom = model_geometries(cfg, "online_eval")[scale]
    maxH, maxW = cfg.native_height // scale, cfg.native_width // scale
    Z = cfg.eval_zone_num ** 2
    x = _randn(20, 2, maxH, maxW, dim)
    feat1 = _randn(21, 2, Z, cfg.zone_sample_num, dim)
    hist_mask = np.array([[True, False, True, True], [True, True, True, False]])
    layers = tuple(cfg.attention_layer)
    fx = jx_fusion.TransformerFusion(dim, (maxH, maxW), layers, large_kernel=k,
                                     change_embedding=True)
    with enable_x64():
        args = (jnp.asarray(x), jnp.asarray(feat1), jnp.asarray(hist_mask), geom)
        params, stats = _flax(fx, 16, *args)
        ref = _apply(fx, params, stats, *args)
    entries = [(tk, fp, kind, col) for tk, (fp, kind, col)
               in weights._fusion_entries(layers, maxH, maxW).items()]
    port = load(pt_fusion.TransformerFusion(dim, (maxH, maxW), layers, large_kernel=k,
                                            change_embedding=True), entries, params, stats)
    with torch.no_grad():
        close(port(t(x), t(feat1), t(hist_mask), geom).numpy(), ref, atol=1e-11)


def test_upsample_bn():
    x, skip = _randn(30, 2, 5, 7, 12), _randn(31, 2, 10, 13, 6)
    fx = jx_decoder.UpSampleBN(8)
    with enable_x64():
        args = (jnp.asarray(x), jnp.asarray(skip), False)
        params, stats = _flax(fx, 17, *args)
        ref = _apply(fx, params, stats, *args)
    table = weights.name_map(_tiny_cfg())
    entries = table_entries(table, "decoder.up1.", ("decoder", "up1"))
    port = load(pt_decoder.UpSampleBN(18, 8), entries, params, stats)
    with torch.no_grad():
        got = port(t(x).permute(0, 3, 1, 2), t(skip).permute(0, 3, 1, 2))
    close(got.permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize("norm", ["linear", "softmax", "sigmoid"])
def test_depth_head(norm):
    x = _randn(32, 2, 6, 9, 16)
    fx = jx_decoder.DepthRegression(dim_out=24, embedding_dim=16, norm=norm)
    with enable_x64():
        params, _ = _flax(fx, 18, jnp.asarray(x))
        out = fx.apply({"params": params}, jnp.asarray(x))
        ref_bins, ref_maps = np.asarray(out[0]), np.asarray(out[1])
    table = weights.name_map(_tiny_cfg())
    entries = table_entries(table, "depth_head.", ("depth_head",))
    port = load(pt_decoder.DepthRegression(16, 24, 16, norm), entries, params)
    with torch.no_grad():
        bins, maps = port(t(x).permute(0, 3, 1, 2))
    close(bins.numpy(), ref_bins)
    close(maps.permute(0, 2, 3, 1).numpy(), ref_maps)
