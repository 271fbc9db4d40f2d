"""The fusion layer names, the DELTAR baseline configuration and masked
calls of the port against the JAX package on the CPU.

- ``TransformerFusion`` with the names the reference cannot construct
  (``new_cross``, ``combine_N``, ``cvxt[_N]``) against flax in float64 on
  the same weights (flax's tree through ``weights._fusion_entries``), in
  eval and in train mode (output, gradients, running statistics); an
  unknown name raises as in JAX.
- ``deterministic_state_dict`` of the baseline and of the names
  configuration equal to ``from_flax`` of the JAX golden tests' tree.
- The tiny model of each configuration against flax in float64, on a
  spatial grid against one device, and its kernel wrappers' calls a forward
  (``chip_smoke.CONFIG_LAUNCHES``).
- The baseline through ``evaluate``, ``evaluate_time`` and the training
  driver at the tiny size.
- Masked attention and a masked LoFTR layer take the plain route whatever
  the device (``chip_smoke.masked_calls`` on the CPU).
- Slow: each configuration's 480x640 forward against its golden.

The goldens: ``python tests/test_torch_port_configs.py`` rewrites
``tests/golden/torch_port_baseline_forward.npz`` and
``torch_port_fusion_names_forward.npz`` (``write_golden``: the JAX package's
f32 forward on the CPU, the weights and inputs of
``tests/test_golden.py::test_golden_forward_production_size``; about a
minute and 3 GB each).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

if __name__ == "__main__":  # the golden writer, run as a script from the repo root
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    jax.config.update("jax_platforms", "cpu")

import chip_smoke
from cfpnet_torch import evaluate as pt_evaluate
from cfpnet_torch import evaluate_time as pt_evaluate_time
from cfpnet_torch import weights
from cfpnet_torch.config import Config as PtConfig
from cfpnet_torch.config import parse_config as pt_parse_config
from cfpnet_torch.kernels import dwconv as dwconv_kernel
from cfpnet_torch.kernels import fused_loftr as loftr_kernel
from cfpnet_torch.kernels import linear_attention as attention_kernel
from cfpnet_torch.models import fusion as pt_fusion
from cfpnet_torch.models.deltar import make_model as pt_make_model
from cfpnet_torch.parallel import spatial
from cfpnet_torch.train import __main__ as pt_train_main
from cfpnet_tpu.config import Config as JxConfig
from cfpnet_tpu.config import parse_config as jx_parse_config
from cfpnet_tpu.models import fusion as jx_fusion
from cfpnet_tpu.models.deltar import make_model as jx_make_model
from cfpnet_tpu.models.deltar import model_geometries
from tests.test_golden import _det_leaf
from tests.torch_port_util import close, enable_x64, load, random_tree, t

CONFIGS = ("baseline", "fusion_names")
LAYERS = {"baseline": ["hist2image", "image", "hist2image", "image"],
          "fusion_names": list(chip_smoke.FUSION_NAMES)}
TINY = dict(n_bins=16, input_height=48, input_width=64, native_height=64, native_width=96,
            train_zone_num=2, eval_zone_num_cfg=2, train_patch_px=16, eval_patch_px=16,
            zone_sample_num=16, sample_uniform=True, change_embedding=True,
            disable_clip_grad=True, hist_encoder_10x=True, bs=2, epochs=1)
TINY_FLAGS = ["--tiny_model", "--n_bins", "16", "--native_height", "64", "--native_width", "96",
              "--input_height", "48", "--input_width", "64", "--train_zone_num", "2",
              "--eval_zone_num_cfg", "2", "--train_patch_px", "16", "--eval_patch_px", "16",
              "--device", "cpu"]


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _argv(name):
    return chip_smoke.config_argv(name)


# ---- TransformerFusion --------------------------------------------------------------

def _fusion_case(names, scale=4, dim=8, k=31):
    """(flax fusion, port fusion class args, inputs, geometry) at one scale
    of the tiny configuration."""
    cfg = JxConfig(**TINY, attention_layer=list(names))
    geom = model_geometries(cfg, "online_eval")[scale]
    maxH, maxW = cfg.native_height // scale, cfg.native_width // scale
    Z = cfg.eval_zone_num ** 2
    x = _randn(20, 2, maxH, maxW, dim)
    feat1 = _randn(21, 2, Z, cfg.zone_sample_num, dim)
    hist_mask = np.array([[True, False, True, True], [True, True, True, False]])
    fx = jx_fusion.TransformerFusion(dim, (maxH, maxW), tuple(names), large_kernel=k,
                                     change_embedding=True)
    entries = [(tk, fp, kind, col) for tk, (fp, kind, col)
               in weights._fusion_entries(names, maxH, maxW).items()]
    port = pt_fusion.TransformerFusion(dim, (maxH, maxW), names, large_kernel=k,
                                       change_embedding=True)
    return fx, port, entries, (x, feat1, hist_mask), geom


def _flax_tree(fx, args, geom, seed=16, **kw):
    shapes = jax.eval_shape(lambda r: fx.init(r, *map(jnp.asarray, args), geom, **kw),
                            jax.random.key(0))
    tree = random_tree(shapes, seed)
    return tree["params"], tree.get("batch_stats", {})


@pytest.mark.parametrize("names", [["new_cross"], ["combine_2"], ["cvxt"], ["cvxt_3"],
                                   ["combine1_1"], LAYERS["fusion_names"]],
                         ids=lambda n: "+".join(n))
def test_fusion_layer_names_match_flax_f64(names):
    fx, port, entries, args, geom = _fusion_case(names)
    with enable_x64():
        params, stats = _flax_tree(fx, args, geom)
        ref = np.asarray(fx.apply({"params": params, "batch_stats": stats},
                                  *map(jnp.asarray, args), geom))
    assert set(port.state_dict()) == {e[0] for e in entries}
    port = load(port, entries, params, stats)
    with torch.no_grad():
        close(port(*map(t, args), geom).numpy(), ref, atol=1e-11)


def test_sublayer_keys_follow_the_flax_names():
    """One torch index a flax index: layers_{i} -> layers.{i}, layers_{i}_{j}
    -> layers.{i}.{j}; a name holding new_cross is one bare layer."""
    names = ["new_cross_2", "combine_2", "combine1_1", "combine1", "cvxt", "cvxt_1", "cvxt_3"]
    table = weights._fusion_entries(names, 4, 6)
    subs = {}
    for key, (fpath, _, _) in table.items():
        parts = key.split(".")
        if parts[0] == "layers":
            indexed = parts[2].isdigit()
            subs[".".join(parts[:3] if indexed else parts[:2])] = fpath[0]
    assert subs == {"layers.0": "layers_0", "layers.1.0": "layers_1_0",
                    "layers.1.1": "layers_1_1", "layers.2.0": "layers_2_0",
                    "layers.3": "layers_3", "layers.4": "layers_4", "layers.5": "layers_5",
                    "layers.6.0": "layers_6_0", "layers.6.1": "layers_6_1",
                    "layers.6.2": "layers_6_2"}


def test_unknown_layer_name_raises_as_jax():
    fx, _, _, args, geom = _fusion_case(["hist2image"])
    fx = fx.clone(layer_names=("hist2image", "cross_zone"))
    with pytest.raises(NotImplementedError) as jx_err:
        jax.eval_shape(lambda r: fx.init(r, *map(jnp.asarray, args), geom), jax.random.key(0))
    with pytest.raises(NotImplementedError) as pt_err:
        pt_fusion.TransformerFusion(8, (16, 24), ["hist2image", "cross_zone"])
    assert str(pt_err.value) == str(jx_err.value) == "attention layer 'cross_zone'"


def test_train_mode_fusion_matches_jax_f64():
    """One train-mode forward of the names configuration's fusion at its
    full map (no crop to draw): the output, the gradients of the input and
    of every parameter (``jax.grad``), and the moved running statistics."""
    fx, port, entries, args, geom = _fusion_case(LAYERS["fusion_names"], scale=8, dim=16, k=15)
    cot = _randn(22, *args[0].shape)
    with enable_x64():
        params, stats = _flax_tree(fx, args, geom)

        def loss(p, x):
            out, new = fx.apply({"params": p, "batch_stats": stats}, x, *map(jnp.asarray, args[1:]),
                                geom, train=True, mutable=["batch_stats"])
            return jnp.sum(out * cot), (out, new["batch_stats"])

        (grads, gx), (ref, new_stats) = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))(
            params, jnp.asarray(args[0]))
    port = load(port, entries, params, stats).train()
    x = t(args[0]).requires_grad_()
    out = port(x, t(args[1]), t(args[2]), geom)
    (out * t(cot)).sum().backward()
    close(out.detach().numpy(), np.asarray(ref), atol=1e-11)
    close(x.grad.numpy(), np.asarray(gx), atol=1e-11)
    grad_sd = weights._from_table({k: (fp, kind, col) for k, fp, kind, col in entries},
                                  {"params": jax.tree_util.tree_map(np.array, grads),
                                   "batch_stats": jax.tree_util.tree_map(np.array, new_stats)})
    named = dict(port.named_parameters())
    buffers = dict(port.named_buffers())
    assert set(named) | set(buffers) == set(grad_sd)
    for k, want in grad_sd.items():
        got = named[k].grad if k in named else buffers[k]
        close(got.numpy(), want.numpy(), atol=1e-11)


# ---- the configurations -------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_deterministic_weights_equal_the_golden_tree(name):
    """``chip_smoke.py`` rebuilds the goldens' weights from
    ``flax_param_spec`` without JAX: key for key and value for value the
    JAX golden tests' ``_det_leaf`` tree of the same configuration."""
    jcfg = jx_parse_config(_argv(name))
    model = jx_make_model(jcfg)
    img, hist, mask = jnp.zeros((1, 480, 640, 3)), jnp.zeros((1, 64, 16)), jnp.ones((1, 64), bool)
    shapes = jax.eval_shape(
        lambda r: model.init({"params": r, "fusion": r}, img, hist, mask,
                             model_geometries(jcfg, "online_eval")), jax.random.key(0))
    tree = jax.tree_util.tree_map_with_path(_det_leaf, shapes)
    want = weights.from_flax(tree["params"], tree["batch_stats"], jcfg)
    got = weights.deterministic_state_dict(pt_parse_config(_argv(name)))
    assert list(got) == list(want)
    n_leaves = len(jax.tree_util.tree_leaves(shapes))
    assert len(got) == n_leaves
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


@pytest.fixture(scope="module", params=CONFIGS)
def tiny_model(request):
    """The tiny model of a configuration's layer names in float64 on random
    weights: flax's eval forward and the port's model on the same weights."""
    name = request.param
    cfg = JxConfig(**TINY, attention_layer=LAYERS[name])
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
        ref = jax.jit(lambda v: model.apply(v, img, hist, mask, geoms, train=False))(variables)
        ref = [np.asarray(a) for a in ref[:3]]
    pcfg = PtConfig(**TINY, attention_layer=LAYERS[name])
    port = pt_make_model(pcfg, tiny=True, device="cpu").double()
    port.load_state_dict(weights.from_flax(variables["params"], variables["batch_stats"], cfg),
                         strict=True)
    return dict(name=name, cfg=pcfg, geoms=geoms, port=port, inputs=(img, hist, mask), ref=ref)


def test_tiny_model_matches_flax_f64(tiny_model):
    img, hist, mask = tiny_model["inputs"]
    with torch.no_grad():
        out = tiny_model["port"](t(img), t(hist), t(mask), tiny_model["geoms"])
    for got, ref in zip(out[:3], tiny_model["ref"]):
        assert tuple(got.shape) == ref.shape
        close(got.numpy(), ref)


def test_tiny_model_on_a_spatial_grid_equals_one_device(tiny_model):
    """``--spatial_shards 2`` on ``["cpu"] * 2``: each image's rows over two
    shards, the fusions once on the gathered map."""
    img, hist, mask = map(t, tiny_model["inputs"])
    grid = spatial.make_mesh_2d(1, 2, ["cpu"] * 2)
    placed = spatial.shard_batch_spatial(dict(image=img, hist_data=hist, mask=mask), grid)
    with torch.no_grad():
        edges, pred, prob, _ = tiny_model["port"](placed["image"], placed["hist_data"],
                                                  placed["mask"], tiny_model["geoms"], grid=grid)
        one = tiny_model["port"](img, hist, mask, tiny_model["geoms"])
    got = (edges, spatial.gather(pred, "cpu", 1), spatial.gather(prob, "cpu", 1))
    for a, b in zip(got, one[:3]):
        close(a.numpy(), b.numpy())


def test_kernel_wrappers_called_as_the_card_launches(tiny_model, monkeypatch):
    """The calls into the three kernel wrappers of one forward are the
    launches ``chip_smoke.py`` phase 19 expects on the card (the same on
    the CPU, where each wrapper runs its plain version)."""
    calls = {}
    for mod, fn, key in ((attention_kernel, "linear_attention", "linear_attention"),
                         (dwconv_kernel, "depthwise_conv2d", "dwconv"),
                         (loftr_kernel, "fused_loftr", "fused_loftr")):
        calls[key] = 0

        def counted(*a, _f=getattr(mod, fn), _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)

        monkeypatch.setattr(mod, fn, counted)
    img, hist, mask = map(t, tiny_model["inputs"])
    with torch.no_grad():
        tiny_model["port"](img[:1], hist[:1], mask[:1], tiny_model["geoms"])
    assert calls == chip_smoke.CONFIG_LAUNCHES[tiny_model["name"]]


def test_baseline_runs_through_the_entry_points(tmp_path, monkeypatch):
    """``evaluate``, ``evaluate_time`` (eager, f32 and bf16) and the
    training driver on ``configs/train_deltar_baseline.txt`` at the tiny
    size on synthetic data."""
    monkeypatch.chdir(tmp_path)
    argv = [f"@{chip_smoke.BASELINE_CONFIG}"] + TINY_FLAGS
    out = pt_evaluate.main(argv + ["--test_dataset", "synthetic", "--synthetic_length", "2"])
    assert out["images"] == 2 and all(np.isfinite(v) for v in out["metrics"].values())
    for dtype in ("float32", "bfloat16"):
        timed = pt_evaluate_time.main(argv + ["--eager", "--test_dataset", "synthetic",
                                              "--niters", "2", "--compute_dtype", dtype])
        assert timed["dtype"] == dtype and timed["latency_ms_bs1"] > 0
    monkeypatch.setattr(sys, "argv", ["train"] + argv + [
        "--dataset", "synthetic", "--dataset_eval", "synthetic", "--synthetic_length", "4",
        "--bs", "2", "--epochs", "1", "--workers", "0", "--logging"])
    pt_train_main.main()
    log = tmp_path / "results" / "train_deltar_baseline" / "train_log.jsonl"
    assert log.is_file() and "rmse" in log.read_text()


# ---- masked calls -------------------------------------------------------------------

def test_masked_calls_take_the_plain_route():
    """``chip_smoke.masked_calls`` on the CPU: f32 and bf16 against float64
    within ``MASKED_TOL``, no launch."""
    out = chip_smoke.masked_calls("cpu")
    for dtype in ("float32", "bfloat16"):
        assert all(v <= out[dtype]["limit"] for v in out[dtype]["max_rel_err"].values())
        assert not any(out[dtype]["launches_masked"].values())


# ---- the goldens --------------------------------------------------------------------

def golden_inputs():
    return (_det_leaf(("img",), jax.ShapeDtypeStruct((1, 480, 640, 3), jnp.float32)),
            np.abs(_det_leaf(("hist",), jax.ShapeDtypeStruct((1, 64, 16), jnp.float32))) * 20,
            np.ones((1, 64), bool))


def write_golden(name: str) -> dict:
    """The JAX package's f32 bs=1 forward of configuration ``name`` on the
    golden tests' deterministic weights and inputs, as
    ``tests/test_golden.py::test_golden_forward_production_size`` pins it:
    every 16th pixel of pred, every 16th bin edge, pred's mean."""
    cfg = jx_parse_config(_argv(name))
    model = jx_make_model(cfg)
    geoms = model_geometries(cfg, "online_eval")
    img, hist, mask = map(jnp.asarray, golden_inputs())
    shapes = jax.eval_shape(
        lambda r: model.init({"params": r, "fusion": r}, img, hist, mask, geoms),
        jax.random.key(0))
    variables = jax.tree_util.tree_map_with_path(_det_leaf, shapes)
    bin_edges, pred, _, _ = jax.jit(
        lambda v: model.apply(v, img, hist, mask, geoms, train=False))(variables)
    got = dict(pred_slice=np.asarray(pred)[0, ::16, ::16, 0],
               bin_edges16=np.asarray(bin_edges)[0, ::16],
               pred_mean=np.asarray(pred.mean())[None])
    assert np.isfinite(got["pred_slice"]).all()
    np.savez(chip_smoke.CONFIG_GOLDENS[name][0], **got)
    return got


@pytest.mark.slow
@pytest.mark.parametrize("name", CONFIGS)
def test_config_forward_matches_golden(name):
    """The port's 480x640 forward on the CPU (plain ops) against the
    configuration's golden, as ``chip_smoke.py`` phase 19 holds the card."""
    out, _, _, _ = chip_smoke.config_forward(name, device="cpu")
    assert not any(out["launches"].values())


if __name__ == "__main__":
    for which in sys.argv[1:] or CONFIGS:
        print(which, {k: v.ravel()[:4] for k, v in write_golden(which).items()})
