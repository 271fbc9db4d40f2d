"""The port's weight bridge against the JAX package's importer, and the rule
that the port imports nothing of JAX."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cfpnet_torch import weights
from cfpnet_torch.models.deltar import make_model as pt_make_model
from cfpnet_tpu.config import Config
from cfpnet_tpu.models.deltar import make_model as jx_make_model
from cfpnet_tpu.models.deltar import model_geometries
from tests.torch_port_util import random_tree
from tools.import_torch_weights import export_reference_style, import_reference_checkpoint

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "cfpnet_tpu", "tools"}


def production_config():
    return Config(n_bins=256, attention_layer=["hist2image", "combine1", "image",
                                               "hist2image", "combine1", "image"],
                  change_embedding=True, sample_uniform=True)


def _flax_shapes(cfg, tiny):
    model = jx_make_model(cfg, tiny=tiny)
    h, w = cfg.native_height, cfg.native_width
    Z = cfg.eval_zone_num ** 2
    return jax.eval_shape(
        lambda r: model.init({"params": r, "fusion": r}, jnp.zeros((1, h, w, 3)),
                             jnp.zeros((1, Z, cfg.zone_sample_num)), jnp.ones((1, Z), bool),
                             model_geometries(cfg, "online_eval")),
        jax.random.key(0))


def _leaves(shapes):
    out = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        out.add((tuple(p.key for p in path), tuple(leaf.shape)))
    return out


def _spec_leaves(spec):
    return {((col,) + fpath, shape) for col, fpath, shape in spec}


def test_from_flax_equals_export_reference_style(tiny_config):
    shapes = _flax_shapes(tiny_config, tiny=True)
    tree = random_tree(shapes, 7, dtype=np.float32)
    ours = weights.from_flax(tree["params"], tree["batch_stats"], tiny_config)
    ref = export_reference_style(tree["params"], tree["batch_stats"], tiny_config)
    assert list(ours) and set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)
    # the port creates exactly these parameters: no dead reference params
    port = pt_make_model(tiny_config, tiny=True, device="cpu")
    assert set(port.state_dict()) == set(ref)


def test_flax_param_spec_matches_flax_init_production():
    cfg = production_config()
    spec = weights.flax_param_spec(cfg)
    assert len(spec) == len(_spec_leaves(spec))
    assert _spec_leaves(spec) == _leaves(_flax_shapes(cfg, tiny=False))


def test_flax_param_spec_matches_flax_init_tiny(tiny_config):
    spec = weights.flax_param_spec(tiny_config, tiny=True)
    assert _spec_leaves(spec) == _leaves(_flax_shapes(tiny_config, tiny=True))


def test_reference_checkpoint_loads_strict():
    """A reference-style checkpoint of the production model, with DataParallel
    prefixes, BN counters and the reference's dead parameters, loads strictly
    into the port, to the same tensors the JAX importer reads from it."""
    cfg = production_config()
    shapes = _flax_shapes(cfg, tiny=False)
    tree = random_tree(shapes, 8, dtype=np.float32)
    sd = export_reference_style(tree["params"], tree["batch_stats"], cfg)
    ckpt = {f"module.{k}": torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    ckpt["module.decoder.up1._net.1.num_batches_tracked"] = torch.tensor(3)
    ckpt["module.decoder.cross_atten1.layers.1.large_kernel_path.conv1.weight"] = torch.zeros(2)
    ckpt["module.decoder.cross_atten1.layers.1.transformer_path.merge.weight"] = torch.zeros(2)
    ckpt["module.decoder.cross_atten1.layers.1.transformer_path.mlp.0.weight"] = torch.zeros(2)
    loaded = weights.load_reference_checkpoint({"model": ckpt})
    port = pt_make_model(cfg, device="cpu")
    port.load_state_dict(loaded, strict=True)
    params, stats, missing, unused = import_reference_checkpoint(
        {k: v.numpy() for k, v in ckpt.items()}, cfg)
    assert not missing and not unused
    again = weights.from_flax(params, stats, cfg)
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), again[k].numpy(), err_msg=k)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = sorted((ROOT / "cfpnet_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    # the command-line tools' ports are read as every other module
    assert {ROOT / "cfpnet_torch" / f"{m}.py"
            for m in ("import_weights", "extract_nyu_mat", "demo")} <= set(files)
    bad = {(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f) if m in FORBIDDEN}
    assert not bad, f"the port imports the JAX stack: {sorted(bad)}"
