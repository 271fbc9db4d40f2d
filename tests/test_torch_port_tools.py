"""The port's tools against the JAX package's, on the CPU: the timm and
reference weight imports (``cfpnet_torch.weights``,
``python -m cfpnet_torch.import_weights``) against
``tools/import_torch_weights.py``, the NYU ``.mat`` extraction
(``cfpnet_torch.extract_nyu_mat``) against ``tools/extract_nyu_mat.py``, and
the single-frame demo (``cfpnet_torch.demo``) against ``scripts/demo.py``'s
computation."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfpnet_torch import demo, weights
from cfpnet_torch import extract_nyu_mat as pt_extract
from cfpnet_torch import import_weights
from cfpnet_torch.config import Config as PtConfig
from cfpnet_torch.config import parse_config as pt_parse_config
from cfpnet_torch.models.deltar import make_model as pt_make_model
from cfpnet_torch.utils.vis import colorize
from cfpnet_tpu.config import Config as JxConfig
from cfpnet_tpu.config import parse_config as jx_parse_config
from cfpnet_tpu.data.datasets import SyntheticDataset as JxSynthetic
from cfpnet_tpu.data.datasets import sample_image_f32 as jx_sample_image_f32
from cfpnet_tpu.models import efficientnetv2 as jx_effnet
from cfpnet_tpu.models.deltar import make_model as jx_make_model
from cfpnet_tpu.models.deltar import model_geometries
from cfpnet_tpu.ops.interp import resize_bilinear_align_corners as jx_resize
from tests.test_extract_nyu_mat import _write_fake_mat
from tests.test_golden import _det_leaf
from tools import extract_nyu_mat as jx_extract
from tools.import_torch_weights import backbone_mapping, import_reference_checkpoint
from tools.import_torch_weights import import_timm_backbone
from tools.import_torch_weights import main as tool_main

PROD = ["--n_bins", "256", "--attention_layer", "hist2image", "combine1", "image", "hist2image",
        "combine1", "image", "--change_embedding", "--sample_uniform"]


# ---- the timm backbone --------------------------------------------------------------

def _torch_layout(fpath, shape):
    """A flax leaf's shape as the timm (= torch) tensor's."""
    if fpath[-1] == "kernel":  # conv HWIO and depthwise [k, k, 1, C] -> OIHW
        return (shape[3], shape[2], shape[0], shape[1])
    return tuple(shape)


@pytest.fixture(scope="module")
def timm_sd():
    """A timm ``tf_efficientnetv2_b3`` state_dict on the tool's own key map
    (shapes from the flax backbone), random values, with a classifier head,
    BatchNorm counters, one planted extra key and one key dropped."""
    shapes = jax.eval_shape(
        lambda r: jx_effnet.EfficientNetV2Features().init(r, jnp.zeros((1, 64, 64, 3))),
        jax.random.key(0))
    rng = np.random.default_rng(7)
    sd = {}
    for key, (fpath, _, col) in backbone_mapping().items():
        node = shapes[col]
        for p in fpath:
            node = node[p]
        sd[key] = rng.standard_normal(_torch_layout(fpath, node.shape)).astype(np.float32)
        if key.endswith("running_var"):
            sd[key.replace("running_var", "num_batches_tracked")] = np.array(3)
    sd["conv_head.weight"] = rng.standard_normal((1536, 232, 1, 1)).astype(np.float32)
    for n in ("weight", "bias", "running_mean", "running_var"):
        sd[f"bn2.{n}"] = rng.standard_normal(1536).astype(np.float32)
    sd["classifier.weight"] = rng.standard_normal((1000, 1536)).astype(np.float32)
    sd["classifier.bias"] = rng.standard_normal(1000).astype(np.float32)
    sd["blocks.1.0.extra.weight"] = np.ones(3, np.float32)  # planted: maps to nothing
    del sd["blocks.2.1.bn1.running_var"]
    return sd


def test_timm_import_equals_the_tool_and_from_flax(timm_sd):
    params, stats, missing, unused = import_timm_backbone(timm_sd)
    cfg = pt_parse_config(PROD)
    want = weights.from_flax({"img_encoder": params}, {"img_encoder": stats}, cfg)
    got, got_missing, got_unused = weights.timm_backbone_state_dict(
        {k: torch.from_numpy(np.asarray(v)) for k, v in timm_sd.items()})
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    assert got_missing == missing == ["blocks.2.1.bn1.running_var"]
    assert got_unused == unused == ["blocks.1.0.extra.weight"]
    # every backbone key of the port's model but the dropped one
    port_keys = {k for k in pt_make_model(cfg, device="meta").state_dict()
                 if k.startswith("img_encoder.")}
    assert port_keys - set(got) == {"img_encoder.conv2.1.bn1.running_var"}


def test_import_weights_cli_round_trips_timm(timm_sd, tmp_path, monkeypatch, capsys):
    """``python -m cfpnet_torch.import_weights --kind timm`` writes what
    ``timm_backbone_state_dict`` gives, and prints the tool's messages."""
    src = tmp_path / "timm.pt"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in timm_sd.items()}, src)
    dst = tmp_path / "backbone.pt"
    import_weights.main(["--src", str(src), "--dst", str(dst), "--kind", "timm"] + PROD)
    port_err = capsys.readouterr().err
    monkeypatch.setattr(sys, "argv", ["import_torch_weights.py", "--src", str(src), "--dst",
                                      str(tmp_path / "orbax"), "--kind", "timm"] + PROD)
    tool_main()
    tool_err = capsys.readouterr().err
    assert port_err == tool_err and "1 expected keys missing" in port_err
    want, _, _ = weights.timm_backbone_state_dict(torch.load(src, weights_only=True))
    got = weights.load_reference_checkpoint(str(dst))
    assert list(got) == list(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_reference_import_lists_equal_the_tool():
    """``weights.reference_state_dict``'s missing and unused keys against
    ``import_reference_checkpoint``'s on a production checkpoint with
    ``module.`` prefixes, dead parameters, counters, one extra key and one
    key dropped."""
    cfg = pt_parse_config(PROD)
    sd = {f"module.{k}": v for k, v in weights.deterministic_state_dict(cfg).items()}
    sd["module.decoder.cross_atten1.layers.1.large_kernel_path.conv1.weight"] = torch.ones(2)
    sd["module.decoder.cross_atten1.layers.1.transformer_path.merge.weight"] = torch.ones(2)
    sd["module.decoder.up1._net.1.num_batches_tracked"] = torch.tensor(4)
    sd["module.decoder.extra.weight"] = torch.ones(2)
    del sd["module.decoder.conv3.bias"]
    _, _, missing, unused = import_reference_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, jx_parse_config(PROD))
    out, got_missing, got_unused = weights.reference_state_dict(sd, cfg)
    assert got_missing == missing == ["decoder.conv3.bias"]
    assert got_unused == unused == ["decoder.extra.weight"]
    assert len(out) == len(sd) - 3


def test_import_weights_cli_round_trips_a_reference_checkpoint(tmp_path, capsys):
    """A tiny model's reference-style checkpoint through the command loads
    strictly into the tiny model."""
    tiny = ["--tiny_model", "--n_bins", "16", "--native_height", "64", "--native_width", "96",
            "--eval_zone_num_cfg", "2", "--eval_patch_px", "16", "--change_embedding",
            "--attention_layer", "hist2image", "combine1", "image"]
    cfg = pt_parse_config(tiny)
    sd = weights.deterministic_state_dict(cfg)
    src, dst = tmp_path / "ref.pt", tmp_path / "port.pt"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, src)
    import_weights.main(["--src", str(src), "--dst", str(dst)] + tiny)
    assert capsys.readouterr().err == ""
    model = pt_make_model(cfg, device="cpu")
    model.load_state_dict(weights.load_reference_checkpoint(str(dst)), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


# ---- the NYU .mat extraction --------------------------------------------------------

def _splits(tmp_path, train, test):
    import scipy.io

    path = tmp_path / "splits.mat"
    scipy.io.savemat(path, {"trainNdxs": np.array(train, np.float64).reshape(-1, 1),
                            "testNdxs": np.array(test, np.float64).reshape(-1, 1)})
    return path


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_extract_nyu_mat_writes_the_tools_tree(tmp_path, monkeypatch):
    from PIL import Image

    scenes = ["kitchen_0001", "kitchen_0001", "office_0002", "office_0002"]
    mat, frames = _write_fake_mat(tmp_path, 4, scenes)
    splits = _splits(tmp_path, [1, 3], [2, 4])
    monkeypatch.setattr(sys, "argv", ["extract_nyu_mat.py", str(mat), str(splits),
                                      str(tmp_path / "tool")])
    jx_extract.main()
    pt_extract.main([str(mat), str(splits), str(tmp_path / "port")])
    tree = _tree(tmp_path / "tool")
    assert tree == _tree(tmp_path / "port") and len(tree) == 8
    for rel in tree:
        a = np.asarray(Image.open(tmp_path / "tool" / rel))
        b = np.asarray(Image.open(tmp_path / "port" / rel))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=rel)
    for img, dep in frames:
        np.testing.assert_array_equal(pt_extract.convert_rgb_black_border(img),
                                      jx_extract.convert_rgb_black_border(img))
        np.testing.assert_array_equal(pt_extract.convert_depth_mm(dep),
                                      jx_extract.convert_depth_mm(dep))


def test_extract_nyu_mat_split_assertion_as_the_tool(tmp_path, monkeypatch):
    mat, _ = _write_fake_mat(tmp_path, 2, ["kitchen_0001", "office_0002"], seed=3)
    splits = _splits(tmp_path, [1], [])
    monkeypatch.setattr(sys, "argv", ["extract_nyu_mat.py", str(mat), str(splits),
                                      str(tmp_path / "tool")])
    with pytest.raises(AssertionError) as tool_err:
        jx_extract.main()
    with pytest.raises(AssertionError) as port_err:
        pt_extract.main([str(mat), str(splits), str(tmp_path / "port")])
    assert str(port_err.value) == str(tool_err.value) == (
        "index 2 neither in training nor in test set")
    assert _tree(tmp_path / "tool") == _tree(tmp_path / "port")


# ---- the demo -----------------------------------------------------------------------

def _jax_demo_pred(cfg, tiny: bool):
    """``scripts/demo.py``'s computation on the synthetic frame with the
    golden tests' deterministic weights: (pred [H, W], the flax trees)."""
    sample = JxSynthetic(cfg, "online_eval")[0]
    image = jnp.asarray(jx_sample_image_f32(sample)[None])
    hist = jnp.asarray(sample["hist_data"][None])
    mask = jnp.asarray(sample["mask"][None])
    model = jx_make_model(cfg, tiny=tiny)
    geoms = model_geometries(cfg, "online_eval")
    shapes = jax.eval_shape(
        lambda r: model.init({"params": r, "fusion": r}, image, hist, mask, geoms),
        jax.random.key(0))
    variables = jax.tree_util.tree_map_with_path(_det_leaf, shapes)
    pred = jax.jit(lambda v: model.apply(v, image, hist, mask, geoms, train=False)[1])(variables)
    pred = jx_resize(pred, image.shape[1], image.shape[2])
    return np.asarray(pred)[0, :, :, 0], variables


def test_demo_predict_matches_the_jax_demo_at_the_tiny_size():
    """``predict`` on the tiny model at 64x96 with the JAX weights through
    ``from_flax`` against the JAX demo's forward and resize (f32, the
    goldens' tolerance)."""
    kw = dict(n_bins=16, native_height=64, native_width=96, eval_zone_num_cfg=2,
              eval_patch_px=16, attention_layer=["hist2image", "combine1", "image"],
              change_embedding=True, sample_uniform=True)
    jcfg, pcfg = JxConfig(**kw), PtConfig(**kw)
    want, variables = _jax_demo_pred(jcfg, tiny=True)
    sd = weights.from_flax(variables["params"], variables["batch_stats"], jcfg)
    got = demo.predict(pcfg, demo.load_frame(pcfg), sd, tiny=True, device="cpu")
    assert got.shape == want.shape == (64, 96)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5)


def test_demo_writes_the_colorized_prediction(tmp_path, capsys):
    """``python -m cfpnet_torch.demo --tiny --device cpu``: its PNG is
    ``colorize`` of its prediction, which is ``predict``'s on the
    deterministic weights."""
    from PIL import Image

    out = tmp_path / "depth.png"
    pred = demo.main(["--tiny", "--device", "cpu", "--out", str(out)])
    assert "note: deterministic weights" in capsys.readouterr().out
    config = demo.demo_config()
    np.testing.assert_array_equal(pred, demo.predict(config, demo.load_frame(config),
                                                     tiny=True, device="cpu"))
    assert pred.shape == (480, 640) and np.isfinite(pred).all()
    np.testing.assert_array_equal(np.asarray(Image.open(out)),
                                  colorize(pred, vmin=float(pred.min()), vmax=float(pred.max())))


@pytest.mark.slow
def test_demo_matches_the_jax_demo_at_480x640(tmp_path):
    """The command at 480x640 (``--tiny --device cpu``) against the JAX
    demo's computation with the same weights."""
    pred = demo.main(["--tiny", "--device", "cpu", "--out", str(tmp_path / "d.png")])
    cfg = JxConfig(n_bins=256, attention_layer=["hist2image", "combine1", "image",
                                                "hist2image", "combine1", "image"],
                   change_embedding=True, sample_uniform=True)
    want, _ = _jax_demo_pred(cfg, tiny=True)
    np.testing.assert_allclose(pred, want, rtol=5e-4, atol=5e-5)
