"""The port's slice as a whole against the JAX package, on the CPU: the tiny
``Deltar`` in float64 on the same weights, the golden forwards, the eval and
metric steps of both protocols, the synthetic dataset and the eval entry
point."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfpnet_torch import evaluate as pt_evaluate
from cfpnet_torch import weights
from cfpnet_torch.data.datasets import SyntheticDataset as PtSynthetic
from cfpnet_torch.models.deltar import make_model as pt_make_model
from cfpnet_torch.train import steps as pt_steps
from cfpnet_tpu.data.datasets import SyntheticDataset as JxSynthetic
from cfpnet_tpu.models.deltar import make_model as jx_make_model
from cfpnet_tpu.models.deltar import model_geometries
from cfpnet_tpu.train import steps as jx_steps
from tests.torch_port_util import close, enable_x64, random_tree, t


def _tiny_inputs(cfg, seed, batch=2):
    rng = np.random.default_rng(seed)
    h, w = cfg.native_height, cfg.native_width
    Z = cfg.eval_zone_num ** 2
    img = rng.standard_normal((batch, h, w, 3))
    hist = np.abs(rng.standard_normal((batch, Z, cfg.zone_sample_num))) * 2 + 0.5
    mask = rng.random((batch, Z)) > 0.25
    return img, hist, mask


@pytest.fixture(scope="module")
def tiny_config_module():
    """``tiny_config`` of tests/conftest.py, for module-scoped fixtures."""
    from cfpnet_tpu.config import Config

    return Config(n_bins=16, input_height=48, input_width=64, native_height=64,
                  native_width=96, train_zone_num=2, eval_zone_num_cfg=2, train_patch_px=16,
                  eval_patch_px=16, zone_sample_num=16, sample_uniform=True,
                  attention_layer=["hist2image", "combine1", "image"], change_embedding=True,
                  disable_clip_grad=True, hist_encoder_10x=True, bs=2, epochs=1)


@pytest.fixture(scope="module")
def tiny_f64(tiny_config_module):
    """Flax tiny model in f64 on random weights, its eval forward, and the
    port's tiny model on the same weights."""
    cfg = tiny_config_module
    geoms = model_geometries(cfg, "online_eval")
    img, hist, mask = _tiny_inputs(cfg, 0)
    model = jx_make_model(cfg, tiny=True)
    with enable_x64():
        shapes = jax.eval_shape(
            lambda r: model.init({"params": r, "fusion": r}, jnp.asarray(img), jnp.asarray(hist),
                                 jnp.asarray(mask), geoms), jax.random.key(0))
        # kernels of std 0.05 keep activations O(1) through the whole net; at
        # std 0.15 they reach ~1e3, where elu(x)+1 = expm1(x)+1 cancels and
        # the two frameworks' expm1 differ in the last bits
        variables = random_tree(shapes, 1, kernel_std=0.05)
        fwd = jax.jit(lambda v, i, h, m: model.apply(v, i, h, m, geoms, train=False))
        ref = [np.asarray(a) for a in fwd(variables, img, hist, mask)[:3]]
    port = pt_make_model(cfg, tiny=True, device="cpu").double()
    port.load_state_dict(weights.from_flax(variables["params"], variables["batch_stats"], cfg),
                         strict=True)
    return dict(cfg=cfg, geoms=geoms, variables=variables, model=model, port=port,
                inputs=(img, hist, mask), ref=ref)


def test_tiny_deltar_matches_flax_f64(tiny_f64):
    img, hist, mask = tiny_f64["inputs"]
    with torch.no_grad():
        out = tiny_f64["port"](t(img), t(hist), t(mask), tiny_f64["geoms"])
    assert out[3] is None
    for got, ref in zip(out[:3], tiny_f64["ref"]):
        assert got.dtype == torch.float64 and tuple(got.shape) == ref.shape
        close(got.numpy(), ref)


def test_tiny_deltar_matches_golden(tiny_config):
    """tests/golden/tiny_forward.npz on the golden test's deterministic
    weights and inputs, rebuilt without JAX from the flax paths."""
    cfg = tiny_config
    port = pt_make_model(cfg, tiny=True, device="cpu")
    port.load_state_dict(weights.deterministic_state_dict(cfg, tiny=True), strict=True)
    h, w = cfg.native_height, cfg.native_width
    Z = cfg.eval_zone_num ** 2
    img = weights.det_leaf("img", (1, h, w, 3))
    hist = np.abs(weights.det_leaf("hist", (1, Z, 16))) * 20
    with torch.no_grad():
        bin_edges, pred, prob, _ = port(t(img), t(hist), torch.ones(1, Z, dtype=torch.bool),
                                        model_geometries(cfg, "online_eval"))
    ref = np.load("tests/golden/tiny_forward.npz")
    got = dict(bin_edges=bin_edges.numpy(), pred=pred.numpy(),
               prob_sum0=prob[..., :4].mean(dim=(1, 2)).numpy())
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-4, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("protocol", ["evaluate_all", "validate"])
def test_eval_and_metric_steps_match_jax_f64(tiny_f64, protocol):
    cfg, geoms = tiny_f64["cfg"], tiny_f64["geoms"]
    img, hist, mask = tiny_f64["inputs"]
    rng = np.random.default_rng(5)
    depth = rng.uniform(0.5, 6.0, (img.shape[0], img.shape[1], img.shape[2], 1))
    depth[rng.random(depth.shape) < 0.1] = 0.0
    batch = dict(image=img, hist_data=hist, mask=mask, depth=depth)
    with enable_x64():
        v = tiny_f64["variables"]
        jx_eval = jx_steps.make_eval_step(tiny_f64["model"], cfg, geoms, protocol=protocol)
        ref_pred, _ = jx_eval(v["params"], v["batch_stats"], {k: jnp.asarray(a)
                                                              for k, a in batch.items()})
        ref_m, ref_n = jx_steps.make_metric_step(cfg, protocol=protocol)(
            jnp.asarray(depth), ref_pred)
        ref_pred = np.asarray(ref_pred)
    pt_batch = {k: t(a) for k, a in batch.items()}
    pred, _ = pt_steps.make_eval_step(tiny_f64["port"], cfg, geoms, protocol)(pt_batch)
    close(pred.numpy(), ref_pred)
    m, n = pt_steps.make_metric_step(cfg, protocol)(pt_batch["depth"], pred)
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    assert set(m) == set(ref_m)
    for k in m:
        close(m[k].numpy(), np.asarray(ref_m[k]), rtol=1e-6, atol=1e-9)


def test_synthetic_dataset_matches_jax(tiny_config):
    """Equal samples; the JAX package's ToF simulation may take its C++ path,
    which agrees with the numpy one to f32 rounding."""
    cfg = tiny_config.replace(dataset_eval="synthetic")
    for mode in ("online_eval", "train"):
        pt, jx = PtSynthetic(cfg, mode, 2), JxSynthetic(cfg, mode, 2)
        for i in range(2):
            a, b = pt[i], jx[i]
            assert set(a) == set(b)
            for k in a:
                msg = f"{mode}[{i}].{k}"
                if k == "hist_data":
                    np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6, err_msg=msg)
                else:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=msg)


@pytest.mark.parametrize("uniform", [True, False])
def test_tof_sim_matches_jax(tiny_config, uniform):
    """Zone histograms, moments and point sampling (both sampling modes) on a
    depth map with invalid pixels and a zone beyond the ToF range."""
    from cfpnet_torch.data import tof_sim as pt_tof
    from cfpnet_torch.data.geometry import geometry_for as pt_geometry_for
    from cfpnet_tpu.data import tof_sim as jx_tof
    from cfpnet_tpu.data.geometry import geometry_for as jx_geometry_for

    rng = np.random.default_rng(9)
    depth = rng.uniform(0.3, 3.5, (64, 96)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.05] = 0.0
    depth[:32, :48] = 6.0
    pt_fh, pt_fr, pt_mask = pt_tof.get_hist(depth, pt_geometry_for(tiny_config, "online_eval"))
    jx_fh, jx_fr, jx_mask = jx_tof.get_hist(depth, jx_geometry_for(tiny_config, "online_eval"))
    np.testing.assert_array_equal(pt_mask, jx_mask)
    np.testing.assert_array_equal(pt_fr, jx_fr)
    np.testing.assert_allclose(pt_fh, jx_fh, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pt_tof.sample_points(pt_fh, pt_mask, 16, uniform),
                               jx_tof.sample_points(pt_fh, pt_mask, 16, uniform), rtol=1e-6)


def test_evaluate_entry_point_on_cpu(tiny_config):
    """The eval entry point, run as a user would with --device cpu, on two
    synthetic images at bs=2 (one forward) and bs=1 with a ragged tail."""
    cfg = tiny_config
    argv = ["--device", "cpu", "--test_dataset", "synthetic", "--synthetic_length", "3",
            "--tiny_model", "--n_bins", "16", "--native_height", "64", "--native_width", "96",
            "--eval_zone_num_cfg", "2", "--eval_patch_px", "16", "--sample_uniform",
            "--change_embedding", "--attention_layer", *cfg.attention_layer]
    outs = [pt_evaluate.main(argv + ["--eval_bs", str(bs)]) for bs in (1, 2)]
    for out in outs:
        assert out["images"] == 3 and "latency_ms_bs1" not in out
        assert set(out["metrics"]) == set(pt_evaluate.METRICS)
        assert all(np.isfinite(v) for v in out["metrics"].values())
    for k in pt_evaluate.METRICS:  # per-image averaging: any eval_bs gives the same metrics
        np.testing.assert_allclose(outs[0]["metrics"][k], outs[1]["metrics"][k], rtol=1e-5)


@pytest.mark.slow
def test_full_size_forward_matches_golden():
    """tests/golden/full_forward.npz: the production model at 480x640 on the
    deterministic weights, through the port's plain ops on the CPU."""
    from cfpnet_torch.config import Config

    cfg = Config(n_bins=256, attention_layer=["hist2image", "combine1", "image",
                                              "hist2image", "combine1", "image"],
                 change_embedding=True, sample_uniform=True)
    port = pt_make_model(cfg, device="cpu")
    port.load_state_dict(weights.deterministic_state_dict(cfg), strict=True)
    img = weights.det_leaf("img", (1, 480, 640, 3))
    hist = np.abs(weights.det_leaf("hist", (1, 64, 16))) * 20
    with torch.no_grad():
        bin_edges, pred, _, _ = port(t(img), t(hist), torch.ones(1, 64, dtype=torch.bool),
                                     model_geometries(cfg, "online_eval"))
    ref = np.load("tests/golden/full_forward.npz")
    got = dict(pred_slice=pred.numpy()[0, ::16, ::16, 0], bin_edges16=bin_edges.numpy()[0, ::16],
               pred_mean=pred.mean().numpy()[None])
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=5e-4, atol=5e-5, err_msg=k)
