"""The port's timing entry points on the CPU, at the tiny size: the resize
matrices kept on their device, the FLOP and parameter counts of
``cfpnet_torch.evaluate_time`` against the JAX package's, the CLI of
``cfpnet_torch.evaluate_time``, ``cfpnet_torch.bench --smoke``, and
``CapturedForward``'s refusal of a model off the card."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import evaluate_time as jx_evaluate_time
from cfpnet_torch import bench, evaluate_time
from cfpnet_torch.graphs import CapturedForward
from cfpnet_torch.models.convnext import LargeKernelDWConv
from cfpnet_torch.models.deltar import make_model, model_geometries
from cfpnet_torch.ops import interp
from cfpnet_tpu.models.deltar import make_model as jx_make_model
from cfpnet_tpu.ops.interp import _interp_matrix as jx_interp_matrix
from cfpnet_tpu.ops.interp import resize_bilinear_align_corners as jx_resize
from tests.torch_port_util import enable_x64, t

# forward_flops / graph_flops_eval on the tiny config: the port's count is
# FlopCounterMode's (convolutions and matrix products) plus the depthwise
# convs; XLA's cost analysis also counts elementwise work and the depth
# head's reductions, and its counts are not linear in the batch
MEASURED_RATIO = {1: 0.9871, 2: 1.0126}


def _tiny_forward(cfg, model, batch=1):
    Z = cfg.eval_zone_num ** 2
    with torch.no_grad():
        return model(torch.zeros(batch, cfg.native_height, cfg.native_width, 3),
                     torch.ones(batch, Z, cfg.zone_sample_num),
                     torch.ones(batch, Z, dtype=torch.bool), model_geometries(cfg, "online_eval"))


def test_interp_matrices_built_once_per_key(tiny_config, monkeypatch):
    """The first forward builds each resize matrix once; a second forward
    builds none (on the card each build is a copy from the host, which waits
    for the card)."""
    model = make_model(tiny_config, tiny=True, device="cpu")
    calls, builds = [], []
    device_matrix, interp_matrix = interp._device_matrix, interp._interp_matrix
    monkeypatch.setattr(interp, "_device_matrix", lambda *a: calls.append(a) or device_matrix(*a))
    monkeypatch.setattr(interp, "_interp_matrix", lambda *a: builds.append(a) or interp_matrix(*a))
    monkeypatch.setattr(interp, "_DEVICE_MATRICES", {})
    _tiny_forward(tiny_config, model)
    first_calls, first_builds = len(calls), len(builds)
    assert first_builds == len(interp._DEVICE_MATRICES) > 0
    _tiny_forward(tiny_config, model)
    assert len(builds) == first_builds
    assert len(calls) == 2 * first_calls  # every call of the forward reads the cache


@pytest.mark.parametrize("in_size,out_size", [(1, 5), (4, 1), (15, 30), (30, 60), (60, 120),
                                              (120, 240), (7, 16), (32, 8), (240, 480)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_interp_matrix_bit_equal_to_jax(in_size, out_size, dtype):
    like = torch.zeros((), dtype=dtype)
    got = interp._matrix(in_size, out_size, like)
    assert got is interp._matrix(in_size, out_size, like)
    want = jx_interp_matrix(in_size, out_size).astype(torch.empty((), dtype=dtype).numpy().dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def test_resize_matches_jax_f64():
    x = np.random.default_rng(4).standard_normal((2, 7, 9, 3))
    with enable_x64():
        want = np.asarray(jx_resize(jnp.asarray(x), 15, 20))
    np.testing.assert_allclose(interp.resize_bilinear_align_corners(t(x), 15, 20).numpy(), want,
                               rtol=1e-12, atol=1e-12)


def _dwconv_flops(cfg, model, batch):
    """2·k²·B·H·W·C of each depthwise conv of the forward, from the fusion
    stage that holds it and that stage's scale."""
    total = 0
    decoder = model.decoder
    for scale, fusion in ((16, decoder.cross_atten3), (8, decoder.cross_atten2),
                          (4, decoder.cross_atten1)):
        H, W = cfg.native_height // scale, cfg.native_width // scale
        for m in fusion.modules():
            if isinstance(m, LargeKernelDWConv):
                C, _, k, _ = m.weight.shape
                total += 2 * k * k * batch * H * W * C
    return total


@pytest.mark.parametrize("batch", [1, 2])
def test_forward_flops_against_jax(tiny_config, batch):
    """Within [0.85, 1.05] of JAX graph_flops_eval (measured ratio in
    MEASURED_RATIO), and the sum of the counter's count and the depthwise
    convs' operations, which the counter cannot see."""
    got = evaluate_time.forward_flops(tiny_config, batch, tiny=True)
    ratio = got / jx_evaluate_time.graph_flops_eval(tiny_config, batch, tiny=True)
    assert 0.85 <= ratio <= 1.05
    assert ratio == pytest.approx(MEASURED_RATIO[batch], abs=1e-4)
    model = make_model(tiny_config, tiny=True, device="cpu")
    with FlopCounterMode(display=False) as counter:
        _tiny_forward(tiny_config, model, batch)
    dwconv = _dwconv_flops(tiny_config, model, batch)
    assert dwconv > 0 and got == counter.get_total_flops() + dwconv


def test_forward_flops_linear_in_batch(tiny_config):
    one = evaluate_time.forward_flops(tiny_config, 1, tiny=True)
    assert evaluate_time.forward_flops(tiny_config, 3, tiny=True) == 3 * one


def test_param_count_equals_flax(tiny_config):
    """The count that root evaluate_time.py --profile_flops prints from the
    flax variables; BatchNorm statistics count in neither. At the production
    size both give 21,444,670 (the flax side is not traced here)."""
    model = jx_make_model(tiny_config, tiny=True)
    h, w, Z = tiny_config.native_height, tiny_config.native_width, tiny_config.eval_zone_num ** 2
    shapes = jax.eval_shape(
        lambda r: model.init({"params": r, "fusion": r}, jnp.zeros((1, h, w, 3)),
                             jnp.zeros((1, Z, tiny_config.zone_sample_num)),
                             jnp.ones((1, Z), bool), model_geometries(tiny_config, "online_eval")),
        jax.random.key(0))
    flax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert evaluate_time.param_count(tiny_config.replace(tiny_model=True)) == flax
    assert evaluate_time.param_count(bench.production_config()) == 21_444_670


def test_captured_forward_refuses_a_cpu_model(tiny_config):
    model = make_model(tiny_config, tiny=True, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        CapturedForward(model, model_geometries(tiny_config, "online_eval"), 1, tiny_config)


def test_bench_smoke_prints_one_json_line(capsys):
    assert bench.main(["--smoke"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"].endswith("_smoke")
    assert out["smoke"] is True and out["device"] == "cpu"
    assert out["value"] > 0 and out["flops_g_fwd"] > 0
    assert "mfu_bs1_f32" not in out


TINY_ARGV = ["--device", "cpu", "--niters", "4", "--tiny_model", "--n_bins", "16",
             "--native_height", "64", "--native_width", "96", "--eval_zone_num_cfg", "2",
             "--eval_patch_px", "16", "--sample_uniform", "--change_embedding",
             "--test_dataset", "synthetic", "--attention_layer", "hist2image", "combine1", "image"]


def test_evaluate_time_cli_eager_on_cpu(capsys):
    out = evaluate_time.main(TINY_ARGV + ["--eager", "--profile_flops"])
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == f"{out['latency_ms_bs1']:.3f} ms"
    assert "frames/sec" in printed[1] and printed[3].startswith("params: ")
    assert out["graphed"] is False and out["latency_ms_bs1"] > 0
    assert out["params"] == evaluate_time.param_count(bench.smoke_config())
    assert out["flops"] == evaluate_time.forward_flops(bench.smoke_config())


def test_evaluate_time_cli_refuses(capsys):
    """A CUDA graph needs a card: no eager stand-in on the CPU; a serving
    artifact that is not there is not timed (serving itself:
    tests/test_torch_port_serving.py)."""
    with pytest.raises(ValueError, match="CUDA"):
        evaluate_time.main(TINY_ARGV)
    with pytest.raises(FileNotFoundError, match="manifest.json"):
        evaluate_time.main(TINY_ARGV + ["--eager", "--serving_artifact", "model.bin"])
