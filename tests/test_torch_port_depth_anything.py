"""Depth Anything V2 metric on the port (``cfpnet_torch/models/depth_anything.py``)
against the benchmark's plain reference (``benchmark/reference/
depth_anything_v2.py``), on the CPU at a tiny width (64 wide, 4 heads, 4
blocks each tapped, head features 32, a 48 x 64 frame resized to 56 x 70), on
the family's seeded weights (``benchmark/families/depth_anything_v2.py``):
the whole forward in float64 and float32, a ViT block and a
FeatureFusionBlock alone; the ``pos_embed`` resize against a bicubic
interpolation written out; the softmax attention's plain twin against a
loop, and its route (``ops/dispatch.py``) on the CPU and on fake CUDA
tensors (``FakeTensorMode``, no card), where a call counts one launch; the 24
calls of a published-width forward (on ``meta``); ``make_model`` by
``--model_name``; the entry points that run CFPNet alone refuse the model;
the spans of its two halves.

The card's side (the pinned backend's kernel, 24 launches in the captured
graph) is in ``benchmark/tests/test_benchmark_depth_anything.py``. This file
imports no JAX.
"""

import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.families import depth_anything_v2 as family
from benchmark.reference import depth_anything_v2 as ref
from cfpnet_torch import tracing
from cfpnet_torch.config import Config, parse_config
from cfpnet_torch.models import depth_anything
from cfpnet_torch.models.deltar import Deltar, make_model
from cfpnet_torch.ops import attention, dispatch

ROOT = Path(__file__).resolve().parents[1]
SETTINGS = dict(model_name="depth_anything_v2", native_height=48, native_width=64,
                max_depth=20.0, **ref.TINY)
SEED = 2 ** 31 + 25
# float32: the port and the reference sum in other orders (nn.ConvTranspose2d
# against an einsum, nn.Linear against F.linear, the attention's scale before or
# after q k^T), each product ~1e-7 relative apart; over 4 blocks and the head
# the depth maps differ by 5e-7 of their largest value (measured on this test's
# weights and frames), so 2e-5 leaves a factor of 40, while a single wrong term
# (a dropped LayerScale, bias or residual) moves them by 1e-2 and more.
F32_RTOL = 2e-5


def port(dtype=torch.float64, tiny=True):
    config = Config().replace(model_name="depth_anything_v2", native_height=48, native_width=64,
                              max_depth=20.0)
    model = make_model(config, tiny=tiny, device="cpu")
    model.load_state_dict(family.init_state(SETTINGS, SEED, "cpu", tiny=True))
    return model.to(dtype)


def reference(dtype=torch.float64):
    model = ref.build(SETTINGS, "cpu").to(dtype)
    model.load_state_dict(family.init_state(SETTINGS, SEED, "cpu", tiny=True))
    return model


def frames(n=2, dtype=torch.float64):
    return torch.from_numpy(family.inputs(SETTINGS, "frames", n, 7)["image"]).to(dtype)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-7), (torch.float32, F32_RTOL)])
def test_forward_matches_the_reference(dtype, rtol):
    image = frames(dtype=dtype)
    with torch.no_grad():
        (got,) = port(dtype)(image)
        want = reference(dtype)(image)
    assert got.shape == want.shape == (2, 48, 64, 1) and got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * float(want.abs().max()))
    # the map is not flat: the comparison sees the image through the model
    assert float(want.std()) > 1e-3 * float(want.abs().mean())


@pytest.mark.parametrize("tokens", [1 + 4 * 5, 1 + 37])
def test_a_vit_block_matches_the_reference(tokens):
    model, mine = port(), reference()
    x = torch.randn(2, tokens, 64, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for i in range(2):
            torch.testing.assert_close(model.pretrained.blocks[i](x),
                                       mine.block(mine.pretrained.blocks[i], x), rtol=1e-7,
                                       atol=1e-9)


@pytest.mark.parametrize("skip,size", [(True, (7, 9)), (True, None), (False, (5, 6))])
def test_a_fusion_block_matches_the_reference(skip, size):
    model, mine = port(), reference()
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(1, 32, 4, 5, dtype=torch.float64, generator=gen)
    s = torch.randn(1, 32, 4, 5, dtype=torch.float64, generator=gen) if skip else None
    with torch.no_grad():
        got = model.depth_head.scratch.refinenet2(x, s, size=size)
        want = mine.fusion(mine.depth_head.scratch.refinenet2, x, s, size=size)
    assert got.shape[-2:] == (size or (8, 10))
    torch.testing.assert_close(got, want, rtol=1e-7, atol=1e-9)


def bicubic_matrix(n_in: int, n_out: int, scale: float) -> np.ndarray:
    """(n_out, n_in) cubic convolution (a = -0.75) without aligned corners, by
    the scale factor ``scale``: source ``(o + 0.5) / scale - 0.5``, taps
    clamped to the edge."""
    a = -0.75

    def near(x):
        return ((a + 2) * x - (a + 3)) * x * x + 1

    def far(x):
        return ((a * x - 5 * a) * x + 8 * a) * x - 4 * a

    m = np.zeros((n_out, n_in))
    for o in range(n_out):
        src = (o + 0.5) / scale - 0.5
        i = math.floor(src)
        t = src - i
        for j, w in zip(range(i - 1, i + 3), (far(t + 1), near(t), near(1 - t), far(2 - t))):
            m[o, min(max(j, 0), n_in - 1)] += w
    return m


@pytest.mark.parametrize("g,grid", [(4, (4, 5)), (37, (37, 49)), (6, (3, 8))])
def test_pos_embed_resize_is_dinov2s_bicubic(g, grid):
    dim = 3
    pos = torch.randn(1, 1 + g * g, dim, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(g))
    got = depth_anything.interpolate_pos_embed(pos, grid)
    h, w = grid
    mh, mw = (bicubic_matrix(g, n, (n + 0.1) / g) for n in grid)
    square = pos[0, 1:].reshape(g, g, dim).numpy()
    want = np.einsum("oh,hwc,pw->opc", mh, square, mw).reshape(h * w, dim)
    assert got.shape == (1, 1 + h * w, dim) and got.dtype == pos.dtype
    assert torch.equal(got[0, 0], pos[0, 0].float().double())  # computed in float32
    # the written-out matrices are F.interpolate's bicubic by these scale factors (in
    # float64), and the port's resize, computed in float32 as DINOv2's, is that within the
    # float32 rounding of its source coordinates (~1e-7 x 49 pixels, times the slope)
    direct = torch.nn.functional.interpolate(
        pos[:, 1:].reshape(1, g, g, dim).permute(0, 3, 1, 2),
        scale_factor=tuple((n + 0.1) / g for n in grid), mode="bicubic")
    np.testing.assert_allclose(direct[0].permute(1, 2, 0).reshape(h * w, dim).numpy(), want,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[0, 1:].numpy(), want, rtol=0, atol=5e-5)
    mine = reference(torch.float64)
    mine.pretrained.pos_embed.data = pos
    torch.testing.assert_close(mine.pos_grid(h, w), got, rtol=0, atol=0)


def test_pos_embed_grid_follows_load_state_dict():
    model = port()
    grid = model.pretrained.pos_embed_grid
    ptr = grid.data_ptr()
    state = family.init_state(SETTINGS, SEED + 1, "cpu", tiny=True)
    model.load_state_dict({k: v.double() for k, v in state.items()})
    assert grid.data_ptr() == ptr  # in place: a captured graph reads the same memory
    torch.testing.assert_close(grid, depth_anything.interpolate_pos_embed(
        model.pretrained.pos_embed, model.grid), rtol=0, atol=0)


@pytest.mark.parametrize("native,size,want", [((480, 640), 518, (518, 686)),
                                              ((48, 64), 56, (56, 70)),
                                              ((640, 480), 518, (686, 518)),
                                              ((518, 518), 518, (518, 518)),
                                              ((64, 96), 70, (70, 112))])
def test_resized_size_is_dav2s_lower_bound(native, size, want):
    assert depth_anything.resized_size(*native, size) == want
    assert ref.lower_bound_size(*native, size) == want


def loop_attention(q, k, v, scale):
    out = torch.empty_like(q)
    B, H, L, _ = q.shape
    for b in range(B):
        for h in range(H):
            for i in range(L):
                s = torch.stack([q[b, h, i] @ k[b, h, j] for j in range(k.shape[2])]) * scale
                w = torch.exp(s - s.max())
                out[b, h, i] = (w[:, None] * v[b, h]).sum(0) / w.sum()
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("L,S", [(5, 5), (3, 7)])
def test_softmax_attention_twin_is_a_loop(dtype, L, S):
    gen = torch.Generator().manual_seed(L * S)
    q = torch.randn(2, 3, L, 8, dtype=dtype, generator=gen)
    k, v = (torch.randn(2, 3, S, 8, dtype=dtype, generator=gen) for _ in range(2))
    got = attention.softmax_attention(q, k, v, 8 ** -0.5)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got, loop_attention(q, k, v, 8 ** -0.5), rtol=tol, atol=tol)


def test_softmax_attention_twin_rounds_bf16_once():
    gen = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(1, 2, 6, 8, generator=gen).bfloat16() for _ in range(3))
    got = attention.softmax_attention(q, k, v, 0.3)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, attention.softmax_attention(q.float(), k.float(), v.float(),
                                                        0.3).bfloat16())


def test_the_route_on_the_cpu_is_the_twin():
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 2, 6, 8, generator=gen) for _ in range(3))
    before = tracing.counters("kernel.softmax_attention.")
    assert torch.equal(dispatch.softmax_attention(q, k, v, 0.3),
                       attention.softmax_attention(q, k, v, 0.3))
    assert tracing.counters("kernel.softmax_attention.") == before  # no kernel launched
    with pytest.raises(ValueError):
        dispatch.softmax_attention(q.to("meta"), k.to("meta"), v.to("meta"), 0.3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_the_card_route_counts_one_launch_a_call(dtype):
    """On fake CUDA tensors (``FakeTensorMode``: no card) a call takes the
    fused route and counts one launch under its dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    before = tracing.counters("kernel.softmax_attention.")
    with FakeTensorMode(allow_non_fake_inputs=True):
        q = torch.empty(1, 16, 1814, 64, device="cuda", dtype=dtype)
        out = dispatch.softmax_attention(q, q, q, 0.125)
    assert out.shape == q.shape and out.device.type == "cuda" and out.dtype == dtype
    after = tracing.counters("kernel.softmax_attention.")
    assert {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)} == \
        {f"kernel.softmax_attention.launches.{str(dtype)[6:]}": 1}


@pytest.mark.parametrize("tiny,calls", [(True, 4), (False, 24)])
def test_a_forward_routes_one_attention_a_block(monkeypatch, tiny, calls):
    """Every block's attention goes through the route, [1, 16, 1814, 64] at
    the published widths: 24 launches a forward on the card (on the ``meta``
    device, the route replaced by a recorder)."""
    seen = []

    def record(q, k, v, scale):
        seen.append((tuple(q.shape), scale))
        return torch.empty_like(q)

    monkeypatch.setattr(dispatch, "softmax_attention", record)
    config = Config().replace(model_name="depth_anything_v2", max_depth=20.0)
    model = make_model(config, tiny=tiny, device="meta")
    with torch.no_grad():
        (pred,) = model(torch.empty(1, 480, 640, 3, device="meta"))
    assert pred.shape == (1, 480, 640, 1)
    shape = (1, 4, 21, 16) if tiny else (1, 16, 1814, 64)
    assert seen == [(shape, shape[-1] ** -0.5)] * calls


def test_make_model_builds_dav2_at_the_published_widths():
    config = Config().replace(model_name="depth_anything_v2", max_depth=20.0)
    model = make_model(config, device="meta")
    assert isinstance(model, depth_anything.DepthAnythingV2) and not model.training
    assert (model.input_hw, model.grid, model.taps) == ((518, 686), (37, 49), (4, 11, 17, 23))
    assert sum(p.numel() for p in model.parameters()) == 335_315_649
    path = ROOT / "benchmark" / "configs" / "depth_anything_v2_vitl_hypersim.json"
    mine = ref.build(json.loads(path.read_text())["settings"], "meta").state_dict()
    assert {k: v.shape for k, v in model.state_dict().items()} == \
        {k: v.shape for k, v in mine.items()}


@pytest.mark.parametrize("argfile,params,leaves", [
    ("configs/train_cfpnet_combine1.txt", 21_444_670, 1014),
    ("configs/train_deltar_baseline.txt", 19_701_246, 864)])
def test_make_model_deltar_is_unchanged(argfile, params, leaves):
    config = parse_config([f"@{ROOT / argfile}"])
    assert config.model_name == "deltar"
    model = make_model(config, device="meta")
    assert type(model) is Deltar and not model.training
    assert sum(p.numel() for p in model.parameters()) == params
    assert len(model.state_dict()) == leaves


def test_make_model_refuses_another_name():
    with pytest.raises(ValueError, match="model_name"):
        make_model(Config().replace(model_name="dpt_hybrid"), device="meta")


DAV2 = Config().replace(model_name="depth_anything_v2")
ARGS = ["--model_name", "depth_anything_v2"]


def _entry_points():
    from cfpnet_torch import demo, evaluate, evaluate_all, evaluate_time
    from cfpnet_torch.serve import export
    from cfpnet_torch.train import loop, selfsup, steps

    return {
        "train step": lambda: steps.make_train_step(None, DAV2, None),
        "training loop": lambda: loop.run_training(DAV2, device="cpu"),
        "selfsup": lambda: selfsup.run_selfsup_training(DAV2, device="cpu"),
        "spatial train": lambda: loop.run_training(DAV2.replace(spatial_shards=2), device="cpu"),
        "spatial sweep": lambda: evaluate_all.main(ARGS + ["--spatial_shards", "2"]),
        "serving export": lambda: export.export_serving_artifact(DAV2, {}, "unused"),
        "ToF sweep": lambda: evaluate_all.main(ARGS + ["--device", "cpu"]),
        "evaluate": lambda: evaluate.main(ARGS + ["--device", "cpu"]),
        "evaluate_time": lambda: evaluate_time.main(ARGS + ["--device", "cpu"]),
        "demo": lambda: demo.predict(DAV2, {}),
    }


@pytest.mark.parametrize("name", ["train step", "training loop", "selfsup", "spatial train",
                                  "spatial sweep", "serving export", "ToF sweep", "evaluate",
                                  "evaluate_time", "demo"])
def test_cfpnet_entry_points_refuse_dav2(name):
    with pytest.raises(ValueError, match="deltar"):
        _entry_points()[name]()


def test_spans_of_the_two_halves():
    model = port(torch.float32)
    with tracing.session() as rec, torch.no_grad():
        model(frames(1, torch.float32))
    spans = rec.snapshot().spans
    assert [s.name for s in spans] == ["dav2.encoder", "dav2.head"]
    assert all(s.parent is None for s in spans)


@pytest.mark.parametrize("path", ["cfpnet_torch/models/depth_anything.py",
                                  "cfpnet_torch/ops/dispatch.py", "cfpnet_torch/ops/attention.py",
                                  "benchmark/reference/depth_anything_v2.py",
                                  "benchmark/families/depth_anything_v2.py"])
def test_new_modules_import_no_jax(path):
    names = set()
    for node in ast.walk(ast.parse((ROOT / path).read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    assert not names & {"jax", "jaxlib", "flax", "optax", "cfpnet_tpu"}
