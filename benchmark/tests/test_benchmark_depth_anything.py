"""The family ``depth_anything_v2``: its cell runs through ``run.main`` on the
CPU at the family's test widths from a copy of the benchmark to which its
files were added as new files, ``correct`` with the port's outputs and not
with the depth scaled by 1.1; its work at the published widths against a hand
count; its reference imports no port; its configuration is the published one,
uncut. On the card (skipped off it): the attention route's kernel is the
pinned backend's, which the roofline reader finds, and the captured graph of
the published model holds 24 attention launches."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark.families import depth_anything_v2 as family
from benchmark.reference import depth_anything_v2 as ref
from benchmark.spec import Spec

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
SPEC = Spec(ROOT / "BENCHMARK.json")
CELL = "depth_anything_v2.frame_bs1"
CONFIG = "depth_anything_v2_vitl_hypersim"
NEW = {Path("configs", f"{CONFIG}.json"), Path("families", "depth_anything_v2.py"),
       Path("reference", "depth_anything_v2.py"), Path("limits", f"{CELL}.json"),
       Path("metrics", "vit_attention_roofline.py")}
PUBLISHED = dict(embed_dim=1024, depth=24, num_heads=16, mlp_ratio=4,
                 intermediate_layer_idx=[4, 11, 17, 23], features=256,
                 out_channels=[256, 512, 1024, 1024], input_size=518, max_depth=20.0,
                 native_height=480, native_width=640)

# A run of the cell on the CPU at the test widths, the captured forward
# replaced by the same forward called eagerly (a graph needs a card);
# "altered" scales the depth where it is produced.
RUN = """
import sys
import torch
from benchmark import run
from benchmark.families import depth_anything_v2 as family

def capture(model, settings, batch, tiny):
    @torch.no_grad()
    def forward(image):
        out = model(image)
        return out if sys.argv[1] == "sound" else tuple(o * 1.1 for o in out)
    return forward

family.capture_frames = capture
sys.exit(run.main(["--workload", "depth_anything_v2.frame_bs1", "--seed", str(2 ** 31 + 2025),
                   "--seconds", "0.5"], device="cpu", tiny=True))
"""


def files(root: Path):
    found = {p.relative_to(root): p for p in root.rglob("*") if p.is_file()}
    return {rel: p.read_bytes() for rel, p in found.items()
            if not {"__pycache__", "tests"} & set(rel.parts)}


def checkout(root: Path) -> Path:
    """A copy of the benchmark at ``root``: the files it has without the
    family's, then the family's added."""
    base = root / "benchmark"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for rel in NEW:
        (base / rel).unlink()
    before = files(base)
    for rel in NEW:
        shutil.copy(HERE / rel, base / rel)
    after = files(base)
    assert {k: after[k] for k in before} == before and set(after) - set(before) == NEW
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


@pytest.mark.parametrize("answer", ["sound", "altered"])
def test_the_cell_runs_from_new_files(tmp_path, answer):
    root = checkout(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", RUN, answer], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is (answer == "sound"), result["checks"]
    assert set(result["metrics"]) == {"infer_img_s", "infer_ms_p95", "setup_s"}
    assert result["attempted"] > 0 and result["failed"] == 0


def test_the_cell_reads_its_metrics():
    cell = SPEC.cell(CELL)
    assert SPEC.family(cell) is family
    assert ([m["name"] for m in SPEC.end_to_end(cell)],
            [m["name"] for m in SPEC.per_layer(cell)]) == (
        ["infer_img_s", "infer_ms_p95", "setup_s"],
        ["device_idle.infer", "mfu.infer", "graph_host_ms.infer", "vit_attention_roofline"])


def hand_count():
    """Operations of one 480 x 640 frame at the published widths, by part."""
    C, N, L = 1024, 1 + 37 * 49, 24
    products = 2 * 37 * 49 * C * 3 * 14 * 14 + L * 2 * N * C * (3 * C + C + 4 * C + 4 * C)
    attention = L * 4 * 16 * N * N * 64
    f, px = 256, {1: 148 * 196, 2: 74 * 98, 3: 37 * 49, 4: 19 * 25}
    head = 2 * 37 * 49 * C * (256 + 512 + 1024 + 1024)  # projects
    head += 2 * 37 * 49 * (256 * 256 * 16 + 512 * 512 * 4)  # the transposed convolutions
    head += 2 * px[4] * 1024 * 1024 * 9  # the stride-2 convolution
    head += sum(2 * px[i] * c * f * 9 for i, c in zip((1, 2, 3, 4), (256, 512, 1024, 1024)))
    rcu = 2 * 2 * f * f * 9  # two 3 x 3 convolutions a pixel
    head += rcu * (px[4] + 2 * px[3] + 2 * px[2] + 2 * px[1])  # refinenet4 has one unit
    head += 2 * f * f * (px[3] + px[2] + px[1] + 296 * 392)  # the out_convs
    head += 2 * 296 * 392 * f * 128 * 9 + 2 * 518 * 686 * (128 * 32 * 9 + 32)
    return dict(products=products, attention=attention, head=head)


def test_work_is_the_hand_count():
    settings = SPEC.config(SPEC.cell(CELL))["settings"]
    parts, calls = ref.count(settings)
    want = hand_count()
    for name, n in want.items():
        assert parts[name] == pytest.approx(n, rel=1e-3), name
    flops, found = family.work(settings, SPEC.traffic(SPEC.cell(CELL)))
    assert flops == sum(parts.values()) == pytest.approx(sum(want.values()), rel=1e-3)
    assert found == calls == [("softmax_attention", (1, 16, 1814, 64))] * 24


def test_least_time_of_an_attention_call():
    # 13.5 GFLOP at the bf16 peak, above 14.9 MB at the memory rate
    assert ref.least_ms((1, 16, 1814, 64)) == pytest.approx(
        4 * 16 * 1814 ** 2 * 64 / 989.4e12 * 1e3)


def test_the_reference_imports_no_port():
    names = set()
    for node in ast.walk(ast.parse((HERE / "reference" / "depth_anything_v2.py").read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    assert not names & {"cfpnet_torch", "cfpnet_tpu", "jax", "jaxlib", "flax"}


def test_the_configuration_is_published_and_uncut():
    from cfpnet_torch.models import depth_anything

    data = SPEC.config(SPEC.cell(CELL))
    entry = next(c for c in SPEC.data["configs"] if c["name"] == CONFIG)
    assert data["reduced"] == entry["reduced"] == []
    assert data["family"] == "depth_anything_v2" and data["name"] == CONFIG
    settings = data["settings"]
    assert {k: settings[k] for k in PUBLISHED} == PUBLISHED
    port = dict(depth_anything.VITL, out_channels=list(depth_anything.VITL["out_channels"]),
                intermediate_layer_idx=list(depth_anything.VITL["taps"]))
    assert {k: port[k] for k in ref.WIDTHS} == ref.widths(settings)
    skeleton = ref.build(settings, "meta").state_dict()
    assert sum(t.numel() for t in skeleton.values()) == data["published"]["parameters"]


def test_the_weights_are_the_rule():
    settings = dict(SPEC.config(SPEC.cell(CELL))["settings"])
    state = family.init_state(settings, 11, "cpu", tiny=True)
    assert torch.equal(state["pretrained.blocks.0.ls1.gamma"],
                       torch.full((64,), family.LAYERSCALE))
    assert float(state["pretrained.norm.weight"].min()) == 1.0
    assert float(state["depth_head.projects.0.bias"].abs().max()) == 0.0
    w = state["depth_head.resize_layers.0.weight"]  # [C_in, C_out, 4, 4]: fan-in C_in
    assert float(w.std()) == pytest.approx(w.shape[0] ** -0.5, rel=0.1)
    again = family.init_state(settings, 11, "cpu", tiny=True)
    assert all(torch.equal(state[k], again[k]) for k in state)


@pytest.mark.parametrize("kernels", [[], [("void cunn_SoftMaxForward", 1e-3)]])
def test_the_roofline_reads_nothing_without_attention_kernels(kernels):
    from benchmark import trace

    tr = trace.Trace(1, 1, 0.0, [], [])
    tr.kernels = kernels
    run = SimpleNamespace(trace=tr, calls=[("softmax_attention", (1, 16, 1814, 64))] * 24)
    assert SPEC.reader(next(m for m in SPEC.data["per_layer"]
                            if m["name"] == "vit_attention_roofline"))(run) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
def test_the_route_runs_the_pinned_backend(card):
    from torch.profiler import ProfilerActivity, profile

    from benchmark.metrics import vit_attention_roofline as reader
    from cfpnet_torch.ops import attention, dispatch

    gen = torch.Generator("cuda").manual_seed(5)
    q, k, v = (torch.randn(1, 16, 1814, 64, device="cuda", generator=gen, dtype=torch.bfloat16)
               for _ in range(3))
    dispatch.softmax_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = dispatch.softmax_attention(q, k, v, 0.125)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any(f in n for n in names for f in reader.KERNELS), names
    assert not any("SoftMax" in n for n in names), names  # the math backend's softmax
    plain = attention.softmax_attention(q, k, v, 0.125)
    assert float((out.float() - plain.float()).abs().max()) <= 2 ** -7 * float(plain.abs().max())
    with pytest.raises(RuntimeError):
        dispatch.softmax_attention(q.float(), k.float(), v.float(), 0.125)


@pytest.mark.gpu
def test_the_graph_holds_24_attention_launches(card):
    from cfpnet_torch import tracing

    settings = SPEC.config(SPEC.cell(CELL))["settings"]
    state = family.init_state(settings, 2 ** 31 + 9, "cuda")
    model = family.frame_model(settings, state, torch.bfloat16, "cuda")
    captured = family.capture_frames(model, settings, 1)
    assert captured.names == ("image",)
    assert captured.launches == {"kernel.softmax_attention.launches.bfloat16": 24}
    before = tracing.counters("kernel.softmax_attention.")
    image = torch.randn(1, 480, 640, 3, device="cuda", dtype=torch.bfloat16)
    (pred,) = captured(image)
    torch.cuda.synchronize()
    after = tracing.counters("kernel.softmax_attention.")
    assert after["kernel.softmax_attention.launches.bfloat16"] - \
        before.get("kernel.softmax_attention.launches.bfloat16", 0) == 24
    assert pred.shape == (1, 480, 640, 1) and bool(torch.isfinite(pred).all())
    with torch.no_grad():
        (eager,) = model(image)
    assert float((eager.float() - pred.float()).abs().max()) <= 2 ** -7 * float(eager.abs().max())
