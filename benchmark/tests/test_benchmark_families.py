"""The model family of a configuration (``families/``): the three cells read
through the ``cfpnet`` family exactly what the harness read before the
families were split out of it (the output checks at a tiny size on the CPU,
the work counts at the published widths, the metric names); a configuration
without ``family`` is ``cfpnet``; and a second family is new files only: a
toy family run as a frames cell on the CPU from a copy of the benchmark to
which nothing but new files and new entries were added."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import drivers
from benchmark.families import cfpnet
from benchmark.reference import precision
from benchmark.spec import Spec

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
TOY = Path(__file__).resolve().parent / "toy"
SPEC = Spec(ROOT / "BENCHMARK.json")
CELLS = ("cfpnet.frame_bs1", "deltar.frame_bs1", "cfpnet.train_bs16")
TINY = dict(n_bins=16, native_height=64, native_width=96, eval_zone_num_cfg=2, eval_patch_px=16,
            input_height=48, input_width=64, train_zone_num=2, train_patch_px=16)
SEED = 2 ** 31 + 4242
FRAMES = 20  # the frames driven before a frames cell's check

# The readings of the output checks (the program's, then the control's: fp8
# products for the bf16 frame cells) at the tiny size, one CPU thread, seed
# SEED, after FRAMES frames or the train cell's first three steps, as the
# harness gave them before the families.
READINGS = {
    "cfpnet.frame_bs1": ({"pred": 0.831261934089226}, {"pred": 3.3127533874678665}),
    "deltar.frame_bs1": ({"pred": 1.0113884356942944}, {"pred": 1.006922708773184}),
    "cfpnet.train_bs16": ({"loss": 0.0, "grad": 0.0011186708784560093,
                           "change": 0.021615408002102005,
                           "loss_steps": [0.0, 4.506394348260464e-07, 3.291654405254007e-07]},
                          None),
}

# The kernel calls of a published-width forward, by fusion scale (1/16, 1/8,
# 1/4): the hist2image layer, combine1's attention and dwconv, the two image
# layers; each scale's fusion runs twice.
SCALES = (
    ((64, 16, 16, 128, 4), (1, 1200, 784, 4, 32), (1, 30, 40, 128, 7), (35, 36, 36, 128, 8),
     (1, 1200, 30, 128, 8)),
    ((64, 49, 16, 64, 4), (1, 4800, 3136, 4, 16), (1, 60, 80, 64, 15), (63, 81, 81, 64, 8),
     (1, 4800, 48, 64, 8)),
    ((64, 196, 16, 32, 4), (1, 19200, 12544, 4, 8), (1, 120, 160, 32, 31),
     (140, 144, 144, 32, 8), (1, 19200, 130, 32, 8)),
)


def calls(combine: bool):
    kinds = ("fused_loftr", "linear_attention", "dwconv", "fused_loftr", "fused_loftr")
    return [(k, shape) for scale in SCALES for _ in range(2)
            for k, shape in zip(kinds, scale) if combine or k == "fused_loftr"]


WORK = {
    "cfpnet.frame_bs1": (95_013_863_680, calls(True)),
    "deltar.frame_bs1": (83_441_959_168, calls(False)),
    "cfpnet.train_bs16": (3_350_829_490_176, []),
}

METRICS = {
    "cfpnet.frame_bs1": (["infer_img_s", "infer_ms_p95", "setup_s"],
                         ["device_idle.infer", "fused_loftr_roofline", "dwconv_roofline",
                          "mfu.infer", "graph_host_ms.infer"]),
    "deltar.frame_bs1": (["infer_img_s", "infer_ms_p95", "setup_s"],
                         ["device_idle.infer", "fused_loftr_roofline", "mfu.infer",
                          "graph_host_ms.infer"]),
    "cfpnet.train_bs16": (["train_img_s", "setup_s"],
                          ["device_idle.train", "mfu.train", "launches.train",
                           "forward_host_ms.train", "backward_host_ms.train",
                           "optimizer_host_ms.train"]),
}


def eager(model, geoms, batch, config):
    @torch.no_grad()
    def forward(image, hist, mask):
        return model(image, hist, mask, geoms)

    return forward


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", CELLS)
def test_a_config_without_family_is_cfpnet(name):
    cell = SPEC.cell(name)
    assert "family" not in SPEC.config(cell)
    assert SPEC.family(cell) is cfpnet


@pytest.mark.parametrize("family", ["../cfpnet", "cfp-net"])
def test_a_family_name_is_a_module_name(tmp_path, family):
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "x.json").write_text(json.dumps(dict(family=family)))
    with pytest.raises(ValueError):
        Spec(ROOT / "BENCHMARK.json", tmp_path).family(dict(config="x"))


@pytest.mark.parametrize("name", CELLS)
def test_readings_unchanged(monkeypatch, one_thread, name):
    monkeypatch.setattr(cfpnet, "capture_forward", eager)
    cell = SPEC.cell(name)
    traffic = SPEC.traffic(cell)
    settings = dict(SPEC.config(cell)["settings"], **TINY)
    driver = drivers.DRIVERS[traffic["driver"]](SPEC.family(cell), settings, traffic, SEED,
                                                "cpu", tiny=True)
    if traffic["driver"] == "frames":
        for _ in range(FRAMES):
            driver.frame(driver.frames)
        got = driver.check(precision.fp8)
    else:
        got = driver.check()
    assert got == READINGS[name]


@pytest.mark.parametrize("name", CELLS)
def test_work_unchanged(name):
    cell = SPEC.cell(name)
    flops, found = SPEC.family(cell).work(SPEC.config(cell)["settings"], SPEC.traffic(cell))
    assert (flops, found) == WORK[name]


@pytest.mark.parametrize("name", CELLS)
def test_metric_names_unchanged(name):
    cell = SPEC.cell(name)
    assert ([m["name"] for m in SPEC.end_to_end(cell)],
            [m["name"] for m in SPEC.per_layer(cell)]) == METRICS[name]


# A run of the toy cell on the CPU, the captured forward replaced by the same
# forward called eagerly (a graph needs a card); "altered" scales the depth
# where it is produced.
RUN_TOY = """
import sys
import torch
from benchmark import run
from benchmark.families import toy

def capture(model, settings, batch, tiny):
    @torch.no_grad()
    def forward(image):
        out = model(image)
        return out if sys.argv[1] == "sound" else tuple(o * 1.1 for o in out)
    return forward

toy.capture_frames = capture
sys.exit(run.main(["--workload", "toy.frame_bs1", "--seed", str(2 ** 31 + 77),
                   "--seconds", "0.5"], device="cpu", tiny=True))
"""
TOY_CELL = dict(name="toy.frame_bs1", config="toy_net", traffic="frame_bs1", chips=1,
                why="a toy family's frames")
TOY_CONFIG = dict(name="toy_net", source="https://example.org/toy-depth",
                  file="benchmark/configs/toy_net.json", reduced=[], why="a toy family")


def toy_checkout(root: Path) -> Path:
    """A copy of the benchmark at ``root`` with the toy family added as new
    files and new entries."""
    shutil.copytree(HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copytree(TOY, root / "benchmark", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    d = json.loads((ROOT / "BENCHMARK.json").read_text())
    d["configs"].append(TOY_CONFIG)
    d["workloads"].append(TOY_CELL)
    for m in d["end_to_end"]:
        if m["name"] in ("infer_img_s", "infer_ms_p95"):
            m["workloads"].append(TOY_CELL["name"])
    (root / "BENCHMARK.json").write_text(json.dumps(d, indent=1))
    return root


def files(root: Path):
    """The bytes of each file under ``root`` by its relative path, the tests
    and caches left out."""
    found = {p.relative_to(root): p for p in root.rglob("*") if p.is_file()}
    return {rel: p.read_bytes() for rel, p in found.items()
            if not {"__pycache__", "tests"} & set(rel.parts)}


@pytest.mark.parametrize("answer", ["sound", "altered"])
def test_a_second_family_is_new_files(tmp_path, answer):
    root = toy_checkout(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", RUN_TOY, answer], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is (answer == "sound"), result["checks"]
    assert set(result["metrics"]) == {"infer_img_s", "infer_ms_p95", "setup_s"}
    assert list(result)[-1] == "checks"
    # every file that was there is as it was; the toy's are the only new ones
    before, after = files(HERE), files(root / "benchmark")
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == set(files(TOY))
    # BENCHMARK.json gained the toy's entries and nothing else
    d = json.loads((root / "BENCHMARK.json").read_text())
    assert d["configs"].pop() == TOY_CONFIG and d["workloads"].pop() == TOY_CELL
    for m in d["end_to_end"]:
        if m["name"] in ("infer_img_s", "infer_ms_p95"):
            assert m["workloads"].pop() == TOY_CELL["name"]
    assert d == json.loads((ROOT / "BENCHMARK.json").read_text())
