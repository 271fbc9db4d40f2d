"""``BENCHMARK.json`` against the benchmark's contract, and the files each of
its names resolves to; a throwaway cell added from a temporary directory by
new files alone."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark.spec import Spec

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    return Spec(ROOT / "BENCHMARK.json", HERE)


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes(spec):
    d = spec.data
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(d["paths"]) <= 16 and all(PATH.match(p) and ".." not in p
                                              and not p.startswith("/") for p in d["paths"])
    assert 1 <= len(d["command"]) <= 32 and all(line(w) for w in d["command"])
    assert isinstance(d["run_seconds"], int) and 1 <= d["run_seconds"] <= 51
    # a full check of 24 cells: 2 + 14 runs a cell, each run_seconds + 60 s, 2 x 90 s
    # a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (d["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units(spec):
    d = spec.data
    names = {}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in d[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.setdefault(group, set()).add(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
        assert len(names[group]) == len(d[group])
    metrics = names["end_to_end"] | names["per_layer"]
    assert len(metrics) == len(d["end_to_end"]) + len(d["per_layer"])
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["chips"] in (1, 4)
    assert sum(w["chips"] == 4 for w in d["workloads"]) <= max(1, len(d["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in d["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_configs(spec):
    used = {w["config"] for w in spec.data["workloads"]}
    files = set()
    for c in spec.data["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and line(c["source"]) and line(c["why"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json" and c["file"] not in files
        files.add(c["file"])
        held = json.loads((ROOT / c["file"]).read_text())
        assert held["reduced"] == c["reduced"] == []
        assert held["name"] == c["name"] and held["source"] == c["source"]


def test_metrics(spec):
    d = spec.data
    cells = {w["name"] for w in d["workloads"]}
    e2e = {m["name"]: m for m in d["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in d["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in d["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert line(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
        assert callable(spec.reader(m))


@pytest.mark.parametrize("cell", ["cfpnet.frame_bs1", "cfpnet.train_bs16", "deltar.frame_bs1"])
def test_each_cell_resolves(spec, cell):
    w = spec.cell(cell)
    assert spec.config(w)["settings"]["attention_layer"]
    assert spec.traffic(w)["driver"] in ("frames", "train")
    assert spec.limits(w)
    reported = [m["name"] for m in spec.end_to_end(w)]
    assert "setup_s" in reported and len(reported) >= 2
    assert spec.per_layer(w)


def test_a_new_cell_is_new_files(tmp_path):
    """A cell, a configuration, a traffic mix, a per-layer metric and limits
    added as new files and new entries resolve without an edit."""
    here = tmp_path / "benchmark"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    d = json.loads((ROOT / "BENCHMARK.json").read_text())
    settings = json.loads((here / "configs" / "deltar_baseline.json").read_text())
    settings["name"] = "throwaway_config"
    (here / "configs" / "throwaway_config.json").write_text(json.dumps(settings))
    traffic = dict(json.loads((here / "traffic" / "frame_bs1.json").read_text()), batch=8)
    (here / "traffic" / "frame_bs8.json").write_text(json.dumps(traffic))
    (here / "metrics" / "frames_traced.infer.py").write_text(
        "def read(run):\n    return run.trace.items\n")
    (here / "limits" / "throwaway.frame_bs8.json").write_text('{"pred": 2.5}')
    d["configs"].append(dict(name="throwaway_config", source="https://example.org/x",
                             file="benchmark/configs/throwaway_config.json", reduced=[],
                             why="a throwaway"))
    d["workloads"].append(dict(name="throwaway.frame_bs8", config="throwaway_config",
                               traffic="frame_bs8", chips=1, why="a throwaway"))
    d["per_layer"].append(dict(name="frames_traced.infer", unit="frames", better="higher",
                               source="device_trace", layer="Device", moves="infer_img_s",
                               workloads=["throwaway.frame_bs8"]))
    for m in d["end_to_end"]:
        if "workloads" in m and "cfpnet.frame_bs1" in m["workloads"]:
            m["workloads"].append("throwaway.frame_bs8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(d))
    spec = Spec(tmp_path / "BENCHMARK.json", here)
    w = spec.cell("throwaway.frame_bs8")
    assert spec.traffic(w)["batch"] == 8 and spec.limits(w) == {"pred": 2.5}
    assert spec.config(w)["settings"]["attention_layer"] == ["hist2image", "image",
                                                             "hist2image", "image"]
    layer = [m for m in spec.per_layer(w) if m["name"] == "frames_traced.infer"]
    assert len(layer) == 1

    class Run:
        class trace:
            items = 7

    assert spec.reader(layer[0])(Run) == 7
    assert {m["name"] for m in spec.end_to_end(w)} == {"infer_img_s", "infer_ms_p95", "setup_s"}
