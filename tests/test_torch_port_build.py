"""The kernel build's library names (``cfpnet_torch/kernels/build.py``): a
library is named by a digest of its source, the ``csrc/`` headers that
source includes and the nvcc flags, so that a changed header rebuilds it and
a change elsewhere does not. No nvcc needed: only ``library_path`` runs,
against a copy of ``csrc/``."""

import shutil

import pytest

from cfpnet_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, copy)
    monkeypatch.setattr(build, "CSRC_DIR", copy)
    return copy


def _append(path, text):
    path.write_text(path.read_text() + text)


def test_changed_header_changes_the_digest(csrc):
    assert '#include "hopper.cuh"' in (csrc / "fused_loftr.cu").read_text()
    before = build.library_path("fused_loftr")
    assert build.library_path("fused_loftr") == before  # stable while nothing changes
    _append(csrc / "hopper.cuh", "\n// a changed comment still rebuilds\n")
    assert build.library_path("fused_loftr") != before


def test_unrelated_change_keeps_the_digest(csrc):
    before = {name: build.library_path(name) for name in build.SOURCES}
    _append(csrc / "dwconv.cu", "\n// changed\n")
    (csrc / "unused.cuh").write_text("// included by nothing\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    assert after["fused_loftr"] == before["fused_loftr"]
    assert after["linear_attention"] == before["linear_attention"]
    assert after["dwconv"] != before["dwconv"]
    # dwconv includes no header of csrc/; linear attention includes hopper.cuh
    _append(csrc / "hopper.cuh", "\n// changed\n")
    assert build.library_path("dwconv") == after["dwconv"]
    assert build.library_path("linear_attention") != after["linear_attention"]
