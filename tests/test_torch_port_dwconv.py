"""The depthwise-conv kernel's launch plan and plain version, on the CPU.

``kernels/dwconv.py::launch_plan`` chooses the tile, channels a block and
shared-memory pitches that ``csrc/dwconv.cu`` takes as arguments, so the
plan is checked here without a card: every output is owned by exactly one
thread of one block, the shared memory fits a block, the main-path grids
are one round over the 132 SMs, and the window loads of every quarter warp
reach 8 distinct bank groups (recomputed from the kernel's thread map, not
from the plan's own helper). The plain version is held against the TPU
kernel itself, run in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cfpnet_torch.kernels import build, dwconv
from cfpnet_torch.ops.dwconv import depthwise_conv2d as port_dwconv
from cfpnet_tpu.ops.pallas_dwconv import depthwise_conv2d_pallas
from tests.torch_port_util import close, t

MAIN_PATH = [(1, 120, 160, 32, 31), (1, 60, 80, 64, 15), (1, 30, 40, 128, 7)]
RAGGED = [(2, 17, 33, 12, 15), (1, 5, 70, 32, 31), (1, 61, 83, 36, 15), (2, 120, 160, 32, 31),
          (3, 7, 9, 4, 7), (1, 31, 41, 132, 7), (1, 1, 1, 8, 31)]


def _owners(B, H, W, C, k, plan):
    """How many times the kernel writes each output, block by block and
    thread by thread as csrc/dwconv.cu maps them: thread t is (lx, ly, cc) =
    (t % 4, t // 4 % ty, t // (4 ty)) modulo 4 ty cb, and owns ry rows x rx
    columns; with two splits of the kernel columns, the first split's
    threads write the sums."""
    rx, ry, ty, cb = plan["rx"], plan["ry"], plan["ty"], plan["cb"]
    th, tw = plan["tile"]
    tiles, cgroups, batch = plan["grid"]
    tiles_x = -(-W // tw)
    assert (th, tw) == (ty * ry, 4 * rx) and tiles == tiles_x * -(-H // th) and batch == B
    count = np.zeros((B, H, W, C), np.int32)
    tid = np.arange(plan["threads"] // plan["ns"])
    lx, ly, cc = tid % 4, tid // 4 % ty, tid // (4 * ty)
    for bz in range(batch):
        for by in range(cgroups):
            for bx in range(tiles):
                ty0, tx0, c0 = bx // tiles_x * th, bx % tiles_x * tw, by * cb
                for oy in range(ry):
                    for i in range(rx):
                        y, x, c = ty0 + ly * ry + oy, tx0 + lx * rx + i, c0 + cc
                        ok = (y < H) & (x < W) & (c < C)
                        np.add.at(count, (bz, y[ok], x[ok], c[ok]), 1)
    return count


@pytest.mark.parametrize("shape", MAIN_PATH + RAGGED)
def test_plan_covers_every_output_once(shape):
    plan = dwconv.launch_plan(*shape)
    assert (_owners(*shape, plan) == 1).all()
    assert plan["blocks"] == np.prod(plan["grid"])


@pytest.mark.parametrize("shape", MAIN_PATH + RAGGED)
def test_plan_fits_a_block(shape):
    plan = dwconv.launch_plan(*shape)
    rx, ry, ty, cb = plan["rx"], plan["ry"], plan["ty"], plan["cb"]
    k = shape[-1]
    th, tw = plan["tile"]
    assert plan["smem_bytes"] == 4 * cb * (plan["plane"] + plan["wplane"]) <= dwconv.SMEM_PER_BLOCK
    assert dwconv.SMEM_PER_BLOCK == 232_448
    assert plan["threads"] == plan["ns"] * 4 * ty * cb <= 640
    assert (plan["threads"] // plan["ns"]) % 32 == 0  # a warp works on one split
    assert ty % 2 == 0 and cb >= 4 and cb & (cb - 1) == 0
    # every row's data and every thread's float4 window fit the pitch; the
    # shifted rows stay inside their plane; the output tile fits the planes
    ends = [3 * rx + d0 + -(-(rx + n - 1) // 4) * 4 for d0, n in dwconv.splits(k, plan["ns"])]
    assert plan["pitch"] >= max(ends + [tw + k - 1]) + plan["swz"]
    assert plan["plane"] >= (th + k - 1) * plan["pitch"] + plan["swz"]
    assert plan["plane"] >= th * tw + 4 and plan["plane"] % 4 == 0
    assert plan["wplane"] >= k * (-(-k // 4) * 4) and plan["wplane"] % 4 == 0


@pytest.mark.parametrize("shape", MAIN_PATH)
def test_main_path_grid_is_one_round(shape):
    """All blocks resident at once; the busiest SM's warps a multiple of 4,
    so that its four schedulers get equal shares; at least 90% of the
    busiest SM's work on the average SM; little work outside the map."""
    plan = dwconv.launch_plan(*shape)
    assert plan["blocks"] <= dwconv.SMS * plan["blocks_per_sm"]
    assert plan["waves"] <= 1.0
    assert (-(-plan["blocks"] // dwconv.SMS) * plan["threads"] // 32) % 4 == 0
    assert plan["balance"] >= 0.9
    assert plan["useful"] >= 0.8


@pytest.mark.parametrize("shape", MAIN_PATH + RAGGED)
def test_window_loads_are_conflict_free(shape):
    """Each quarter warp (8 lanes) of every warp, at every tap iteration,
    reads its float4 windows from 8 distinct bank groups (16-byte slots mod
    8), from the kernel's own address arithmetic."""
    plan = dwconv.launch_plan(*shape)
    rx, ry, ty, k = plan["rx"], plan["ry"], plan["ty"], shape[-1]
    pitch, swz, plane = plan["pitch"], plan["swz"], plan["plane"]
    tid = np.arange(plan["threads"])
    tl, split = tid % (plan["threads"] // plan["ns"]), tid // (plan["threads"] // plan["ns"])
    lx, ly, cc = tl % 4, tl // 4 % ty, tl // (4 * ty)
    d0 = np.array([d for d, _ in dwconv.splits(k, plan["ns"])])[split]
    for r in range(ry + k - 1):
        row = ly * ry + r
        start = cc * plane + row * pitch + (row // ry % 2) * swz + lx * rx + d0
        assert (start % 4 == 0).all()
        groups = (start // 4) % 8
        for q in range(0, len(tid), 8):
            assert len(set(groups[q:q + 8])) == 8, (r, q)
    assert dwconv.conflict_free(rx, ry, pitch, swz)


def test_tiling_reaches_the_build(monkeypatch):
    """The compile-time part of each k's tiling goes to nvcc as one -D a
    value, and a changed tiling names another library, so a stale build is
    never loaded."""
    flags = build.nvcc_flags("dwconv")
    assert flags[:len(build.NVCC_FLAGS)] == build.NVCC_FLAGS
    for k, t in dwconv.TILING.items():
        d = dwconv.split_column(k, t.ns)
        assert t.ns * 4 * t.ty * t.cb <= t.max_threads
        for name, value in (("RX", t.rx), ("RY", t.ry), ("NS", t.ns), ("D", d),
                            ("MAXT", t.max_threads), ("F4", t.f4)):
            assert f"-DCFP_DWCONV_{name}_{k}={value}" in flags
    assert not any("," in flag for flag in dwconv.nvcc_defines())
    assert build.nvcc_flags("fused_loftr") == build.NVCC_FLAGS
    before = {name: build.library_path(name) for name in build.SOURCES}
    monkeypatch.setitem(dwconv.TILING, 31, dwconv.TILING[31]._replace(f4=8))
    after = {name: build.library_path(name) for name in build.SOURCES}
    assert after["dwconv"] != before["dwconv"]
    assert after["fused_loftr"] == before["fused_loftr"]
    assert after["linear_attention"] == before["linear_attention"]


def test_conflict_free_arithmetic():
    """The bank-group rule itself: at RX=8 an even RY needs the shift of
    alternate row bands, an odd RY an odd pitch/4; at RX=4, RY*pitch/4 = 4
    mod 8."""
    assert not dwconv.conflict_free(8, 2, 68, 0)
    assert dwconv.conflict_free(8, 2, 68, 4)
    assert dwconv.conflict_free(8, 1, 68, 0) and not dwconv.conflict_free(8, 1, 64, 0)
    assert dwconv.conflict_free(4, 2, 40, 0) and not dwconv.conflict_free(4, 2, 32, 0)
    assert dwconv.conflict_free(4, 1, 48, 0) and not dwconv.conflict_free(4, 1, 40, 0)


@pytest.mark.parametrize("k", [7, 15, 31])
def test_dwconv_matches_pallas_interpret(k):
    """The plain version against the TPU kernel itself (interpret mode), f32,
    1x20x24x8. Both add the taps in (dy, dx) order and the bias last; what
    differs is XLA's contraction of the multiply-adds, so the tolerance is
    a few f32 ulps of outputs of size ~3."""
    rng = np.random.default_rng(100 + k)
    x = rng.standard_normal((1, 20, 24, 8)).astype(np.float32)
    w_hwio = (0.1 * rng.standard_normal((k, k, 1, 8))).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    ref = np.asarray(depthwise_conv2d_pallas(jnp.asarray(x), jnp.asarray(w_hwio),
                                             jnp.asarray(b), interpret=True))
    got = port_dwconv(t(x), t(np.ascontiguousarray(np.transpose(w_hwio, (3, 2, 0, 1)))),
                      t(b)).numpy()
    assert got.dtype == np.float32
    close(got, ref, rtol=1e-5, atol=1e-5)
