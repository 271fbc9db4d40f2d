"""The fused LoFTR layer's launch plan (``kernels/fused_loftr.py::
launch_plan``) on the CPU: at every shape of the bs=1 and bs=8 eval forwards
and of the bs=16 train step, in f32 and bf16, each plan fits the card's
shared memory, puts whole heads in each block's columns, walks every row
tile once and every (group, head group) pair of the summary once, and
chooses its tile height by its rule; what the kernel does not take, it
refuses with the reason. And ``chip_smoke.ptxas_report``, which the build
line's spill check reads. No card needed."""

import math

import pytest
import torch

from chip_smoke import main_path_shapes, production_config, ptxas_report
from cfpnet_torch.evaluate_time import train_config
from cfpnet_torch.kernels import fused_loftr
from cfpnet_torch.kernels.dwconv import SMEM_PER_BLOCK, SMEM_PER_SM, SMEM_RESERVED
from cfpnet_torch.models.deltar import model_geometries


def _production_shapes():
    config = production_config()
    geoms = model_geometries(config, "online_eval")
    shapes = {s for batch in (1, 8) for s in main_path_shapes(config, geoms, batch)[2]}
    tconfig = train_config(config)
    shapes |= set(main_path_shapes(tconfig, model_geometries(tconfig, "train"), tconfig.bs,
                                   mode="train")[2])
    return sorted(shapes)


PRODUCTION = _production_shapes()
DTYPES = [torch.float32, torch.bfloat16]

# The bf16 kernel's card cases (tests/test_torch_port_cuda.py::
# test_fused_loftr_bf16_cases), (N, L, S, C, H): every (C, D) of the
# kernel, both tile heights at each C, a summary split over a cluster and
# none, summary blocks that walk several groups, ragged row counts.
BF16_CASES = [
    (3, 37, 5, 32, 8), (2, 15001, 3, 32, 4), (40, 50, 70, 32, 8), (600, 5, 3, 32, 4),
    (2, 4097, 130, 32, 8),
    (5, 1, 9, 64, 4), (7, 19, 1, 64, 8), (1, 9000, 40, 64, 8), (300, 7, 5, 64, 8),
    (13, 23, 17, 128, 8), (1, 17, 9, 128, 4), (3, 1111, 40, 128, 8), (2, 4097, 130, 128, 4),
    (9, 7, 3, 128, 8),
]


def _units_at(C, D, tm, cl, dtype):
    return fused_loftr._row_units(C, D, tm, cl, dtype)[2]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N,L,S,C,H", PRODUCTION)
def test_plan_fits_and_covers(N, L, S, C, H, dtype):
    p = fused_loftr.launch_plan(N, L, S, C, H, dtype)
    D = C // H
    assert p["smem"] <= SMEM_PER_BLOCK and p["sum_smem"] <= SMEM_PER_BLOCK
    assert p["blocks_per_sm"] >= 1
    assert p["blocks_per_sm"] * (p["smem"] + SMEM_RESERVED) <= SMEM_PER_SM
    # whole heads in each block's columns, the columns split over the cluster
    assert p["cols"] * p["cl"] == C and p["heads"] * D == p["cols"]
    # unit u of the grid walks the row tiles u, u + units, ...: each tile once
    tiles = p["tiles"]
    assert (tiles - 1) * p["tm"] < N * L <= tiles * p["tm"]
    walked = sorted(t for u in range(p["units"]) for t in range(u, tiles, p["units"]))
    assert walked == list(range(tiles))
    assert p["units"] == min(p["resident"], tiles) and p["grid"] == p["cl"] * p["units"]
    assert p["rounds"] == math.ceil(tiles / p["units"])
    # the height rule: the lowest height whose tiles fit one round of
    # resident clusters, else the height of several rounds
    cl, one_round, several = fused_loftr.ROW_TILES[dtype][C]
    fits = [h for h in one_round if math.ceil(N * L / h) <= _units_at(C, D, h, cl, dtype)]
    assert p["cl"] == cl and p["tm"] == (fits[0] if fits else several)
    assert p["rounds"] == 1 or not fits
    if dtype == torch.bfloat16:
        assert (p["tm"], p["cl"]) in fused_loftr.ROW_VARIANTS_BF16[C]
    # summary: every (group, head group) pair once
    hg = C // max(D, 16)
    split, blocks = p["sum_split"], p["sum_blocks"]
    assert (split > 1) == (N * hg < 64 and S > 16)
    assert 1 <= split <= 8 and blocks % (hg * split) == 0
    step = blocks // split // hg
    pairs = sorted((n, u % hg) for u in range(blocks // split) for n in range(u // hg, N, step))
    assert pairs == [(n, g) for n in range(N) for g in range(hg)]
    if split > 1 or dtype == torch.float32:
        assert blocks == N * hg * split
    else:
        assert blocks <= fused_loftr.SUM_BLOCKS + hg
        assert math.ceil(N / step) == p["sum_groups"]


def test_bf16_cases_cover_the_rule():
    """The card cases reach both tile heights at every C, a split summary and
    an unsplit one, summary blocks over several groups, and ragged tiles."""
    plans = [(c, fused_loftr.launch_plan(*c, torch.bfloat16)) for c in BF16_CASES]
    for C in fused_loftr.SUPPORTED_C:
        assert ({p["tm"] for c, p in plans if c[3] == C}
                == {tm for tm, _ in fused_loftr.ROW_VARIANTS_BF16[C]})
        assert {c[3] // c[4] for c, p in plans if c[3] == C} == {C // 4, C // 8}
        assert any(c[0] * c[1] % p["tm"] for c, p in plans if c[3] == C)  # a ragged last tile
    assert any(p["sum_split"] > 1 for _, p in plans)
    assert any(p["sum_split"] == 1 and p["sum_groups"] == 1 for _, p in plans)
    assert any(p["sum_groups"] > 1 for _, p in plans)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_refuses_what_the_kernel_does_not_take(dtype):
    with pytest.raises(ValueError, match="C=48"):
        fused_loftr.launch_plan(2, 8, 5, 48, 4, dtype)
    with pytest.raises(ValueError, match="2 heads"):
        fused_loftr.launch_plan(2, 8, 5, 32, 2, dtype)
    with pytest.raises(ValueError, match="empty"):
        fused_loftr.launch_plan(2, 0, 5, 32, 4, dtype)
    with pytest.raises(TypeError):
        fused_loftr.launch_plan(2, 8, 5, 32, 4, torch.float16)


def test_f32_row_smem_is_the_kernel_table():
    """csrc/fused_loftr.cu's table of shared bytes a block (less its 32
    bytes of static mbarriers): C = 128 at 48 rows, C = 64 at 32 | 64, C = 32
    at 64."""
    f32 = torch.float32
    assert fused_loftr.row_smem(128, 16, 48, 4, f32) == 231_968 - 32
    assert fused_loftr.row_smem(64, 8, 32, 1, f32) == 165_920 - 32
    assert fused_loftr.row_smem(64, 8, 64, 1, f32) == 199_712 - 32
    assert fused_loftr.row_smem(32, 4, 64, 1, f32) == 68_640 - 32
    assert fused_loftr.summary_smem(128, 32, f32) == 91_392


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__f9cf5a5b_19_fused_loftr_bf16_cu_4887f40d16bf16_rows_kernelILi128ELi16ELi32ELi2EEEvPK13__nv_bfloat16PKf14CUtensorMap_stS6_S6_S6_S3_S3_S3_S3_PS1_iiif' for 'sm_90a'
ptxas info    : Function properties for _ZN52_GLOBAL__N__f9cf5a5b_19_fused_loftr_bf16_cu_4887f40d16bf16_rows_kernelILi128ELi16ELi32ELi2EEEvPK13__nv_bfloat16PKf14CUtensorMap_stS6_S6_S6_S3_S3_S3_S3_PS1_iiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 200 registers, used 1 barriers, 32 bytes smem
ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__f9cf5a5b_19_fused_loftr_bf16_cu_4887f40d19bf16_summary_kernelILi64ELi8EEEvPK13__nv_bfloat16S3_S3_Pfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN52_GLOBAL__N__f9cf5a5b_19_fused_loftr_bf16_cu_4887f40d19bf16_summary_kernelILi64ELi8EEEvPK13__nv_bfloat16S3_S3_Pfiii
    32 bytes stack frame, 32 bytes spill stores, 40 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 32 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__4288fdec_9_dwconv_cu_9175ef5413dwconv_kernelI13__nv_bfloat16Li15ELi4ELi2ELi2ELi8ELi640ELi8EEEvPKT_S4_S4_PS2_iiiNS_4PlanE' for 'sm_90a'
ptxas info    : Function properties for _ZN41_GLOBAL__N__4288fdec_9_dwconv_cu_9175ef5413dwconv_kernelI13__nv_bfloat16Li15ELi4ELi2ELi2ELi8ELi640ELi8EEEvPKT_S4_S4_PS2_iiiNS_4PlanE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 10240 bytes smem
"""


def test_ptxas_report_reads_each_kernel():
    """Kernel names with their template arguments (a length prefix that
    shares digits with the hash before it, "5413dwconv_kernel"), registers,
    spills and static shared bytes, as nvcc -Xptxas -v prints them."""
    report = ptxas_report(PTXAS_LOG)
    assert report == [
        dict(kernel="bf16_rows_kernel<128,16,32,2>", registers=200, spill_stores=0,
             spill_loads=0, stack=0, smem=32),
        dict(kernel="bf16_summary_kernel<64,8>", registers=80, spill_stores=32,
             spill_loads=40, stack=32, smem=0),
        dict(kernel="dwconv_kernel<bf16,15,4,2,2,8,640,8>", registers=72, spill_stores=0,
             spill_loads=0, stack=0, smem=10240),
    ]
