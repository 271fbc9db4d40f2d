"""The linear-attention kernel's launch plan and order of sums, on the CPU.

``kernels/linear_attention.py::launch_plan`` chooses the head groups,
clusters, cluster sums, key tiles and slices of the summary pass and the
query tile and shared-memory pitch of the apply pass, which
``csrc/linear_attention.cu`` takes as arguments. So the plan is checked here
without a card, from the kernel's own block and thread maps: every key of
every head is summed by exactly one block, every KV and ksum entry is owned
by one item, every output is written by exactly one thread, the blocks fit
the card, the main-path grids take one round, and the apply pass's KV loads
reach distinct bank groups. A torch emulation of the kernel's order of sums
(key tiles, slices, cluster ranks, cluster sums) is held against the plain
version and against the TPU kernel itself, run in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import main_path_shapes, production_config
from cfpnet_torch.kernels import linear_attention as la
from cfpnet_torch.models.deltar import model_geometries
from cfpnet_torch.ops.attention import linear_attention as attention_plain
from cfpnet_tpu.ops.pallas_attention import linear_attention_pallas
from tests.torch_port_util import close, t

_CONFIG = production_config()
# the twelve attention shapes of the 480x640 forward (three called, nine
# inside the fused LoFTR layer)
MAIN_PATH = sorted(main_path_shapes(_CONFIG, model_geometries(_CONFIG, "online_eval"))[0])
CALLED = [s for s, n in sorted(main_path_shapes(
    _CONFIG, model_geometries(_CONFIG, "online_eval"))[0].items()) if n]
# the card tests' shapes
CARD = [(3, 37, 5, 4, 4), (2, 70, 300, 8, 8), (1, 129, 1000, 4, 16), (5, 3, 2, 4, 32),
        (1, 4097, 9001, 4, 8), (2, 4800, 12544, 4, 8), (1, 1, 1, 4, 8), (1, 1, 1, 4, 32)]


def _sum_blocks(N, S, H, D, plan):
    """(n, first head, heads, first key, keys, cluster rank, cluster sum g) of
    every summary block, as attention_sum_kernel derives them from
    blockIdx.x."""
    hb, hg, cl, g, chunk = (plan[k] for k in ("hb", "hg", "cl", "g", "chunk"))
    out = []
    for b in range(plan["sum_blocks"]):
        rank, cluster = b % cl, b // cl
        gi, unit = cluster % g, cluster // g
        n, h0 = unit // hg, unit % hg * hb
        s0 = min(S, (gi * cl + rank) * chunk)
        out.append((n, h0, min(hb, H - h0), s0, min(S, s0 + chunk) - s0, rank, gi))
    return out


def _items(D, plan):
    """(slice, head, d4, e4) of every summary thread that sums: the slices
    of an item are adjacent lanes of one warp."""
    per_head, w4 = (D // 4) ** 2, D // 4
    out = []
    for tid in range(plan["sum_threads"]):
        slice_, item = tid % plan["slices"], tid // plan["slices"]
        if item < plan["items"]:
            assert tid // 32 == (tid - slice_) // 32  # the butterfly stays in a warp
            out.append((slice_, item // per_head, item % per_head // w4, item % w4))
    return out


@pytest.mark.parametrize("shape", MAIN_PATH + CARD)
def test_plan_covers_every_key_and_query_once(shape):
    N, L, S, H, D = shape
    plan = la.launch_plan(*shape)
    assert plan["sum_blocks"] == N * plan["hg"] * plan["g"] * plan["cl"]
    keys = np.zeros((N, S, H), np.int32)
    for n, h0, heads, s0, rows, _, _ in _sum_blocks(N, S, H, D, plan):
        assert rows >= 0 and heads >= 1
        keys[n, s0:s0 + rows, h0:h0 + heads] += 1
    assert (keys == 1).all()
    # every KV entry and ksum entry of a head from one item, every key row of
    # a tile to one slice
    kv = np.zeros((plan["hb"], D, D), np.int32)
    ksum = np.zeros((plan["hb"], D), np.int32)
    for s, h, d4, e4 in _items(D, plan):
        if s == 0:
            kv[h, 4 * d4:4 * d4 + 4, 4 * e4:4 * e4 + 4] += 1
            if e4 == 0:
                ksum[h, 4 * d4:4 * d4 + 4] += 1
    assert (kv == 1).all() and (ksum == 1).all()
    assert {s for s, *_ in _items(D, plan)} == set(range(plan["slices"]))
    # every output from one apply thread: (row, head, outputs 4w + 4W i .. + 3)
    eo, tl = plan["eo"], plan["tl"]
    W, tpr = D // eo, H * D // eo
    outs = np.zeros((N, L, H, D), np.int32)
    tid = np.arange(plan["apply_threads"])
    row, j = tid // tpr, tid % tpr
    hh, w = j // W, j % W
    for bx in range(-(-L // tl)):
        l = bx * tl + row
        ok = (row < tl) & (l < L)
        for i in range(eo // 4):
            for c in range(4):
                for n in range(N):
                    np.add.at(outs, (n, l[ok], hh[ok], (4 * w + 4 * W * i + c)[ok]), 1)
    assert (outs == 1).all()
    assert plan["apply_blocks"] == -(-L // tl) * N


@pytest.mark.parametrize("shape", MAIN_PATH + CARD)
def test_plan_fits_the_card(shape):
    N, L, S, H, D = shape
    plan = la.launch_plan(*shape)
    P = D * D + D
    assert la.SMEM_PER_BLOCK == 232_448
    assert 1 <= plan["cl"] <= la.CLUSTER_MAX <= 16  # the H100's largest cluster
    assert plan["sum_threads"] % 32 == 0 and plan["apply_threads"] % 32 == 0
    assert plan["slices"] * plan["items"] <= plan["sum_threads"] <= la.sum_max_threads(D)
    assert plan["apply_threads"] <= la.apply_max_threads(D)
    R = plan["slices"]
    assert R & (R - 1) == 0 and R <= 32 and plan["items"] * R <= plan["sum_threads"]
    assert plan["hb"] * D // 4 <= plan["sum_threads"]  # a thread a float4 of a key row
    assert plan["kpitch"] == plan["hb"] * D + (4 if R > 1 else 0)
    cl = plan["cl"]
    part = 4 * cl * -(-plan["hb"] * P // 4 // cl) if cl > 1 else 0
    assert part == 0 or part >= plan["hb"] * P
    assert plan["sum_smem"] == 4 * (2 * plan["tk"] * plan["kpitch"] + part) <= la.SMEM_PER_BLOCK
    staged = 4 * plan["g"] * H * P if plan["g"] > 1 else 0  # the cluster sums, loaded at once
    assert plan["apply_smem"] == 4 * H * plan["pitch"] + staged <= la.SMEM_PER_BLOCK
    assert plan["pitch"] >= P and plan["pitch"] % 4 == 0
    assert 1 <= plan["tk"] <= plan["chunk"] or S == 0
    assert plan["g"] == 1 or plan["g"] * H * P <= la.APPLY_SUM_FLOATS
    assert plan["sums_floats"] == N * plan["g"] * H * P


@pytest.mark.parametrize("shape", CALLED)
def test_main_path_grids_take_one_round(shape):
    """Both passes resident at once, the apply grid on at least 90% of the
    SMs with the busiest SM at one block, and the summary spread over more
    than one cluster where the keys are many."""
    plan = la.launch_plan(*shape)
    assert plan["sum_blocks"] <= la.SMS and plan["sum_waves"] <= 1.0
    assert plan["apply_waves"] <= 1.0
    assert 0.9 * la.SMS <= plan["apply_blocks"] <= la.SMS
    assert plan["sum_blocks"] >= 16 and plan["cl"] == la.cluster_max(shape[-1])
    assert plan["chunk"] <= 128


def test_many_keys_take_several_cluster_sums():
    """The 1/4 call and a two-row call with as many keys spread the keys over
    G > 1 clusters; few keys take one block a row."""
    assert la.launch_plan(1, 19200, 12544, 4, 8)["g"] > 1
    assert la.launch_plan(2, 4800, 12544, 4, 8)["g"] > 1
    for shape in [(140, 144, 144, 8, 4), (5, 3, 2, 4, 32), (64, 16, 16, 4, 32)]:
        plan = la.launch_plan(*shape)
        assert plan["cl"] == plan["g"] == 1


@pytest.mark.parametrize("shape", MAIN_PATH + CARD)
def test_apply_kv_loads_take_fewest_wavefronts(shape):
    """Each float4 load of KV in the apply pass, warp by warp, reaches as
    many distinct bank groups (16-byte slots mod 8) as it can: its distinct
    addresses need ceil(distinct / 8) wavefronts, and no more."""
    N, L, S, H, D = shape
    plan = la.launch_plan(*shape)
    eo = plan["eo"]
    W, tpr = D // eo, H * D // eo
    tid = np.arange(plan["apply_threads"])
    row, j = tid // tpr, tid % tpr
    hh, w = j // W, j % W
    active = row < plan["tl"]
    for d in range(D):
        for i in range(eo // 4):
            addr = hh * plan["pitch"] + d * D + 4 * w + 4 * W * i
            assert (addr % 4 == 0).all()
            for q in range(0, len(tid), 32):
                a = np.unique(addr[q:q + 32][active[q:q + 32]])
                if len(a) == 0:
                    continue
                per_group = np.bincount((a // 4) % 8, minlength=8)
                assert per_group.max() == -(-len(a) // 8), (d, i, q)


def _elu1(x):
    return torch.where(x > 0, x + 1, torch.exp(x))


def emulate(q, k, v, eps=1e-6):
    """csrc/linear_attention.cu's arithmetic in torch, in its order of sums:
    each slice of a summary block adds its key rows in tile order; a block
    adds its slices pairwise (the butterfly over their lanes), a cluster its
    ranks in order, and the apply pass the g cluster sums in order; then den
    and the outputs over d in order."""
    N, L, H, D = q.shape
    S = k.shape[1]
    plan = la.launch_plan(N, L, S, H, D)
    kf, vs = _elu1(k), v / S
    R, tk = plan["slices"], plan["tk"]
    sums = torch.zeros(N, plan["g"], H, D * D + D, dtype=q.dtype)
    blocks = {}
    for n, h0, heads, s0, rows, rank, gi in _sum_blocks(N, S, H, D, plan):
        hs = slice(h0, h0 + heads)
        kv = torch.zeros(R, heads, D, D, dtype=q.dtype)
        ks = torch.zeros(R, heads, D, dtype=q.dtype)
        for t0 in range(0, rows, tk):
            for r0 in range(0, min(tk, rows - t0), R):
                for s in range(min(R, rows - t0 - r0)):
                    key = s0 + t0 + r0 + s
                    kv[s] += kf[n, key, hs, :, None] * vs[n, key, hs, None, :]
                    ks[s] += kf[n, key, hs]
        part = torch.cat([kv.reshape(R, heads, D * D), ks], dim=-1)
        while part.shape[0] > 1:
            part = part[0::2] + part[1::2]
        blocks[(n, h0, gi, rank)] = part[0]
    for (n, h0, gi, rank), part in sorted(blocks.items()):
        if rank == 0:
            total = part.clone()
            for r in range(1, plan["cl"]):
                total += blocks[(n, h0, gi, r)]
            sums[n, gi, h0:h0 + part.shape[0]] = total
    kvs = sums[:, 0].clone()
    for gi in range(1, plan["g"]):
        kvs += sums[:, gi]
    KV = kvs[..., :D * D].reshape(N, 1, H, D, D)
    ksum = kvs[..., D * D:].reshape(N, 1, H, D)
    qf = _elu1(q)
    den = torch.zeros(N, L, H, dtype=q.dtype)
    acc = torch.zeros(N, L, H, D, dtype=q.dtype)
    for d in range(D):
        den = den + qf[..., d] * ksum[..., d]
        acc = acc + qf[..., d, None] * KV[..., d, :]
    return acc * ((1.0 / (den + eps)) * S)[..., None]


def _qkv(shape, seed, dtype=np.float32):
    N, L, S, H, D = shape
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((N, n, H, D)).astype(dtype) for n in (L, S, S))


# small shapes that take every form of the plan: slices > 1 (D = 4, 8, 16 and
# the 512-thread D = 32), clusters, several cluster sums, ragged tiles and
# chunks, a last cluster with empty blocks, more heads than a block holds
EMULATED = [(2, 37, 300, 4, 8), (1, 20, 200, 4, 32), (1, 33, 700, 4, 16), (3, 17, 50, 8, 4),
            (1, 9, 1000, 8, 8), (2, 5, 3, 8, 32), (1, 6, 77, 2, 16)]


@pytest.mark.parametrize("shape", EMULATED)
def test_emulated_order_of_sums_matches_plain(shape):
    """f32: the kernel's order of sums against the plain version (einsum
    order); the two differ by the rounding of sums of up to S terms."""
    plan = la.launch_plan(*shape)
    q, k, v = (t(a) for a in _qkv(shape, seed=sum(shape)))
    got = emulate(q, k, v)
    ref = attention_plain(q, k, v)
    assert got.dtype == torch.float32
    err = float((got - ref).abs().max())
    assert err <= 2e-6 * float(ref.abs().max()), (err, dict(plan))
    ref64 = attention_plain(q.double(), k.double(), v.double())
    assert float((got.double() - ref64).abs().max()) <= 2e-6 * float(ref64.abs().max())


@pytest.mark.parametrize("shape", [(2, 16, 40, 4, 4), (1, 24, 96, 4, 8), (2, 8, 48, 4, 16),
                                   (1, 12, 33, 4, 32)])
def test_emulated_order_of_sums_matches_pallas_interpret(shape):
    """The TPU kernel itself, in interpret mode, against the emulation, f32."""
    N, L, S, H, D = shape
    q, k, v = _qkv(shape, seed=7 + D)
    flat = [jnp.asarray(a.reshape(a.shape[0], a.shape[1], H * D)) for a in (q, k, v)]
    ref = np.asarray(linear_attention_pallas(*flat, nhead=H, interpret=True)).reshape(N, L, H, D)
    got = emulate(t(q), t(k), t(v)).numpy()
    close(got, ref, rtol=2e-5, atol=1e-6)
