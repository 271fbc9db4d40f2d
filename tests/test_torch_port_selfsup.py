"""The port's self-supervised variant against the JAX package on the CPU:
each function of ``ops/warp.py`` (values and gradients), PoseNet loaded
through the weight bridge, ``zone_mean_depth``, the pair datasets bit for
bit, the joint optimizer's labels, one and two joint steps (the four loss
terms, every gradient leaf of depth and pose, the parameters and running
statistics after each step, with and without the clip), the pose-recovery
property, and the entry point. float64 unless a test says otherwise; rtol
1e-7. Crop offsets are pinned as in ``test_torch_port_train.py``
(``RecordedOffsets``).

    python tests/test_torch_port_selfsup.py              write the golden
    python tests/test_torch_port_selfsup.py --tolerance  SELFSUP_GOLDEN_TOL

The first writes ``tests/golden/torch_port_selfsup_step.npz``, the JAX
package's self-supervised production step at bs 2 in float64
(``write_selfsup_golden``), which ``chip_smoke.py`` holds the card
against; the second prints the float32 errors on the CPU that set
``chip_smoke.SELFSUP_GOLDEN_TOL``.
"""

import contextlib
import json
import os
import sys

if __name__ == "__main__":  # the golden writer runs JAX on the CPU, in float64
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cfpnet_torch import weights
from cfpnet_torch.config import Config as PtConfig
from cfpnet_torch.data import datasets as pt_ds
from cfpnet_torch.data import pipeline as pt_pipe
from cfpnet_torch.data.geometry import geometry_for as pt_geometry_for
from cfpnet_torch.models.deltar import make_model as pt_make_model
from cfpnet_torch.models.posenet import PoseNet as PtPoseNet
from cfpnet_torch.ops import warp as pt_warp
from cfpnet_torch.train import loop as pt_loop
from cfpnet_torch.train import optim as pt_optim
from cfpnet_torch.train import selfsup as pt_selfsup
from cfpnet_torch.train.__main__ import main as pt_train_main
from cfpnet_tpu.config import Config as JxConfig
from cfpnet_tpu.data import datasets as jx_ds
from cfpnet_tpu.data import pipeline as jx_pipe
from cfpnet_tpu.data.geometry import geometry_for as jx_geometry_for
from cfpnet_tpu.models.deltar import make_model as jx_make_model
from cfpnet_tpu.models.deltar import model_geometries
from cfpnet_tpu.models.posenet import PoseNet as JxPoseNet
from cfpnet_tpu.ops import warp as jx_warp
from cfpnet_tpu.train import optim as jx_optim
from cfpnet_tpu.train import selfsup as jx_selfsup
from tests.test_torch_port_data import assert_same_sample
from tests.test_torch_port_loop import ENTRY
from tests.test_torch_port_train import TINY, RecordedOffsets
from tests.torch_port_util import close, enable_x64, random_tree, t

SELFSUP = dict(TINY, selfsup=True, dataset="synthetic")


def _grads(fn, *args):
    """Values and gradients of a scalar torch function of float64 arrays."""
    xs = [t(a).clone().requires_grad_() for a in args]
    out = fn(*xs)
    out.backward()
    return out.detach().numpy(), [x.grad.numpy() for x in xs]


def _jx_grads(fn, *args):
    with enable_x64():
        out, g = jax.jit(jax.value_and_grad(fn, argnums=tuple(range(len(args)))))(
            *[jnp.asarray(a) for a in args])
        return np.asarray(out), [np.asarray(x) for x in g]


def jx_x64(fn, *args):
    """A JAX function of numpy arrays, run in float64, as numpy."""
    with enable_x64():
        out = jax.jit(fn)(*[jnp.asarray(a) for a in args])
        return jax.tree_util.tree_map(np.asarray, out)


# ---- ops/warp.py ---------------------------------------------------------------

@pytest.mark.parametrize("scale", [0.0, 1e-9, 0.3])
def test_axis_angle_and_pose_to_transform_match_jax_f64(scale):
    """Rodrigues and the SE(3) matrix, with gradients of a weighted sum, at
    a zero pose (the smoothed norm: a finite gradient), a tiny one and a
    large one."""
    rng = np.random.default_rng(1)
    aa = scale * rng.standard_normal((3, 3))
    tt = rng.standard_normal((3, 3))
    w = rng.standard_normal((3, 4, 4))
    close(pt_warp.axis_angle_to_matrix(t(aa)).numpy(), jx_x64(jx_warp.axis_angle_to_matrix, aa))
    got, g = _grads(lambda a, b: (pt_warp.pose_to_transform(a, b) * t(w)).sum(), aa, tt)
    ref, rg = _jx_grads(lambda a, b: (jx_warp.pose_to_transform(a, b) * w).sum(), aa, tt)
    close(got, ref)
    for a, b in zip(g, rg):
        assert np.isfinite(a).all()
        close(a, b)


def _camera(B=2, H=12, W=16, seed=2):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(1.0, 3.0, (B, H, W, 1))
    K = np.stack([np.array([[20.0 + b, 0, W / 2], [0, 21.0 - b, H / 2], [0, 0, 1]])
                  for b in range(B)])
    return rng, depth, K, np.linalg.inv(K)


def test_backproject_and_project_match_jax_f64():
    rng, depth, K, K_inv = _camera()
    T = jx_x64(jx_warp.pose_to_transform, 0.05 * rng.standard_normal((2, 3)),
               0.1 * rng.standard_normal((2, 3)))
    pts = pt_warp.backproject(t(depth), t(K_inv)).numpy()
    close(pts, jx_x64(jx_warp.backproject, depth, K_inv))
    # a point behind the camera meets the z clip at 1e-3
    pts[0, 0, 0, 2] = -1.0
    close(pt_warp.project(t(pts), t(K), t(T)).numpy(), jx_x64(jx_warp.project, pts, K, T))


@pytest.mark.parametrize("where", ["generic", "integer", "outside"])
def test_grid_sample_matches_jax_f64(where):
    """Values, mask and the gradients w.r.t. the image and the coordinates:
    at generic coordinates, at integer ones (where the weight's clip ties
    and JAX splits the gradient) and partly outside the image."""
    rng = np.random.default_rng(3)
    B, H, W, C = 2, 7, 9, 3
    img = rng.random((B, H, W, C))
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64),
                         indexing="ij")
    base = np.broadcast_to(np.stack([xs, ys], -1), (B, H, W, 2))
    coords = {"generic": base + rng.uniform(-0.45, 0.45, base.shape),
              "integer": base + rng.integers(-1, 2, base.shape),
              "outside": base * 1.3 - 1.5 + rng.uniform(-0.3, 0.3, base.shape)}[where]
    w = rng.standard_normal((B, H, W, C))
    out, valid = pt_warp.grid_sample(t(img), t(coords))
    ref_out, ref_valid = jx_x64(jx_warp.grid_sample, img, coords)
    close(out.numpy(), ref_out)
    np.testing.assert_array_equal(valid.numpy(), ref_valid)
    got, g = _grads(lambda i, c: (pt_warp.grid_sample(i, c)[0] * t(w)).sum(), img, coords)
    ref, rg = _jx_grads(lambda i, c: (jx_warp.grid_sample(i, c)[0] * w).sum(), img, coords)
    close(got, ref)
    for a, b in zip(g, rg):
        close(a, b)
    if where == "integer":  # the tie: half the gradient, as jnp.clip
        assert np.any(np.isclose(np.abs(rg[1]), 0.5 * np.abs(rg[1]).max(), rtol=0.5))


def test_warp_frame_matches_jax_f64():
    """The warped frame and mask, and the gradients of a photometric
    objective w.r.t. the source image, the depth, the axis-angle and the
    translation."""
    rng, depth, K, K_inv = _camera()
    src = rng.random((2, 12, 16, 3))
    target = rng.random((2, 12, 16, 3))
    aa, tt = 0.02 * rng.standard_normal((2, 3)), 0.05 * rng.standard_normal((2, 3))
    T = jx_x64(jx_warp.pose_to_transform, aa, tt)
    warped, valid = pt_warp.warp_frame(t(src), t(depth), t(K), t(K_inv), t(T))
    ref_w, ref_v = jx_x64(jx_warp.warp_frame, src, depth, K, K_inv, T)
    close(warped.numpy(), ref_w)
    np.testing.assert_array_equal(valid.numpy(), ref_v)
    assert 0 < ref_v.mean() < 1

    def pt_objective(src_, depth_, aa_, tt_):
        w, v = pt_warp.warp_frame(src_, depth_, t(K), t(K_inv),
                                  pt_warp.pose_to_transform(aa_, tt_))
        return (torch.abs(w - t(target)) * v).mean()

    def jx_objective(src_, depth_, aa_, tt_):
        w, v = jx_warp.warp_frame(src_, depth_, K, K_inv, jx_warp.pose_to_transform(aa_, tt_))
        return (jnp.abs(w - target) * v).mean()

    got, g = _grads(pt_objective, src, depth, aa, tt)
    ref, rg = _jx_grads(jx_objective, src, depth, aa, tt)
    close(got, ref)
    for name, a, b in zip(("src", "depth", "axisangle", "translation"), g, rg):
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("fn", ["ssim", "photometric_loss", "smoothness_loss"])
def test_photometric_terms_match_jax_f64(fn):
    """SSIM (reflect padding), the photometric loss and the edge-aware
    smoothness, with gradients w.r.t. both inputs, on odd-sized frames."""
    rng = np.random.default_rng(4)
    x = rng.random((2, 9, 11, 3))
    y = np.clip(x + 0.2 * rng.standard_normal(x.shape), 0, 1)
    if fn == "smoothness_loss":
        x = rng.uniform(0.5, 3.0, (2, 9, 11, 1))
    pt_fn, jx_fn = getattr(pt_warp, fn), getattr(jx_warp, fn)
    close(pt_fn(t(x), t(y)).numpy(), jx_x64(jx_fn, x, y))
    w = np.asarray(rng.standard_normal(np.shape(jx_x64(jx_fn, x, y))))
    got, g = _grads(lambda a, b: (pt_fn(a, b) * t(w)).sum(), x, y)
    ref, rg = _jx_grads(lambda a, b: (jx_fn(a, b) * w).sum(), x, y)
    close(got, ref)
    for a, b in zip(g, rg):
        close(a, b)
    if fn == "ssim":
        assert np.abs(pt_warp.ssim(t(x), t(x)).numpy()).max() < 1e-12


def test_pose_optimization_recovers_known_translation():
    """``tests/test_selfsup.py``'s property through the port: a source
    frame made by a known 3-px camera translation is recovered by Adam on
    the translation through ``warp_frame`` and ``photometric_loss``, in
    sign and scale, the other axes near zero."""
    rng = np.random.default_rng(9)
    tex = rng.random((1, 64, 80, 3)).astype(np.float32)
    for _ in range(8):
        tex = (tex + np.roll(tex, 1, 1) + np.roll(tex, -1, 1)
               + np.roll(tex, 1, 2) + np.roll(tex, -1, 2)) / 5.0
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    target = torch.from_numpy(tex)
    z, fx = 2.0, 40.0
    depth = torch.full((1, 64, 80, 1), z)
    K = torch.tensor([[[fx, 0, 40], [0, fx, 32], [0, 0, 1]]])
    K_inv = torch.linalg.inv(K)
    tx_true = 0.15  # pixel shift fx * tx / z = 3 px
    src = torch.from_numpy(np.roll(tex, int(fx * tx_true / z), axis=2))

    def loss_fn(tr):
        T = pt_warp.pose_to_transform(torch.zeros((1, 3)), tr[None])
        warped, valid = pt_warp.warp_frame(src, depth, K, K_inv, T)
        err = pt_warp.photometric_loss(warped, target) * valid
        return err.sum() / (valid.sum() + 1e-6)

    tr = torch.zeros(3, requires_grad=True)
    with torch.no_grad():
        ident = float(loss_fn(tr))
    opt = torch.optim.Adam([tr], lr=2e-2)
    for _ in range(300):
        opt.zero_grad()
        loss = loss_fn(tr)
        loss.backward()
        opt.step()
    final, tr = float(loss.detach()), tr.detach().numpy()
    assert final < 0.05 * ident, (final, ident)
    assert tr[0] > 0 and abs(tr[0] - tx_true) < 0.1 * tx_true, tr
    assert abs(tr[1]) < 0.1 * tx_true and abs(tr[2]) < 0.1 * tx_true, tr


# ---- PoseNet ---------------------------------------------------------------------

def _pose_variables(seed, shape=(2, 50, 70, 3)):
    net = JxPoseNet()
    a = jnp.zeros(shape)
    with enable_x64():
        shapes = jax.eval_shape(lambda r: net.init(r, a, a), jax.random.key(0))
    return net, random_tree(shapes, seed, kernel_std=0.1)["params"]


def test_posenet_matches_flax_f64():
    """PoseNet loaded through ``weights.posenet_from_flax``, at 50x70 (odd
    and even sides: flax's SAME pads (1, 1) and (0, 1)), against flax; the
    bridge's spec lists flax's leaves and shapes."""
    net, params = _pose_variables(5)
    rng = np.random.default_rng(6)
    a, b = rng.random((2, 50, 70, 3)), rng.random((2, 50, 70, 3))
    port = PtPoseNet().double()
    port.load_state_dict(weights.posenet_from_flax(jax.tree_util.tree_map(np.asarray, params)),
                         strict=True)
    with enable_x64():
        ref = net.apply({"params": params}, jnp.asarray(a), jnp.asarray(b))
    got = port(t(a), t(b))
    for x, y in zip(got, ref):
        assert np.abs(np.asarray(y)).max() > 1e-4
        close(x.detach().numpy(), np.asarray(y))
    flat = {"/".join(k.key for k in path): v.shape
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert {"/".join(p): s for _, p, s in weights.posenet_param_spec()} == flat


def test_fresh_posenet_takes_flax_init():
    """A fresh PoseNet: zero head (identity pose), zero biases, conv kernels
    of variance 2 / (9 x width)."""
    torch.manual_seed(0)
    net = PtPoseNet()
    x = torch.rand(1, 32, 32, 3)
    aa, tt = net(x, x)
    assert not aa.any() and not tt.any()
    for i, w in enumerate(net.widths):
        conv = getattr(net, f"conv{i}")
        assert not conv.bias.any()
        if conv.weight.numel() > 20000:
            assert abs(conv.weight.std().item() / np.sqrt(2 / (9 * w)) - 1) < 0.05


# ---- zone means and pair datasets --------------------------------------------------

def test_zone_mean_depth_matches_jax_f64():
    cfg = PtConfig(**SELFSUP)
    rng = np.random.default_rng(7)
    d = rng.uniform(0.5, 5.0, (2, cfg.input_height, cfg.input_width, 1))
    got = pt_selfsup.zone_mean_depth(t(d), pt_geometry_for(cfg, "train")).numpy()
    ref = jx_x64(lambda x: jx_selfsup.zone_mean_depth(x, jx_geometry_for(JxConfig(**SELFSUP),
                                                                         "train")), d)
    assert got.shape == (2, cfg.train_zone_num ** 2)
    close(got, ref)


def test_synthetic_pairs_equal_jax_bit_for_bit():
    """Samples of both pair sets, and a batch of the port's train loader
    under ``--selfsup`` against the JAX loader's; under
    ``--train_zone_random_offset`` both leave the pairs at offset 0."""
    cfg = dict(SELFSUP, seed=3)
    pt_set = pt_ds.make_dataset(PtConfig(**cfg), "train")
    jx_set = jx_ds.make_dataset(JxConfig(**cfg), "train")
    assert isinstance(pt_set, pt_ds.SyntheticPairDataset) and len(pt_set) == len(jx_set) == 64
    for i in (0, 5, 63):
        assert_same_sample(pt_set[i], jx_set[i], f"pair {i}")
    moved = PtConfig(**cfg).replace(train_zone_random_offset=1)
    loader = pt_pipe.make_loader(moved, "train", device="cpu")
    jx_loader = jx_pipe.make_loader(JxConfig(**cfg).replace(train_zone_random_offset=1), "train")
    got, ref = next(iter(loader)), next(iter(jx_loader))
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    first = int(loader.indices[0])
    np.testing.assert_array_equal(got["hist_data"][0].numpy(), pt_set[first]["hist_data"])


def test_nyu_pairs_equal_jax_bit_for_bit(tmp_path):
    """NYU pairs from a fabricated tree (frames 0, 1, 2 and a lone frame 7):
    the next frame, the previous one at the end of a run, the target itself
    where it has no neighbour; centre crop, K shifted by the crop; the same
    samples as the JAX package's."""
    from PIL import Image

    rng = np.random.default_rng(3)
    scene = tmp_path / "sync" / "scene_a"
    scene.mkdir(parents=True)
    names = []
    for n in (0, 1, 2, 7):
        Image.fromarray((rng.random((480, 640, 3)) * 255).astype(np.uint8)).save(
            scene / f"rgb_{n:05d}.jpg")
        Image.fromarray(rng.uniform(500, 3900, (480, 640)).astype(np.uint16), mode="I;16").save(
            scene / f"sync_depth_{n:05d}.png")
        names.append({"filename": f"sync/scene_a/{n:05d}.h5"})
    split = tmp_path / "split.json"
    split.write_text(json.dumps({"train": names, "test": names}))
    kw = dict(data_path=str(tmp_path / "sync"), filenames_file=str(split), input_height=416,
              input_width=544, native_height=480, native_width=640, train_zone_num=6,
              train_patch_px=64, zone_sample_num=16, sample_uniform=True, drop_hist=0.34,
              noise_prob=0.3, noise_mean=0.17, noise_sigma=0.2, seed=11, selfsup=True,
              dataset="nyu")
    pt_set = pt_ds.make_dataset(PtConfig(**kw, device_pipeline=True), "train")
    jx_set = jx_ds.make_dataset(JxConfig(**kw), "train")
    assert isinstance(pt_set, pt_ds.NYUPairDataset)
    for i in range(4):  # the same generator draws, in order
        s, r = pt_set[i], jx_set[i]
        assert_same_sample(s, r, f"nyu pair {i}")
    # the pairs: frame 0 with frame 1, frame 2 with frame 1, frame 7 with itself
    def frame(n):  # the centre crop of 416x544 out of 480x640
        return np.asarray(Image.open(scene / f"rgb_{n:05d}.jpg"), np.float32)[32:448, 48:592] / 255.0

    np.testing.assert_array_equal(pt_set[0]["src_raw"], frame(1))
    np.testing.assert_array_equal(pt_set[2]["src_raw"], frame(1))
    np.testing.assert_array_equal(pt_set[3]["src_raw"], pt_set[3]["image_raw"])
    assert pt_set[0]["K"][0, 2] == pt_ds.NYU_K[2] - 48
    assert pt_set[0]["K"][1, 2] == pt_ds.NYU_K[3] - 32


def test_pair_dataset_refusals():
    """An unknown pair set raises as in the JAX package; synthetic pairs
    under ``--device_pipeline``, where the JAX set fails on a missing key,
    raise ``NotImplementedError`` naming the flag."""
    with pytest.raises(NotImplementedError, match="self-sup dataset 'zjuL5'"):
        pt_ds.make_dataset(PtConfig(**dict(SELFSUP, dataset="zjuL5")), "train")
    with pytest.raises(NotImplementedError, match="--device_pipeline"):
        pt_ds.make_dataset(PtConfig(**SELFSUP, device_pipeline=True), "train")
    jx_set = jx_ds.make_dataset(JxConfig(**SELFSUP, device_pipeline=True), "train")
    with pytest.raises(KeyError):
        jx_set[0]
    # the eval set is the plain one
    assert type(pt_ds.make_dataset(PtConfig(**SELFSUP, dataset_eval="synthetic"),
                                   "online_eval")) is pt_ds.SyntheticDataset


# ---- the joint step ----------------------------------------------------------------

@pytest.fixture(scope="module")
def joint():
    """The tiny depth model's and PoseNet's f64 variables, a pair batch,
    and the port's configuration."""
    cfg = JxConfig(**SELFSUP)
    pt_cfg = PtConfig(**SELFSUP)
    geoms = model_geometries(cfg, "train")
    batch = pt_ds.collate([pt_ds.SyntheticPairDataset(pt_cfg, "train")[i] for i in range(2)])
    model = jx_make_model(cfg, tiny=True)
    with enable_x64():
        shapes = jax.eval_shape(
            lambda r: model.init({"params": r, "fusion": r}, jnp.asarray(batch["image"]),
                                 jnp.asarray(batch["hist_data"]), jnp.asarray(batch["mask"]),
                                 geoms, train=True), jax.random.key(0))
        depth = random_tree(shapes, 3, kernel_std=0.05)
    _, pose = _pose_variables(8, batch["image_raw"].shape)
    return dict(cfg=cfg, pt_cfg=pt_cfg, geoms=geoms, model=model, batch=batch,
                params={"depth": depth["params"], "pose": pose},
                batch_stats=depth["batch_stats"])


def _port_state(joint, pt_cfg, total=20):
    depth = pt_make_model(pt_cfg, tiny=True, device="cpu").double()
    state = pt_selfsup.create_selfsup_state(depth, pt_cfg, total, PtPoseNet().double())
    state.model.load_state_dict(weights.selfsup_from_flax(joint["params"],
                                                          joint["batch_stats"], pt_cfg),
                                strict=True)
    return state


def _capture_grads():
    """An optax transformation that keeps the gradients it is given as its
    state and passes them on unchanged."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def test_joint_labels_match_jax(joint):
    """The joint optimizer's labels: the depth model's by its modules (the
    backbone at lr/10), every PoseNet parameter 'rest', as the JAX labels of
    the ``{"depth", "pose"}`` tree."""
    for hist_10x in (True, False):
        pt_cfg = joint["pt_cfg"].replace(hist_encoder_10x=hist_10x)
        state = _port_state(joint, pt_cfg)
        labels = jx_optim.param_group_labels(joint["params"], hist_10x)
        depth_table = weights.name_map(pt_cfg, weights.V2_TINY_STAGES)
        for name, label in state.tx.labels.items():
            part, key = name.split(".", 1)
            node = labels[part]
            path = depth_table[key][0] if part == "depth" else weights.posenet_name_map()[key][0]
            for p in path:
                node = node[p]
            assert label == node, name
        assert state.tx.labels["depth.img_encoder.conv0.0.weight"] == "backbone"
        assert {state.tx.labels[n] for n in state.tx.labels if n.startswith("pose.")} == {"rest"}
        hist = {state.tx.labels[n] for n in state.tx.labels if n.startswith("depth.hist_encoder")}
        assert hist == ({"rest"} if hist_10x else {"backbone"})


@pytest.mark.parametrize("clip", [False, True])
def test_two_joint_steps_match_jax_f64(joint, clip, monkeypatch):
    """Two self-supervised steps: after each, the four loss terms, the
    gradient of every depth and pose leaf, every parameter and running
    statistic, against ``make_selfsup_train_step`` with optax; the tiny
    default (``--disable_clip_grad``) and the clip on, whose global norm
    spans both networks."""
    cfg = joint["cfg"].replace(disable_clip_grad=not clip)
    pt_cfg = joint["pt_cfg"].replace(disable_clip_grad=not clip)
    geoms = joint["geoms"]
    state = _port_state(joint, pt_cfg)
    step = pt_selfsup.make_selfsup_train_step(state, pt_cfg, geoms,
                                              pt_geometry_for(pt_cfg, "train"))
    batch = {k: t(v) if v.dtype == bool else t(v).double() for k, v in joint["batch"].items()}
    with enable_x64():
        tx = optax.chain(_capture_grads(), jx_optim.make_optimizer(cfg, total_steps=20))
        jx_state = jx_selfsup.SelfSupState.create(
            apply_fn=joint["model"].apply, params=joint["params"],
            batch_stats=joint["batch_stats"], tx=tx)
        jx_batch = {k: jnp.asarray(v if v.dtype == bool else v.astype(np.float64))
                    for k, v in joint["batch"].items()}
    with enable_x64():
        jx_step = jx_selfsup.make_selfsup_train_step(joint["model"], cfg, geoms,
                                                     jx_geometry_for(cfg, "train"))
    drawn = []
    for i in range(2):
        # both steps at one seed: the port draws the same crop offsets twice,
        # and the JAX step, traced once with them, runs twice
        offsets = RecordedOffsets(monkeypatch)
        terms = step(state, batch, seed=100)
        drawn.append(offsets.drawn)
        left = offsets.replay_in_jax()
        with enable_x64():
            jx_state, m = jx_step(jx_state, jx_batch, jax.random.key(i))
        assert i == 1 or next(left, None) is None
        monkeypatch.undo()
        assert state.step == i + 1
        for k in pt_selfsup.LOSS_TERMS:
            close(float(terms[k]), float(m[k]))
        assert float(m["zone"]) > 0 and float(m["smooth"]) > 0
        to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
        ref_grads = weights.selfsup_from_flax(to_np(jx_state.opt_state[0]), None, pt_cfg)
        named = dict(state.model.named_parameters())
        assert set(ref_grads) == set(named)
        norm = np.sqrt(sum((p.grad.numpy() ** 2).sum() for p in named.values()))
        if clip:
            assert norm > pt_optim.CLIP_NORM  # the clip acts
        for k, p in named.items():
            np.testing.assert_allclose(p.grad.numpy(), ref_grads[k].numpy(), rtol=1e-7,
                                       atol=1e-12 * norm, err_msg=f"step {i + 1}: grad {k}")
        ref = weights.selfsup_from_flax(to_np(jx_state.params), to_np(jx_state.batch_stats),
                                        pt_cfg)
        # the schedules may differ in the last bit of their cosine: 2^-22 of max_lr
        atol = (i + 1) * cfg.lr * 2.0 ** -22
        for k, s in state.model.state_dict().items():
            np.testing.assert_allclose(s.numpy(), ref[k].numpy(), rtol=1e-7, atol=atol,
                                       err_msg=f"step {i + 1}: {k}")
    assert drawn[0] == drawn[1] and len(drawn[0]) == 3


def test_selfsup_step_runs_float32_and_debug_nans(joint):
    """The step casts nothing (``--compute_dtype bfloat16`` leaves it in
    float32, as the JAX step); under ``--debug_nans`` a NaN in the batch
    raises ``FloatingPointError`` naming the step."""
    pt_cfg = joint["pt_cfg"].replace(compute_dtype="bfloat16")
    depth = pt_make_model(pt_cfg, tiny=True, device="cpu")
    state = pt_selfsup.create_selfsup_state(depth, pt_cfg, 4)
    step = pt_selfsup.make_selfsup_train_step(state, pt_cfg, joint["geoms"],
                                              pt_geometry_for(pt_cfg, "train"))
    batch = {k: t(v) for k, v in joint["batch"].items()}
    terms = step(state, batch, 0)
    assert all(v.dtype == torch.float32 and torch.isfinite(v) for v in terms.values())
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
    batch["image_raw"] = batch["image_raw"].clone()
    batch["image_raw"][0, 0, 0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="step 1"):
        pt_loop.debug_nans_step(step)(state, batch, 1)


# ---- the entry point ---------------------------------------------------------------

def test_entry_point_runs_the_selfsup_variant(tmp_path, monkeypatch):
    """``python -m cfpnet_torch.train <tiny flags> --selfsup --device cpu
    --logging``: an epoch of pair steps (64 synthetic pairs at bs 16),
    validation, a ``selfsup_val`` JSONL line with the nine metrics, and the
    depth weights, ``best`` among them, loadable into the eval model."""
    monkeypatch.chdir(tmp_path)
    state = pt_train_main(ENTRY + ["--selfsup", "--logging", "--bs", "16"])
    assert isinstance(state.model, pt_selfsup.SelfSupModel) and state.step == 4
    lines = [json.loads(x) for x in open("results/entry/selfsup_log.jsonl")]
    assert [x["kind"] for x in lines] == ["selfsup_val"] and lines[0]["step"] == 4
    assert all(np.isfinite(lines[0][k]) for k in pt_loop.EVAL_METRIC_KEYS + ["loss"])
    saved = sorted(os.listdir("weights/entry"))
    assert saved[-1] == "best" and len(saved) == 2
    from cfpnet_torch.train.checkpoint import load_weights

    sd = load_weights("weights/entry/best")
    for k, v in state.model.depth.state_dict().items():
        assert torch.equal(sd[k], v), k
    assert not os.path.exists("checkpoints")


def test_new_modules_import_no_jax():
    """The modules of the self-supervised variant are among the files
    ``test_port_imports_no_jax`` scans, and import nothing of the JAX stack."""
    from tests.test_torch_port_bridge import FORBIDDEN, ROOT, _imports

    for rel in ("cfpnet_torch/ops/warp.py", "cfpnet_torch/models/posenet.py",
                "cfpnet_torch/train/selfsup.py", "cfpnet_torch/data/datasets.py",
                "cfpnet_torch/weights.py", "cfpnet_torch/train/optim.py"):
        assert (ROOT / rel) in set((ROOT / "cfpnet_torch").rglob("*.py")), rel
        assert not set(_imports(ROOT / rel)) & set(FORBIDDEN), rel


# ---- the golden production step ------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    """The golden record and the deterministic weights it started from."""
    import chip_smoke

    ref = dict(np.load(chip_smoke.GOLDEN_SELFSUP))
    return ref, chip_smoke.selfsup_golden_start(chip_smoke.golden_selfsup_config())


def _unmoved(ref, start, prefix):
    import chip_smoke

    return {k: start[k[9:]].double().numpy().ravel()[chip_smoke.leaf_indices(start[k[9:]].numel())]
            for k in ref if k.startswith("param_at:") and prefix(k[9:])}


@pytest.mark.parametrize("change,key", [
    (lambda ref, start: {k: start[k[5:]].double().numpy() for k in ref if k.startswith("stat:")},
     "stat_median"),
    (lambda ref, start: {k: 0 * ref[k] for k in ref if k.startswith(("grad_norm:pose.",
                                                                     "grad_sum:pose."))},
     "pose_grad_norm_median"),
    (lambda ref, start: _unmoved(ref, start, lambda n: n.startswith("pose.")),
     "pose_param_at_median"),
    (lambda ref, start: _unmoved(ref, start, lambda n: not n.startswith(
        ("pose.", "depth_head.", "conv_out."))), "trunk_param_at_median"),
])
def test_selfsup_golden_budget_fails_a_step_that_left_a_class_unchanged(golden, change, key):
    """The golden itself with one class set back to where the step started
    (running statistics frozen, PoseNet's gradients zeroed, PoseNet's or the
    trunk's parameters unmoved) is out of ``SELFSUP_GOLDEN_TOL`` in that
    class's median, while the golden itself is within it."""
    import chip_smoke

    ref, start = golden
    same = chip_smoke.golden_errors(ref, ref, start, terms=pt_selfsup.LOSS_TERMS)
    assert set(same) == set(chip_smoke.SELFSUP_GOLDEN_TOL)
    assert all(v <= chip_smoke.SELFSUP_GOLDEN_TOL[k] for k, v in same.items())
    errs = chip_smoke.golden_errors({**ref, **change(ref, start)}, ref, start,
                                    terms=pt_selfsup.LOSS_TERMS)
    assert errs[key] > chip_smoke.SELFSUP_GOLDEN_TOL[key], (key, errs[key])


@pytest.mark.slow
def test_selfsup_golden_step_on_the_cpu_within_the_card_tolerance():
    """The port's float32 self-supervised step on the CPU against the
    golden, within the tolerance the card is held to (full size: a minute
    and ~4 GB)."""
    import chip_smoke

    errs, _, _ = chip_smoke.selfsup_golden_errors(device="cpu")
    assert set(errs) == set(chip_smoke.SELFSUP_GOLDEN_TOL)
    for k, v in errs.items():
        assert v <= chip_smoke.SELFSUP_GOLDEN_TOL[k], (k, v)


def write_selfsup_golden(path, x64: bool = True):
    """One self-supervised production step of the JAX package, float64 on
    the CPU (float32 with ``x64=False``: the reference's own rounding):
    ``chip_smoke.golden_selfsup_config`` (bs 2 at 416x544), the
    deterministic depth and pose weights
    (``weights.deterministic_selfsup_state_dict``'s flax paths),
    ``chip_smoke.golden_selfsup_batch``, the crop offsets the port's
    generator draws at the golden seed, ``make_selfsup_train_step`` with the
    gradients captured ahead of the optimizer. Kept: the four loss terms
    and ``write_train_golden``'s entries, the depth model's under its own
    names and PoseNet's under ``pose.*``."""
    import dataclasses

    import chip_smoke

    pt_cfg = chip_smoke.golden_selfsup_config()
    cfg = JxConfig(**{f.name: getattr(pt_cfg, f.name) for f in dataclasses.fields(JxConfig)})
    geoms = model_geometries(cfg, "train")
    b = chip_smoke.golden_selfsup_batch(pt_cfg)
    offsets = chip_smoke.golden_crop_offsets(pt_cfg, chip_smoke.GOLDEN_TRAIN_SEED)
    model = jx_make_model(cfg)
    real_randint = jax.random.randint
    dtype = np.float64 if x64 else np.float32
    try:
        with enable_x64() if x64 else contextlib.nullcontext():
            shapes = jax.eval_shape(
                lambda r: model.init({"params": r, "fusion": r}, jnp.asarray(b["image"]),
                                     jnp.asarray(b["hist_data"]), jnp.asarray(b["mask"]),
                                     geoms, train=True), jax.random.key(0))
            depth = jax.tree_util.tree_map_with_path(
                lambda path, s: weights.det_leaf("/".join(p.key for p in path),
                                                 s.shape).astype(dtype), shapes)
            pose = {}
            for col, fpath, shape in weights.posenet_param_spec():
                pose.setdefault(fpath[0], {})[fpath[1]] = weights.det_leaf(
                    "/".join((col, "pose") + fpath), shape).astype(dtype)
            tx = optax.chain(_capture_grads(),
                             jx_optim.make_optimizer(cfg, chip_smoke.GOLDEN_TRAIN_TOTAL_STEPS))
            state = jx_selfsup.SelfSupState.create(
                apply_fn=model.apply, params={"depth": depth["params"], "pose": pose},
                batch_stats=depth["batch_stats"], tx=tx)
            batch = {k: jnp.asarray(v if v.dtype == bool else v.astype(dtype))
                     for k, v in b.items()}
            draws = iter([o for off in offsets for o in off])
            jax.random.randint = lambda key, shape, lo, hi, *a, **kw: jnp.asarray(next(draws))
            step = jx_selfsup.make_selfsup_train_step(model, cfg, geoms,
                                                      jx_geometry_for(cfg, "train"))
            state, m = step(state, batch, jax.random.key(0))
            assert next(draws, None) is None
    finally:
        jax.random.randint = real_randint
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    strip = lambda sd: {k[len("depth."):] if k.startswith("depth.") else k: v  # noqa: E731
                        for k, v in sd.items()}
    g = strip(weights.selfsup_from_flax(to_np(state.opt_state[0]), None, pt_cfg))
    after = strip(weights.selfsup_from_flax(to_np(state.params), to_np(state.batch_stats),
                                            pt_cfg))
    out = dict(crop_offsets=np.asarray(offsets), seed=chip_smoke.GOLDEN_TRAIN_SEED)
    out.update({k: np.asarray(m[k]) for k in pt_selfsup.LOSS_TERMS})
    for k, v in after.items():
        if k in g:
            flat, idx = g[k].numpy().ravel(), chip_smoke.leaf_indices(g[k].numel())
            out["grad_sum:" + k] = flat.sum()
            out["grad_norm:" + k] = np.linalg.norm(flat)
            out["grad_at:" + k] = flat[idx]
            out["param_at:" + k] = v.numpy().ravel()[idx]
        else:
            out["stat:" + k] = v.numpy()
    np.savez_compressed(path, **out)
    return out


def selfsup_golden_tolerance(path):
    """``chip_smoke.SELFSUP_GOLDEN_TOL`` by ``TRAIN_GOLDEN_TOL``'s rule: the
    port's float32 step on the CPU (``selfsup_golden_errors(device="cpu")``)
    and the JAX package's own float32 step (written to ``path``), each
    against the float64 golden; each limit is 4 times the larger, rounded
    up to two digits (0 where both are 0)."""
    import math

    import chip_smoke

    write_selfsup_golden(path, x64=False)
    ref = np.load(chip_smoke.GOLDEN_SELFSUP)
    config = chip_smoke.golden_selfsup_config()
    jax_errs = chip_smoke.golden_errors(np.load(path), ref,
                                        chip_smoke.selfsup_golden_start(config),
                                        terms=pt_selfsup.LOSS_TERMS)
    port_errs = chip_smoke.selfsup_golden_errors(device="cpu")[0]
    tol = {}
    for k in sorted(port_errs):
        v = 4 * max(port_errs[k], jax_errs[k])
        if v == 0:
            tol[k] = 0.0
            continue
        e = math.floor(math.log10(v)) - 1
        tol[k] = math.ceil(v / 10 ** e) * 10 ** e
    return port_errs, jax_errs, tol


if __name__ == "__main__":
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:2] == ["--tolerance"]:
        with tempfile.TemporaryDirectory() as tmp:
            port, jax_own, tol = selfsup_golden_tolerance(os.path.join(tmp, "f32.npz"))
        print(json.dumps({"port_f32_cpu": port, "jax_f32_cpu": jax_own, "tolerance": tol},
                         indent=1))
        sys.exit(0)
    target = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                          "torch_port_selfsup_step.npz")
    written = write_selfsup_golden(target)
    print(f"wrote {target}: loss {float(written['loss'])}, {len(written)} arrays, "
          f"{os.path.getsize(target)} bytes")
