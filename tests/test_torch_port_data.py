"""The port's data layer against the JAX package's, on files the tests
write: ``NYUV2Dataset`` (train with rotation, augmentation and zone offsets
0 and 1; eval with ``image_u8`` and ``has_valid_depth``), ``ZJUL5Dataset``
(one rig and mixed rigs), the ``DataLoader`` over two epochs, and the host
ToF kernel of ``data/native.py``. Samples and batches must be equal array
for array: the same numpy and PIL calls run in the same order."""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from cfpnet_torch import tracing
from cfpnet_torch.config import Config as PtConfig
from cfpnet_torch.data import datasets as pt_ds
from cfpnet_torch.data import native as pt_native
from cfpnet_torch.data import pipeline as pt_pipe
from cfpnet_torch.data import tof_sim as pt_tof
from cfpnet_torch.data.geometry import ZoneGeometry
from cfpnet_tpu.config import Config as JxConfig
from cfpnet_tpu.data import datasets as jx_ds
from cfpnet_tpu.data import native as jx_native
from cfpnet_tpu.data import pipeline as jx_pipe

NYU = dict(input_height=416, input_width=544, native_height=480, native_width=640,
           train_zone_num=6, eval_zone_num_cfg=8, train_patch_px=64, eval_patch_px=56,
           zone_sample_num=16, sample_uniform=True, do_random_rotate=True, degree=2.5,
           drop_hist=0.34, noise_prob=0.3, noise_mean=0.17, noise_sigma=0.2, seed=11)


def configs(**kw):
    return JxConfig(**kw), PtConfig(**kw)


def assert_same_sample(got, ref, what=""):
    assert set(got) == set(ref), what
    for k in ref:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")


@pytest.fixture(params=["native", "numpy"])
def tof_path(request, monkeypatch):
    """Both packages on the C++ kernel, or both on the numpy path."""
    if request.param == "numpy":
        for mod in (pt_native, jx_native):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_TRIED", True)
    elif pt_native.get_lib() is None or jx_native.get_lib() is None:
        pytest.skip("g++ is missing: the host ToF kernel cannot be built")
    return request.param


@pytest.fixture
def nyu_tree(tmp_path):
    """A small NYU tree: rgb_{n}.jpg and sync_depth_{n}.png (mm)."""
    from PIL import Image

    rng = np.random.default_rng(3)
    scene = tmp_path / "sync" / "scene_a"
    scene.mkdir(parents=True)
    names = []
    yy, xx = np.mgrid[0:480, 0:640]
    for n in range(3):
        rgb = (rng.random((480, 640, 3)) * 255).astype(np.uint8)
        depth_mm = (1500 + 1200 * np.sin(yy / (40.0 + 9 * n)) * np.cos(xx / 57.0)
                    + rng.uniform(0, 100, (480, 640))).astype(np.uint16)
        Image.fromarray(rgb).save(scene / f"rgb_{n:05d}.jpg")
        Image.fromarray(depth_mm, mode="I;16").save(scene / f"sync_depth_{n:05d}.png")
        names.append({"filename": f"sync/scene_a/{n:05d}.h5"})
    split = tmp_path / "split.json"
    split.write_text(json.dumps({"train": names, "test": names}))
    return dict(NYU, data_path=str(tmp_path / "sync"), data_path_eval=str(tmp_path / "sync"),
                filenames_file=str(split), filenames_file_eval=str(split)), scene


@pytest.mark.parametrize("zone_offset", [0, 1])
def test_nyu_train_samples_equal_jax(nyu_tree, tof_path, zone_offset):
    """Border crop, rotation, uint8 crop, flip, photometric augmentation and
    hist augmentation from the dataset's generator, in the JAX order: each
    sample, and the generator's state after them, equal."""
    jx_cfg, pt_cfg = configs(**nyu_tree[0])
    jx, pt = jx_ds.NYUV2Dataset(jx_cfg, "train"), pt_ds.NYUV2Dataset(pt_cfg, "train")
    jx.zone_offset = pt.zone_offset = zone_offset
    for i in (0, 2, 1, 0):
        assert_same_sample(pt[i], jx[i], f"train {i}")
    assert pt.rng.bit_generator.state == jx.rng.bit_generator.state


def test_nyu_eval_samples_and_missing_depth(nyu_tree, tof_path):
    """Eval ships ``image_u8`` and ``has_valid_depth``; a missing depth file
    is flagged (eval) and raised (train), in both packages."""
    cfg, scene = nyu_tree
    (scene / "sync_depth_00001.png").unlink()
    jx_cfg, pt_cfg = configs(**cfg)
    jx, pt = jx_ds.NYUV2Dataset(jx_cfg, "online_eval"), pt_ds.NYUV2Dataset(pt_cfg, "online_eval")
    for i in range(3):
        s = pt[i]
        assert_same_sample(s, jx[i], f"eval {i}")
        assert s["image_u8"].dtype == np.uint8 and bool(s["has_valid_depth"]) == (i != 1)
    assert pt.sample_meta(2) == jx.sample_meta(2) == ("scene_a", "rgb_00002")
    with pytest.raises(FileNotFoundError):
        pt_ds.NYUV2Dataset(pt_cfg, "train")[1]
    with pytest.raises(FileNotFoundError):
        jx_ds.NYUV2Dataset(jx_cfg, "train")[1]


def test_nyu_resume_draws_other_augmentations_in_both_packages(nyu_tree):
    """A property of both packages, pinned: ``NYUV2Dataset`` draws its
    augmentations from one generator seeded once, so a run resumed at epoch
    1 decodes epoch 1's batches (the same indices) with other rotations,
    crops, flips and hist noise than the uninterrupted run. The port equals
    the JAX package in both runs."""
    jx_cfg, pt_cfg = configs(**nyu_tree[0])

    def epoch1(ds_mod, pipe, cfg, resumed):
        ds = ds_mod.NYUV2Dataset(cfg, "train")
        kw = {} if pipe is jx_pipe else {"device": "cpu"}
        loader = pipe.DataLoader(ds, 1, shuffle=True, drop_last=True, seed=cfg.seed, **kw)
        for epoch in ([1] if resumed else [0, 1]):
            loader.set_epoch(epoch)
            batches = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
        return batches

    for resumed in (False, True):
        for b, (got, ref) in enumerate(zip(epoch1(pt_ds, pt_pipe, pt_cfg, resumed),
                                           epoch1(jx_ds, jx_pipe, jx_cfg, resumed))):
            assert_same_sample(got, ref, f"resumed={resumed} batch {b}")
    straight = epoch1(pt_ds, pt_pipe, pt_cfg, False)
    again = epoch1(pt_ds, pt_pipe, pt_cfg, True)
    assert len(straight) == len(again) == 3
    for a, b in zip(straight, again):
        assert a["image"].shape == b["image"].shape
        assert not np.array_equal(a["image"], b["image"])
        assert not np.array_equal(a["hist_data"], b["hist_data"])


def test_sample_image_f32_equals_jax(nyu_tree):
    jx_cfg, pt_cfg = configs(**nyu_tree[0])
    s = pt_ds.NYUV2Dataset(pt_cfg, "online_eval")[0]
    np.testing.assert_array_equal(pt_ds.sample_image_f32(s), jx_ds.sample_image_f32(s))


# ---- ZJUL5 -------------------------------------------------------------------

def centered_rects(zn=8, px=56, off_y=0, off_x=0):
    return ZoneGeometry(480, 640, zn, px, px, offset_y=off_y, offset_x=off_x).zone_rects()


@pytest.fixture
def zju_tree(tmp_path):
    """Three captures of an off-center rig."""
    import h5py

    rng = np.random.default_rng(7)
    fr = centered_rects(off_y=24, off_x=-16)
    d = tmp_path / "zju"
    d.mkdir()
    names = []
    for i in range(3):
        with h5py.File(d / f"cap{i}.h5", "w") as f:
            f["rgb"] = (rng.random((480, 640, 3)) * 255).astype(np.uint8)
            f["depth"] = rng.uniform(0.3, 8.0, (480, 640)).astype(np.float32)
            f["hist_data"] = np.stack([rng.uniform(0.5, 3.5, 64), rng.uniform(0.05, 0.3, 64)],
                                      axis=1).astype(np.float32)
            f["fr"] = fr
            f["mask"] = rng.random(64) > 0.2
        names.append({"filename": f"cap{i}.h5"})
    (d / "data.json").write_text(json.dumps({"test": names}))
    return d


def zju_configs(d, **kw):
    return configs(**dict(NYU, data_path_eval=str(d), filenames_file_eval=str(d / "data.json"),
                          **kw))


def set_rects(path, fr):
    import h5py

    with h5py.File(path, "r+") as f:
        del f["fr"]
        f["fr"] = fr


def same_groups(pt, jx):
    assert len(pt.geometry_groups) == len(jx.geometry_groups)
    for (pg, pi, pf), (jg, ji, jf) in zip(pt.geometry_groups, jx.geometry_groups):
        assert pi == ji
        np.testing.assert_array_equal(pf, jf)
        assert {k: dataclasses.astuple(v) for k, v in pg.items()} == {
            k: dataclasses.astuple(v) for k, v in jg.items()}


@pytest.mark.parametrize("zone_type", ["8x8", "4x4"])
def test_zjul5_one_rig_equals_jax(zju_tree, zone_type):
    jx_cfg, pt_cfg = zju_configs(zju_tree, zone_type=zone_type)
    jx, pt = jx_ds.ZJUL5Dataset(jx_cfg), pt_ds.ZJUL5Dataset(pt_cfg)
    same_groups(pt, jx)
    assert {k: dataclasses.astuple(v) for k, v in pt.scale_geoms.items()} == {
        k: dataclasses.astuple(v) for k, v in jx.scale_geoms.items()}
    for i in range(3):
        assert_same_sample(pt[i], jx[i], f"capture {i}")
    assert pt.sample_meta(1) == jx.sample_meta(1)


def test_zjul5_mixed_rig_groups_and_raises_equal_jax(zju_tree):
    """Two rigs: the same groups and rects, ``scale_geoms`` raising, each
    capture loading under its group; then a capture whose rects change after
    init raises in both."""
    set_rects(zju_tree / "cap1.h5", centered_rects())
    jx_cfg, pt_cfg = zju_configs(zju_tree)
    jx, pt = jx_ds.ZJUL5Dataset(jx_cfg), pt_ds.ZJUL5Dataset(pt_cfg)
    same_groups(pt, jx)
    assert [g[1] for g in pt.geometry_groups] == [[0, 2], [1]]
    for ds in (pt, jx):
        with pytest.raises(ValueError, match="mixed-rig"):
            ds.scale_geoms
    for i in range(3):
        assert_same_sample(pt[i], jx[i], f"capture {i}")
    set_rects(zju_tree / "cap2.h5", centered_rects(off_y=8))
    for ds in (pt, jx):
        with pytest.raises(ValueError, match="rects changed"):
            ds[2]


def test_make_dataset_names_and_refusals(nyu_tree, zju_tree):
    _, pt_cfg = configs(**nyu_tree[0])
    assert isinstance(pt_ds.make_dataset(pt_cfg.replace(dataset="nyu"), "train"),
                      pt_ds.NYUV2Dataset)
    _, zcfg = zju_configs(zju_tree)
    assert isinstance(pt_ds.make_dataset(zcfg.replace(dataset_eval="zjuL5"), "online_eval"),
                      pt_ds.ZJUL5Dataset)
    syn = pt_ds.make_dataset(pt_cfg.replace(dataset_eval="synthetic", synthetic_length=99),
                             "online_eval")
    assert len(syn) == 64
    # --selfsup: the train set is the pair set of its name, the eval set the plain one
    assert isinstance(pt_ds.make_dataset(pt_cfg.replace(dataset="nyu", selfsup=True), "train"),
                      pt_ds.NYUPairDataset)
    assert isinstance(pt_ds.make_dataset(pt_cfg.replace(dataset="synthetic", selfsup=True),
                                         "train"), pt_ds.SyntheticPairDataset)
    assert type(pt_ds.make_dataset(pt_cfg.replace(dataset_eval="nyu", selfsup=True),
                                   "online_eval")) is pt_ds.NYUV2Dataset
    # a train loader of a data-parallel run: the JAX loader's refusal of a batch
    # size the processes do not divide
    with pytest.raises(ValueError, match="bs=3, processes=2"):
        pt_pipe.DataLoader(pt_ds.SyntheticDataset(pt_cfg, "train", 6), 3, rank=0, world=2)
    # --device_pipeline: the train loader ships the raw crops
    raw = pt_pipe.make_loader(pt_cfg.replace(dataset="nyu", device_pipeline=True), "train",
                              device="cpu")
    assert isinstance(raw.dataset, pt_ds.NYUV2Dataset) and raw.batch_size == pt_cfg.bs
    assert set(raw.dataset[0]) == {"image_raw", "depth"}


@pytest.mark.parametrize("mode", ["train", "online_eval"])
def test_device_pipeline_raw_samples_equal_jax(nyu_tree, mode):
    """Under ``--device_pipeline`` a train sample is the raw crop and its
    depth: NYU's uint8 crop (after the border crop, the rotation and the
    random crop, drawn as before) and the synthetic set's float32 image,
    equal to the JAX package's, the generator's state too; eval samples
    are the full ones, as without the option."""
    jx_cfg, pt_cfg = configs(**nyu_tree[0], device_pipeline=True)
    jx, pt = jx_ds.NYUV2Dataset(jx_cfg, mode), pt_ds.NYUV2Dataset(pt_cfg, mode)
    for i in (0, 2, 1):
        got = pt[i]
        assert_same_sample(got, jx[i], f"nyu {mode} {i}")
    assert pt.rng.bit_generator.state == jx.rng.bit_generator.state
    syn_jx = jx_ds.SyntheticDataset(jx_cfg, mode, 3)
    syn_pt = pt_ds.SyntheticDataset(pt_cfg, mode, 3)
    for i in range(3):
        assert_same_sample(syn_pt[i], syn_jx[i], f"synthetic {mode} {i}")
    if mode == "train":
        assert set(got) == {"image_raw", "depth"} and got["image_raw"].dtype == np.uint8
        assert got["image_raw"].shape == (pt_cfg.input_height, pt_cfg.input_width, 3)
        assert got["depth"].shape == (pt_cfg.input_height, pt_cfg.input_width, 1)
        assert syn_pt[0]["image_raw"].dtype == np.float32
    else:
        assert "image_u8" in got and "image" in syn_pt[0]


# ---- the loader ----------------------------------------------------------------

SMALL = dict(n_bins=16, input_height=48, input_width=64, native_height=64, native_width=96,
             train_zone_num=2, eval_zone_num_cfg=2, train_patch_px=16, eval_patch_px=16,
             zone_sample_num=16, sample_uniform=True, drop_hist=0.3, noise_prob=0.3,
             noise_sigma=0.2, seed=5)


@pytest.mark.parametrize("zone_offset", [0, 2])
def test_loader_batches_equal_jax_over_two_epochs(zone_offset):
    """Train policy (shuffled, drop_last, per-batch zone offsets) over two
    epochs pinned by ``set_epoch``, an epoch left early included: the same
    dataset indices and the same batches as the JAX ``DataLoader(mesh=None)``."""
    jx_cfg, pt_cfg = configs(**SMALL, bs=3)
    n = 10  # 3 full batches, the 10th sample dropped
    jx = jx_pipe.DataLoader(jx_ds.SyntheticDataset(jx_cfg, "train", n), 3, shuffle=True,
                            drop_last=True, seed=5, zone_random_offset=zone_offset)
    pt = pt_pipe.DataLoader(pt_ds.SyntheticDataset(pt_cfg, "train", n), 3, shuffle=True,
                            drop_last=True, seed=5, zone_random_offset=zone_offset, device="cpu")
    assert len(pt) == len(jx) == 3
    orders = []
    for epoch in (0, 1, 1):
        jx.set_epoch(epoch)
        pt.set_epoch(epoch)
        order = pt._index_order()
        np.testing.assert_array_equal(order, jx._index_order())
        seen = []
        with tracing.session() as spans:
            for b, (got, ref) in enumerate(zip(pt, jx)):
                assert all(isinstance(v, torch.Tensor) for v in got.values())
                np.testing.assert_array_equal(pt.indices, order[3 * b: 3 * b + 3])
                assert_same_sample({k: v.numpy() for k, v in got.items()},
                                   {k: np.asarray(v) for k, v in ref.items()}, f"{epoch}/{b}")
                seen.extend(pt.indices)
        assert len(seen) == 9 and len(set(seen)) == 9
        orders.append(order)
    assert not np.array_equal(orders[0], orders[1])
    # the last pass: a wait of the consumer and a make of the producer a batch
    last = spans.snapshot().spans
    waits = [s for s in last if s.name == "data.wait"]
    made = [s for s in last if s.name == "data.produce"]
    assert len(waits) == len(made) == 3
    assert all(s.end_ns >= s.start_ns for s in waits) and all(s.end_ns > s.start_ns for s in made)


def test_loader_eval_policy_and_ragged_tail():
    _, pt_cfg = configs(**SMALL, eval_bs=4)
    ds = pt_ds.SyntheticDataset(pt_cfg, "online_eval", 6)
    loader = pt_pipe.make_loader(pt_cfg, "online_eval", dataset=ds, device="cpu")
    sizes = [int(b["image"].shape[0]) for b in loader]
    assert sizes == [4, 2] and not loader.shuffle
    np.testing.assert_array_equal(loader.indices, [4, 5])
    train = pt_pipe.make_loader(pt_cfg.replace(bs=4), "train",
                                dataset=pt_ds.SyntheticDataset(pt_cfg, "train", 6), device="cpu")
    assert len(train) == 1 and [int(b["image"].shape[0]) for b in train] == [4]


def test_loader_raises_producer_errors():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise ValueError("boom")
            return {"x": np.zeros(2)}

    loader = pt_pipe.DataLoader(Broken(), batch_size=1, device="cpu")
    got = []
    with pytest.raises(ValueError, match="boom"):
        for b in loader:
            got.append(b)
    assert len(got) == 2


def test_loader_leaves_early_without_a_stray_producer():
    """A consumer that breaks off stops the producer and keeps the epoch."""
    _, pt_cfg = configs(**SMALL)
    loader = pt_pipe.DataLoader(pt_ds.SyntheticDataset(pt_cfg, "train", 8), 1, prefetch=1,
                                device="cpu")
    for i, _ in enumerate(loader):
        if i == 1:
            break
    assert loader.epoch == 0
    assert len(list(loader)) == 8 and loader.epoch == 1


# ---- the host ToF kernel --------------------------------------------------------

def _depth(seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:480, 0:640].astype(np.float32)
    d = 1.0 + 1.4 * np.sin(yy / 31.0 + seed) ** 2 + 1.1 * np.cos(xx / 47.0) ** 2
    d += 0.05 * rng.standard_normal((480, 640)).astype(np.float32)
    d[rng.random((480, 640)) < 0.02] = 0.0
    return d.astype(np.float32)


def _numpy_get_hist(depth, geom, max_d):
    hist = pt_tof.zone_histograms(depth, geom, max_d)
    hist[:, 0] = 0.0
    hist = np.clip(hist - pt_tof.NOISE_FLOOR, 0.0, None)
    return pt_tof.fit_moments(pt_tof.strongest_cluster(hist), max_d)


@pytest.mark.parametrize("zn,px,off", [(8, 56, 0), (6, 64, 3), (8, 56, -12)])
def test_native_equals_numpy_and_jax(zn, px, off):
    """The port's C++ kernel: bit for bit the JAX package's (same source,
    same flags), and the numpy path's within the JAX package's own
    tolerance (tests/test_native.py)."""
    if pt_native.get_lib() is None or jx_native.get_lib() is None:
        pytest.skip("g++ is missing: the host ToF kernel cannot be built")
    geom = ZoneGeometry(480, 640, zn, px, px, offset_y=off, offset_x=-off)
    for seed in range(3):
        depth = _depth(seed)
        fh, mask = pt_native.native_get_hist(depth, geom, 4.0, 0.04, 20.0)
        jfh, jmask = jx_native.native_get_hist(depth, geom, 4.0, 0.04, 20.0)
        np.testing.assert_array_equal(fh, jfh)
        np.testing.assert_array_equal(mask, jmask)
        nfh, nmask = _numpy_get_hist(depth, geom, 4.0)
        np.testing.assert_array_equal(mask, nmask)
        np.testing.assert_allclose(fh, nfh, rtol=1e-5, atol=1e-6)
        pts = pt_native.native_sample_uniform(fh, mask, 16)
        np.testing.assert_array_equal(pts, jx_native.native_sample_uniform(fh, mask, 16))
        np.testing.assert_allclose(pts, pt_tof.sample_points(fh, mask, 16, True),
                                   rtol=1e-5, atol=1e-6)
    assert pt_native.active() == "native"


def test_native_switch_selects_numpy(monkeypatch):
    """``CFPNET_NATIVE_TOFSIM=0`` selects the numpy path, and says so."""
    monkeypatch.setenv("CFPNET_NATIVE_TOFSIM", "0")
    monkeypatch.setattr(pt_native, "_LIB", None)
    monkeypatch.setattr(pt_native, "_TRIED", False)
    assert pt_native.get_lib() is None and pt_native.active() == "numpy"
    geom = ZoneGeometry(480, 640, 8, 56, 56)
    fh, fr, mask = pt_tof.get_hist(_depth(1), geom, 4.0)
    nfh, nmask = _numpy_get_hist(_depth(1), geom, 4.0)
    np.testing.assert_array_equal(fh, nfh)
    np.testing.assert_array_equal(mask, nmask)


def test_native_builds_into_the_package(tmp_path, monkeypatch):
    """A fresh build directory gets the library at first use, named by the
    source's digest; a missing compiler gives the numpy path."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing")
    monkeypatch.setattr(pt_native, "BUILD_DIR", tmp_path / "_build")
    path = pt_native._build()
    assert path is not None and path.parent == tmp_path / "_build" and path.exists()
    assert path.name == pt_native.library_path().name
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(pt_native, "BUILD_DIR", tmp_path / "_other")
    assert pt_native._build() is None
