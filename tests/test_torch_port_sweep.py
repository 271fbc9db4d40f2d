"""The port's epoch sweep (``cfpnet_torch/evaluate_all.py``) against the root
``evaluate_all.py`` on the CPU at the tiny size, and the eval entry points'
dataset choice and fallback.

- The tiny model with ``from_flax`` weights, saved in each package's format
  for two epochs and ``best``: the port's ``results.csv`` rows equal the JAX
  driver's (``evaluate_all.main`` under ``--test_dataset synthetic``) to the
  CSV's 3 places, and the unrounded metrics agree within rtol 1e-5 (both
  run float32); ``--selected_epoch best`` gives one row.
- The .xlsx reads back through ``zipfile`` (as ``tests/test_xlsx.py``); the
  three save flags write the same files as the JAX hook; ``--multihost``
  without an address or with a process outside the world is refused
  before anything is written, one process's ``--shard_eval`` is a no-op
  (two processes: ``tests/test_torch_port_multihost.py``;
  ``--serving_artifact``: ``tests/test_torch_port_serving.py``).
- The dataset choice by ``--test_dataset`` (ROADMAP §C 1): the port's
  ``eval_dataset_config`` against the root ``evaluate_all.py:169-174``,
  driven through the root's ``parse_config`` and ``zju_overrides``.
- ``evaluate_time``'s fallback (ROADMAP §C 2): the production argfile on the
  CPU times the synthetic sample where the ZJUL5 files are missing; every
  exception the root catches falls back; a dataset's ``scale_geoms`` wins
  over the config grid.
"""

import csv
import math
import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfpnet_torch import evaluate_all as pt_evaluate_all
from cfpnet_torch import evaluate_time as pt_evaluate_time
from cfpnet_torch import weights
from cfpnet_torch.config import parse_config as pt_parse_config
from cfpnet_torch.models.deltar import make_model as pt_make_model
from cfpnet_torch.models.deltar import model_geometries as pt_geometries
from cfpnet_torch.train.checkpoint import save_weights as pt_save_weights
from cfpnet_tpu.config import parse_config as jx_parse_config
from cfpnet_tpu.models.deltar import make_model as jx_make_model
from cfpnet_tpu.models.deltar import model_geometries
from cfpnet_tpu.train.checkpoint import save_weights as jx_save_weights
from tests.test_torch_port_bridge import FORBIDDEN, ROOT, _imports
from tests.torch_port_util import random_tree

PROD = f"@{ROOT / 'configs' / 'train_cfpnet_combine1.txt'}"
TINY_ARGV = ["--tiny_model", "--n_bins", "16", "--native_height", "64", "--native_width", "96",
             "--eval_zone_num_cfg", "2", "--eval_patch_px", "16", "--zone_sample_num", "16",
             "--sample_uniform", "--change_embedding",
             "--attention_layer", "hist2image", "combine1", "image"]
SWEEP_ARGV = TINY_ARGV + ["--test_dataset", "synthetic", "--synthetic_length", "3",
                          "--name", "sweep", "--save_dir", "results", "--epochs", "2"]
EPOCH_FILES = {"0_0.812": 1, "1_0.640": 2, "best": 2}  # weights file -> seed of its tree


@pytest.fixture(scope="module")
def trees():
    """The flax variable trees of the tiny model at seeds 1 and 2 (float32;
    kernels of std 0.05 keep the activations O(1))."""
    cfg = jx_parse_config(TINY_ARGV)
    model = jx_make_model(cfg, tiny=True)
    h, w, Z = cfg.native_height, cfg.native_width, cfg.eval_zone_num ** 2
    shapes = jax.eval_shape(
        lambda r: model.init({"params": r, "fusion": r}, jnp.zeros((1, h, w, 3)),
                             jnp.zeros((1, Z, cfg.zone_sample_num)), jnp.ones((1, Z), bool),
                             model_geometries(cfg, "online_eval")), jax.random.key(0))
    return cfg, {seed: random_tree(shapes, seed, kernel_std=0.05, dtype=np.float32)
                 for seed in (1, 2)}


@pytest.fixture(scope="module")
def weight_dirs(trees, tmp_path_factory):
    """Two working directories, ``jax/`` and ``port/``, each holding
    ``weights/sweep/{0_0.812, 1_0.640, best}`` in its package's format: the
    same trees, the port's through ``weights.from_flax``."""
    cfg, by_seed = trees
    root = tmp_path_factory.mktemp("sweep")
    model = pt_make_model(cfg, tiny=True, device="cpu")
    for name, seed in EPOCH_FILES.items():
        tree = by_seed[seed]
        jx_save_weights(str(root / "jax" / "weights" / "sweep" / name), tree["params"],
                        tree["batch_stats"])
        model.load_state_dict(weights.from_flax(tree["params"], tree["batch_stats"], cfg),
                              strict=True)
        pt_save_weights(str(root / "port" / "weights" / "sweep" / name), model)
    return root / "jax", root / "port"


def _root_driver():
    """The root ``evaluate_all`` module, imported where a test needs it: its
    import turns on the JAX package's persistent compilation cache for the
    whole process, which collection must not do to the other test files."""
    import evaluate_all

    return evaluate_all


def _run_jax(where, argv, monkeypatch):
    """The root driver's main in ``where``; returns each epoch's metrics as
    its grouped eval returned them, before the driver rounds them."""
    import cfpnet_tpu.train.loop as jx_loop

    seen = []
    make = jx_loop.make_grouped_eval

    def recording(*a, **kw):
        eval_fn = make(*a, **kw)

        def run(*b, **kwb):
            seen.append(dict(eval_fn(*b, **kwb)))
            return seen[-1]
        return run

    monkeypatch.chdir(where)
    monkeypatch.setattr(sys, "argv", ["evaluate_all.py"] + argv)
    monkeypatch.setattr(jx_loop, "make_grouped_eval", recording)
    _root_driver().main()
    monkeypatch.setattr(jx_loop, "make_grouped_eval", make)
    return seen


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("selected", ["-1", "best"])
def test_sweep_rows_equal_jax(weight_dirs, selected, monkeypatch):
    jax_dir, port_dir = weight_dirs
    argv = SWEEP_ARGV + ["--selected_epoch", selected]
    jx_unrounded = _run_jax(jax_dir, argv, monkeypatch)
    monkeypatch.chdir(port_dir)
    out = pt_evaluate_all.main(argv + ["--device", "cpu"])
    got, want = _rows(port_dir / "results" / "results.csv"), _rows(
        jax_dir / "results" / "results.csv")
    assert got[0] == ["epoch"] + pt_evaluate_all.METRICS == want[0]
    assert len(got) == (3 if selected == "-1" else 2)
    assert [r[0] for r in got[1:]] == [r[0] for r in want[1:]]
    for row, want_row, got_m, want_m in zip(got[1:], want[1:], out["metrics"], jx_unrounded):
        for k, a, b in zip(pt_evaluate_all.METRICS, row[1:], want_row[1:]):
            u, v = got_m[k], want_m[k]
            np.testing.assert_allclose(u, v, rtol=1e-5, err_msg=k)
            # equal to 3 places, unless the two float32 runs' unrounded
            # values straddle a rounding boundary (then 0.001 apart)
            straddle = math.floor(u * 1000 + 0.5) != math.floor(v * 1000 + 0.5)
            assert float(a) == float(b) or (straddle and abs(float(a) - float(b)) < 0.0011), \
                (k, a, b, u, v)
    assert out["rows"] == [[int(r[0])] + [float(v) for v in r[1:]] for r in got[1:]]
    names = [os.path.basename(p) for p in out["weights"]]
    if selected == "best":
        assert names == ["best"]
    else:
        assert [n.split("_")[0] for n in names] == [r[0] for r in got[1:]], names


def test_xlsx_reads_back(weight_dirs, monkeypatch):
    _, port_dir = weight_dirs
    monkeypatch.chdir(port_dir)
    out = pt_evaluate_all.main(SWEEP_ARGV + ["--device", "cpu", "--save_dir", "xlsx"])
    assert out["reports"][1].endswith("results.xlsx")
    with zipfile.ZipFile(out["reports"][1]) as z:
        assert "xl/worksheets/sheet1.xml" in set(z.namelist())
        sheet = z.read("xl/worksheets/sheet1.xml").decode()
    assert "silog" in sheet and f"<v>{out['rows'][1][5]}</v>" in sheet


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def test_save_flags_write_the_jax_hooks_files(weight_dirs, monkeypatch):
    from PIL import Image

    jax_dir, port_dir = weight_dirs
    argv = SWEEP_ARGV + ["--selected_epoch", "best", "--save_dir", "dumps", "--save_pred",
                         "--save_rgb", "--save_error_map"]
    _run_jax(jax_dir, argv, monkeypatch)
    monkeypatch.chdir(port_dir)
    pt_evaluate_all.main(argv + ["--device", "cpu"])
    got, want = _files(port_dir / "dumps"), _files(jax_dir / "dumps")
    assert got == want and len(got) == 3 * 3 + 2  # three images, three flags, csv + xlsx
    for name in got:
        if name.endswith(".png"):
            a = np.asarray(Image.open(port_dir / "dumps" / name))
            assert a.shape == (64, 96, 3) and a.dtype == np.uint8
            if name.endswith("_rgb.png"):  # the same image through the same arithmetic
                np.testing.assert_array_equal(a, np.asarray(Image.open(jax_dir / "dumps" / name)))


@pytest.mark.parametrize("flags,env,item", [
    pytest.param(["--multihost"], {"WORLD_SIZE": "2", "RANK": "0"}, "--coordinator_address",
                 id="flags1-env1-address"),
    pytest.param(["--multihost", "--coordinator_address", "127.0.0.1:1", "--num_processes",
                  "2", "--process_id", "2"], {}, "process_id 2 is not in a world of 2",
                 id="flags2-env2-process_id")])
def test_sweep_refusals(flags, env, item, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=item):
        pt_evaluate_all.main(SWEEP_ARGV + ["--device", "cpu"] + flags)
    assert not os.path.exists("results")


def test_spatial_sweep_equals_the_unsharded_sweep(weight_dirs, monkeypatch):
    """``--spatial_shards 2``, which the port's ``evaluate`` once ignored
    (ROADMAP §C, Fixed): with four devices (four CPU devices standing in for
    the cards there are) the sweep splits each image's rows over 2 shards
    of a 2 x 2 grid at ``--eval_bs 2`` and gives the unsharded sweep's
    metrics (both float32); with one device the grid does not fit and the
    sweep raises the JAX mesh's ``ValueError`` before any work."""
    from cfpnet_torch.parallel import spatial

    _, port_dir = weight_dirs
    monkeypatch.chdir(port_dir)
    argv = SWEEP_ARGV + ["--device", "cpu", "--selected_epoch", "best"]
    plain = pt_evaluate_all.main(argv + ["--save_dir", "plain"])
    with pytest.raises(ValueError, match="mesh 1x2 needs 2 devices, have 1"):
        pt_evaluate_all.main(argv + ["--save_dir", "one", "--spatial_shards", "2"])
    grids = []
    make = spatial.make_mesh_2d
    monkeypatch.setattr(spatial, "available_devices", lambda device: [torch.device("cpu")] * 4)
    monkeypatch.setattr(spatial, "make_mesh_2d",
                        lambda *a, **kw: grids.append(make(*a, **kw)) or grids[-1])
    sharded = pt_evaluate_all.main(argv + ["--save_dir", "sharded", "--spatial_shards", "2",
                                           "--eval_bs", "2"])
    assert grids and {(g.dp, g.sp) for g in grids} == {(2, 2)}
    (got,), (want,) = sharded["metrics"], plain["metrics"]
    assert set(got) == set(want) and len(want) == 9
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_shard_eval_with_one_process_is_a_no_op(weight_dirs, monkeypatch):
    _, port_dir = weight_dirs
    monkeypatch.chdir(port_dir)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = SWEEP_ARGV + ["--device", "cpu", "--selected_epoch", "best"]
    plain = pt_evaluate_all.main(argv + ["--save_dir", "plain"])
    sharded = pt_evaluate_all.main(argv + ["--save_dir", "sharded", "--shard_eval"])
    assert sharded["rows"] == plain["rows"]


ZJU_FIELDS = ("dataset_eval", "data_path_eval", "filenames_file_eval", "native_height",
              "native_width", "max_depth", "min_depth", "n_bins", "min_depth_eval",
              "max_depth_eval", "zone_sample_num")


def _root_choice(argv):
    """The root ``evaluate_all.py::main``'s choice (``:169-174``), through its
    ``parse_config`` and ``zju_overrides``."""
    config = jx_parse_config(argv).replace(mode="online_eval")
    if "zjuL5" in config.test_dataset:
        config = _root_driver().zju_overrides(config)
    elif "synthetic" in config.test_dataset:
        config = config.replace(dataset_eval="synthetic")
    elif "nyu" in config.test_dataset:
        config = config.replace(dataset_eval="nyu")
    return config


@pytest.mark.parametrize("extra,dataset_eval", [([], "zjuL5"), (["--test_dataset", "nyu"], "nyu"),
                                                (["--test_dataset", "synthetic"], "synthetic")])
def test_dataset_choice_matches_the_root_driver(extra, dataset_eval):
    argv = [PROD] + extra
    got = pt_evaluate_all.eval_dataset_config(pt_parse_config(argv).replace(mode="online_eval"))
    want = _root_choice(argv)
    assert {f: getattr(got, f) for f in ZJU_FIELDS} == {f: getattr(want, f) for f in ZJU_FIELDS}
    assert got.dataset_eval == dataset_eval


def test_evaluate_time_production_argfile_falls_back_on_the_cpu():
    """``python -m cfpnet_torch.evaluate_time @configs/train_cfpnet_combine1.txt
    --device cpu --eager --niters 1`` (the tiny backbone, to keep it short):
    the default --test_dataset zjuL5 applies ``zju_overrides`` and, with no
    ZJUL5 files on disk, times the synthetic sample at 480x640.

    The subprocess runs two OpenMP threads: with one thread a core it
    oversubscribes the cores beside the suite's workers, each of which has
    its own threads, and its six forwards then took 545 s instead of 8 s
    alone (their barriers spin while the cores run other threads)."""
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "cfpnet_torch.evaluate_time", PROD, "--device", "cpu", "--eager",
         "--niters", "1", "--tiny_model"], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert lines[0].endswith(" ms") and float(lines[0].split()[0]) > 0
    assert lines[2] == "(bs=1, float32, eager; cpu, host clock)"


@pytest.mark.parametrize("error", [FileNotFoundError, NotImplementedError, KeyError])
def test_eval_batch_falls_back_to_the_synthetic_sample(error, monkeypatch):
    cfg = pt_parse_config(TINY_ARGV + ["--dataset_eval", "nyu"]).replace(mode="online_eval")

    def unreadable(config, mode):
        raise error("data/sync/bathroom/rgb_00045.jpg")

    monkeypatch.setattr(pt_evaluate_time, "make_dataset", unreadable)
    (image, hist, mask), geoms = pt_evaluate_time.eval_batch(cfg, 2, "cpu")
    assert image.shape == (2, 64, 96, 3) and image.dtype == torch.float32
    assert hist.shape == (2, 4, 16) and mask.dtype == torch.bool
    assert geoms == pt_geometries(cfg, "online_eval")


def test_eval_batch_takes_the_datasets_geometry(monkeypatch):
    """A dataset's measured geometry (``scale_geoms``, the ZJUL5 rig) wins
    over the config's zone grid, as in the root ``timed_forward``."""
    from cfpnet_torch.data.datasets import SyntheticDataset

    cfg = pt_parse_config(TINY_ARGV + ["--test_dataset", "synthetic"]).replace(mode="online_eval")
    measured = pt_geometries(cfg.replace(eval_patch_px=8), "online_eval")
    assert measured != pt_geometries(cfg, "online_eval")

    def with_rig(config, mode):
        ds = SyntheticDataset(config, mode, 2)
        ds.scale_geoms = measured
        return ds

    monkeypatch.setattr(pt_evaluate_time, "make_dataset", with_rig)
    _, geoms = pt_evaluate_time.eval_batch(cfg, 1, "cpu")
    assert geoms is measured


NEW_MODULES = ("cfpnet_torch/evaluate_all.py", "cfpnet_torch/utils/__init__.py",
               "cfpnet_torch/utils/xlsx.py", "cfpnet_torch/utils/vis.py",
               "cfpnet_torch/kernels/dtypes.py", "cfpnet_torch/import_weights.py",
               "cfpnet_torch/extract_nyu_mat.py", "cfpnet_torch/demo.py")


def test_new_modules_import_no_jax():
    """``tests/test_torch_port_bridge.py::test_port_imports_no_jax`` reads
    every file of the port; these are the sweep's and the tools'. None names
    the JAX stack, and importing them with JAX made unimportable works."""
    for name in NEW_MODULES:
        path = ROOT / name
        assert path.is_file(), name
        assert not set(_imports(path)) & FORBIDDEN, name
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'cfpnet_tpu', 'tools'):\n"
            "    sys.modules[m] = None\n"
            "import cfpnet_torch.evaluate_all, cfpnet_torch.utils.vis, cfpnet_torch.utils.xlsx\n"
            "import cfpnet_torch.evaluate, cfpnet_torch.evaluate_time, cfpnet_torch.bench\n"
            "import cfpnet_torch.kernels.dtypes\n"
            "import cfpnet_torch.import_weights, cfpnet_torch.extract_nyu_mat, cfpnet_torch.demo\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
