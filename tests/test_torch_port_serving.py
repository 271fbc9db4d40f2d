"""The port's serving (``cfpnet_torch/serve``, ``cfpnet_torch/export_serving.py``,
``evaluate_all``/``evaluate_time --serving_artifact``) against the JAX
package's (``cfpnet_tpu/serve/export.py``, ``tools/``, the root drivers), on
the CPU at ``tests/test_serving.py``'s TINY_ARGS with one random flax tree
(kernels of std 0.05, as the sweep tests) carried by ``weights.from_flax``.

(a) the port's f32 CPU artifact against the JAX package's CPU artifact on 5
seeded uint8 inputs, one with an invalid zone, in both protocols: max
|port - JAX| <= 1e-4 * max |JAX| (the gap is printed); (b) the artifact
against the port's live ``make_eval_step`` bit for bit, in f32 and bf16;
(c) the exported graph calls the three custom ops and holds no plain twin;
(d) an export leaves the live forward as it was; (e) padding and chunking
through the JAX ``_chunked``'s sizes; (f) the manifest geometry against
the JAX manifest's, config grid and measured rig; (g) the refusals; (h) the
sweep through an artifact against the root driver's; (i) HTTP and the
MicroBatcher; (j) the new modules import without JAX. Each artifact is
exported once per module.
"""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.request
from urllib.error import HTTPError

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfpnet_torch import evaluate_all as pt_evaluate_all
from cfpnet_torch import evaluate_time as pt_evaluate_time
from cfpnet_torch import export_serving as pt_export_serving
from cfpnet_torch import weights
from cfpnet_torch.config import parse_config as pt_parse_config
from cfpnet_torch.models.deltar import cast_to_compute_dtype
from cfpnet_torch.models.deltar import make_model as pt_make_model
from cfpnet_torch.models.deltar import model_geometries as pt_geometries
from cfpnet_torch.ops import interp
from cfpnet_torch.serve import export as pt_export
from cfpnet_torch.serve import http as pt_http
from cfpnet_torch.train import steps as pt_steps
from cfpnet_tpu.config import parse_config as jx_parse_config
from cfpnet_tpu.models.deltar import make_model as jx_make_model
from cfpnet_tpu.models.deltar import model_geometries as jx_geometries
from cfpnet_tpu.serve import export as jx_export
from tests.test_serving import TINY_ARGS, _fabricate_zju_tree, _mb_inputs
from tests.test_torch_port_bridge import FORBIDDEN, ROOT, _imports
from tests.torch_port_util import random_tree

N_INPUTS = 5
# a CPU program: BatchNorm's plain formula, no cfpnet::bn_act
OPS = {"cfpnet::linear_attention": 3, "cfpnet::dwconv2d": 3, "cfpnet::fused_loftr": 9,
       "cfpnet::bn_act": 0}


def _inputs(cfg):
    rng = np.random.default_rng(3)
    zones = cfg.eval_zone_num ** 2
    img = rng.integers(0, 256, (N_INPUTS, cfg.native_height, cfg.native_width, 3), np.uint8)
    hist = (1.0 + 2.0 * rng.random((N_INPUTS, zones, cfg.zone_sample_num))).astype(np.float32)
    mask = np.ones((N_INPUTS, zones), bool)
    mask[1, 0] = False  # one invalid zone exercises the mask path
    return img, hist, mask


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The flax tree, its port state_dict, the inputs, and the artifacts:
    the port's in the 'validate' protocol at bs (1, 2), in 'evaluate_all'
    at bs 1 and in bf16 'validate' at bs 1; the JAX package's in each
    protocol at bs 1."""
    jcfg = jx_parse_config(TINY_ARGS).replace(mode="online_eval")
    pcfg = pt_parse_config(TINY_ARGS).replace(mode="online_eval")
    jmodel = jx_make_model(jcfg, tiny=True)
    Z = jcfg.eval_zone_num ** 2
    shapes = jax.eval_shape(
        lambda r: jmodel.init({"params": r, "fusion": r},
                              jnp.zeros((1, jcfg.native_height, jcfg.native_width, 3)),
                              jnp.zeros((1, Z, jcfg.zone_sample_num)), jnp.ones((1, Z), bool),
                              jx_geometries(jcfg, "online_eval")), jax.random.key(0))
    tree = random_tree(shapes, 1, kernel_std=0.05, dtype=np.float32)
    sd = weights.from_flax(tree["params"], tree["batch_stats"], pcfg)
    root = tmp_path_factory.mktemp("serving")
    out = dict(jcfg=jcfg, pcfg=pcfg, tree=tree, sd=sd, inputs=_inputs(pcfg), root=root)
    for name, protocol, sizes in (("validate", "validate", (1, 2)),
                                  ("evaluate_all", "evaluate_all", (1,))):
        out[f"jax_{name}"] = str(root / f"jax_{name}")
        jx_export.export_serving_artifact(jcfg, tree["params"], tree["batch_stats"],
                                          out[f"jax_{name}"], batch_sizes=(1,),
                                          protocol=protocol, platforms=("cpu",), tiny=True)
        out[name] = str(root / name)
        pt_export.export_serving_artifact(pcfg, sd, out[name], batch_sizes=sizes,
                                          protocol=protocol, device="cpu", tiny=True)
    out["bf16"] = str(root / "bf16")
    pt_export.export_serving_artifact(pcfg, sd, out["bf16"], batch_sizes=(1,), device="cpu",
                                      tiny=True, compute_dtype="bfloat16")
    out["models"] = {k: pt_export.ServingModel(out[k], "cpu")
                     for k in ("validate", "evaluate_all", "bf16")}
    return out


@pytest.mark.parametrize("protocol", ["validate", "evaluate_all"])
def test_artifact_matches_the_jax_artifact(served, protocol):
    """(a) The port's f32 artifact against the JAX package's, both on the
    CPU, on the same weights and uint8 inputs."""
    img, hist, mask = served["inputs"]
    want = jx_export.ServingModel(served[f"jax_{protocol}"]).predict(img, hist, mask)
    got = served["models"][protocol].predict(img, hist, mask)
    assert got.shape == want.shape == (N_INPUTS, 64, 96) and got.dtype == np.float32
    gap = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    print(f"{protocol}: max |port - JAX| = {gap:.3e}, max |JAX| = {scale:.3f}, "
          f"ratio {gap / scale:.3e}")
    assert gap <= 1e-4 * scale


@pytest.mark.parametrize("name,dtype", [("validate", torch.float32), ("bf16", torch.bfloat16)])
def test_artifact_equals_the_live_eval_step(served, name, dtype):
    """(b) The artifact computes what the live ``make_eval_step`` computes on
    the model cast to the same dtype, bit for bit, batch by batch as
    ``predict`` chunks the inputs (5 rows through the exported sizes)."""
    cfg = served["pcfg"]
    model = pt_make_model(cfg, tiny=True, device="cpu")
    model.load_state_dict(served["sd"], strict=True)
    cast_to_compute_dtype(model, dtype)
    step = pt_steps.make_eval_step(model, cfg, pt_geometries(cfg, "online_eval"),
                                   protocol="validate", compute_dtype=dtype)
    m = served["models"][name]
    img, hist, mask = served["inputs"]
    got = m.predict(img, hist, mask)
    i = 0
    while i < N_INPUTS:
        n = min(m.batch_sizes[-1], N_INPUTS - i)
        rows = slice(i, i + n)
        batch = {"image_u8": torch.from_numpy(img[rows]), "hist_data": torch.from_numpy(hist[rows]),
                 "mask": torch.from_numpy(mask[rows])}
        want = step(batch)[0][..., 0].numpy()
        np.testing.assert_array_equal(got[rows], want, err_msg=f"{name} rows {rows}")
        i += n


def test_graph_calls_the_three_custom_ops(served):
    """(c) Each program calls cfpnet::linear_attention, cfpnet::dwconv2d and
    cfpnet::fused_loftr (3 / 3 / 9 in the tiny model, which has half the
    production fusion layers), the manifest says so, and no plain twin
    stands in for them: the twins' elu+1 feature map appears nowhere else
    in the model, and the k=15 depthwise twin alone would be 225 products."""
    m = served["models"]["validate"]
    assert m.manifest["custom_ops"] == {"1": OPS, "2": OPS}
    for bs in m.batch_sizes:
        program = m.exported(bs)
        assert pt_export.custom_op_calls(program) == OPS
        targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        assert "aten.elu.default" not in targets
        assert targets.count("aten.mul.Tensor") < 225


def test_an_export_leaves_the_live_forward_as_it_was(served):
    """(d) The tensor caches that a trace fills (``ops/interp.py``'s resize
    matrices, ``train/steps.py``'s ImageNet statistics) keep nothing that
    the export made: emptied before it, they hold real tensors after it
    (the program's constants), and the live forward after it equals the
    forward before it, a real tensor. Before the repair the cached
    matrices were the trace's fake tensors."""
    from torch._subclasses.fake_tensor import is_fake

    cfg = served["pcfg"]
    model = pt_make_model(cfg, tiny=True, device="cpu")
    model.load_state_dict(served["sd"], strict=True)
    step = pt_steps.make_eval_step(model, cfg, pt_geometries(cfg, "online_eval"),
                                   protocol="validate")
    img, hist, mask = (torch.from_numpy(a[:1]) for a in served["inputs"])
    batch = {"image_u8": img, "hist_data": hist, "mask": mask}
    before = step(batch)[0]
    interp._DEVICE_MATRICES.clear()
    pt_steps._IMAGENET_STATS.clear()
    fwd = pt_export.make_serving_forward(model, cfg, pt_geometries(cfg, "online_eval"))
    with torch.no_grad():
        program = torch.export.export(fwd, (img, hist, mask), strict=False)
    kept = list(interp._DEVICE_MATRICES.values()) + list(pt_steps._IMAGENET_STATS.values())
    assert len(kept) > 2 and not any(is_fake(t) for t in kept)
    after = step(batch)[0]
    assert type(after) is torch.Tensor
    torch.testing.assert_close(after, before, rtol=0, atol=0)
    torch.testing.assert_close(program.module()(img, hist, mask), before[..., 0], rtol=0, atol=0)


@pytest.mark.parametrize("n,sizes", [(5, [1, 2]), (3, [1, 8]), (9, [2, 4]), (1, [4]),
                                     (7, [1, 2, 4])])
def test_padding_and_chunking_take_the_jax_sizes(n, sizes):
    """(e) ``_chunked`` runs the same (batch size, pad) chunks as the JAX
    class's, pads with zero images and all-invalid masks, and returns each
    row's own output."""
    img, hist, mask = _mb_inputs(n, v=1, zones=4, s=3)
    img = img + np.arange(n, dtype=np.uint8)[:, None, None, None]  # no real row is zero

    def recorder(seen):
        def run(i, h, m):
            seen.append((i.shape[0], int((i.reshape(i.shape[0], -1) == 0).all(1).sum()),
                         int((~m).all(1).sum())))
            return i[:, :, :, 0].astype(np.float32)
        return run

    got, want = [], []
    out = pt_export.ServingModel._chunked(None, img, hist, mask, sizes, recorder(got))
    jx_export.ServingModel._chunked(None, img, hist, mask, sizes, recorder(want))
    assert got == want
    np.testing.assert_array_equal(out, img[:, :, :, 0].astype(np.float32))
    # the rows a chunk pads are zero images with all-invalid masks
    padded = sum(b for b, _, _ in got) - n
    assert sum(p for _, p, _ in got) == sum(i for _, _, i in got) == padded


def test_predict_pads_and_chunks_rows_through_the_artifact(served):
    """Five rows through the exported sizes (1, 2) give each row what a
    lone predict of it gives."""
    m = served["models"]["validate"]
    img, hist, mask = served["inputs"]
    full = m.predict(img, hist, mask)
    for i in range(N_INPUTS):
        one = m.predict(img[i:i + 1], hist[i:i + 1], mask[i:i + 1])
        np.testing.assert_allclose(full[i], one[0], rtol=1e-5, atol=1e-5)


def test_manifest_geometry_equals_the_jax_manifests(served, tmp_path):
    """(f) The config grid: the port's manifest fields against the JAX
    artifact's. A measured rig: ``export_serving --dataset_eval zjuL5`` on
    a fabricated off-center ZJUL5 tree bakes the rig's rects, and its
    manifest geometry equals the JAX ``geometry_dict`` of the JAX dataset's
    ``scale_geoms``."""
    with open(os.path.join(served["jax_evaluate_all"], "manifest.json")) as f:
        jman = json.load(f)
    pman = served["models"]["evaluate_all"].manifest
    assert pman["geometry"] == jman["geometry"]
    for key in ("protocol", "compute_dtype", "batch_sizes", "input", "output", "n_bins",
                "files"):
        assert key in pman
    assert {k: pman[k] for k in ("protocol", "compute_dtype", "batch_sizes", "input",
                                 "n_bins")} == {k: jman[k] for k in ("protocol", "compute_dtype",
                                                                     "batch_sizes", "input",
                                                                     "n_bins")}
    assert pman["format"] == "cfpnet-torch-serving-v1" != jman["format"]

    from cfpnet_tpu.data.datasets import ZJUL5Dataset as JxZJUL5Dataset

    d = tmp_path / "zju"
    _fabricate_zju_tree(d)
    zflags = ["--dataset_eval", "zjuL5", "--data_path_eval", str(d),
              "--filenames_file_eval", str(d / "data.json")]
    dst = str(tmp_path / "measured")
    pt_export_serving.main(["--random_init", "--tiny", "--dst", dst, "--device", "cpu"]
                           + TINY_ARGS + zflags)
    with open(os.path.join(dst, "manifest.json")) as f:
        man = json.load(f)
    jcfg = jx_parse_config(TINY_ARGS + zflags)
    want = jx_export.geometry_dict(JxZJUL5Dataset(jcfg.replace(mode="online_eval")).scale_geoms)
    assert man["geometry"]["source"] == "measured:zjuL5"
    assert man["geometry"]["scales"] == json.loads(json.dumps(want))
    assert man["geometry"]["scales"] != pman["geometry"]["scales"]


def test_refusals(served, tmp_path):
    """(g) The geometry and batch-size ``ValueError``s of
    ``artifact_eval_steps``, a device other than the manifest's, and
    ``predict_sharded`` over devices that no exported size splits into
    exported shares; over the one CPU it is ``predict``."""
    from cfpnet_torch.data.datasets import SyntheticDataset
    from cfpnet_torch.data.pipeline import DataLoader, make_loader

    cfg = served["pcfg"]
    dst = served["validate"]
    d = tmp_path / "zju"
    _fabricate_zju_tree(d)
    zcfg = cfg.replace(dataset_eval="zjuL5", data_path_eval=str(d),
                       filenames_file_eval=str(d / "data.json"))
    with pytest.raises(ValueError, match="zone geometry"):
        pt_evaluate_all.artifact_eval_steps(zcfg, make_loader(zcfg, "online_eval", device="cpu"),
                                            dst, "cpu")
    loader = DataLoader(SyntheticDataset(cfg, "online_eval", length=3), 3)
    with pytest.raises(ValueError, match="eval_bs"):
        pt_evaluate_all.artifact_eval_steps(cfg, loader, dst, "cpu")
    with pytest.raises(ValueError, match="exported for cpu"):
        pt_export.ServingModel(dst, "cuda")
    with pytest.raises(KeyError, match="not exported"):
        served["models"]["validate"].exported(3)
    img, hist, mask = served["inputs"]
    m = served["models"]["validate"]
    with pytest.raises(ValueError, match="3-device mesh"):
        m.predict_sharded(img, hist, mask, devices=["cpu"] * 3)
    np.testing.assert_array_equal(m.predict_sharded(img, hist, mask), m.predict(img, hist, mask))


def test_predict_sharded_over_two_devices_and_the_sharded_server(served):
    """``predict_sharded`` over two CPU "devices": each bs-2 chunk split
    into two bs-1 shares, run through the bs-1 program, equals ``predict``
    (bs-2 and bs-1 programs) in float32 tolerance; over ``cpu:0``, through
    a replica whose programs ``move_to_device_pass`` placed there, bit for
    bit; ``--sharded``'s server (on the CPU artifact, the one CPU) answers
    as ``predict_sharded``."""
    img, hist, mask = served["inputs"]
    m = served["models"]["validate"]
    calls = []
    real = m.call
    m.call = lambda *a: calls.append(int(a[0].shape[0])) or real(*a)
    try:
        got = m.predict_sharded(img, hist, mask, devices=["cpu", "cpu"])
    finally:
        del m.call
    assert calls == [1] * (2 * -(-len(img) // 2))  # ceil(n / 2) chunks of two shares
    np.testing.assert_allclose(got, m.predict(img, hist, mask), rtol=1e-5, atol=1e-5)
    # a device named by its index gets a replica, its programs moved there
    np.testing.assert_array_equal(m.predict_sharded(img, hist, mask, devices=["cpu:0"]),
                                  m.predict(img, hist, mask))
    assert sorted(m._replicas) == ["cpu:0"] and m._replicas["cpu:0"]._placed
    server = pt_http.make_server(served["validate"], port=0, sharded=True, batch_wait_ms=0,
                                 device="cpu")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        depth = _post(f"http://127.0.0.1:{server.server_address[1]}",
                      dict(image_u8=img[:3], hist=hist[:3], mask=mask[:3]))
        np.testing.assert_array_equal(depth, m.predict_sharded(img[:3], hist[:3], mask[:3]))
    finally:
        server.shutdown()
        server.server_close()


def test_spatial_sweep_through_the_artifact_matches_the_root_driver(served, tmp_path,
                                                                   monkeypatch, capsys):
    """``--serving_artifact`` with ``--spatial_shards 2``: the root driver
    sweeps on a 1 x 2 mesh of its 8 devices (6 idle, said); the port, on
    four CPU devices standing in for the cards, checks each batch against
    a 1 x 2 grid (2 idle, said) and runs the artifact on the grid's root
    (ROADMAP §C): the root driver's metrics (3 images)."""
    import evaluate_all as jx_evaluate_all
    import cfpnet_tpu.train.loop as jx_loop
    from cfpnet_torch.parallel import spatial

    argv = TINY_ARGS + ["--tiny_model", "--test_dataset", "synthetic", "--synthetic_length", "3",
                        "--spatial_shards", "2"]
    seen = []
    evaluate = jx_loop.evaluate

    def recording(*a, **kw):
        seen.append(dict(evaluate(*a, **kw)))
        return seen[-1]

    monkeypatch.setattr(jx_loop, "evaluate", recording)
    monkeypatch.setattr(jx_evaluate_all, "evaluate", recording, raising=False)
    monkeypatch.setattr(sys, "argv", ["evaluate_all.py", *argv, "--serving_artifact",
                                      served["jax_validate"], "--save_dir", str(tmp_path / "jax")])
    jx_evaluate_all.main()
    assert "dp=1 x sp=2 uses 2 of 8 devices (6 idle)" in capsys.readouterr().out
    monkeypatch.setattr(spatial, "available_devices", lambda device: [torch.device("cpu")] * 4)
    out = pt_evaluate_all.main(argv + ["--serving_artifact", served["validate"], "--save_dir",
                                       str(tmp_path / "port"), "--device", "cpu"])
    assert "dp=1 x sp=2 uses 2 of 4 devices (2 idle)" in capsys.readouterr().out
    (want,), got = seen, out["metrics"][0]
    assert set(got) == set(want) and len(want) == 9
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_sweep_through_the_artifact_matches_the_root_driver(served, tmp_path, monkeypatch):
    """(h) ``python -m cfpnet_torch.evaluate_all ... --test_dataset synthetic
    --serving_artifact`` writes one row, epoch ``artifact``, whose metrics
    match the root ``evaluate_all.py --serving_artifact`` over the JAX
    artifact of the same weights (3 images)."""
    import evaluate_all as jx_evaluate_all
    import cfpnet_tpu.train.loop as jx_loop

    argv = TINY_ARGS + ["--tiny_model", "--test_dataset", "synthetic", "--synthetic_length", "3"]
    seen = []
    evaluate = jx_loop.evaluate

    def recording(*a, **kw):
        seen.append(dict(evaluate(*a, **kw)))
        return seen[-1]

    monkeypatch.setattr(jx_loop, "evaluate", recording)
    monkeypatch.setattr(jx_evaluate_all, "evaluate", recording, raising=False)
    monkeypatch.setattr(sys, "argv", ["evaluate_all.py", *argv, "--serving_artifact",
                                      served["jax_validate"], "--save_dir", str(tmp_path / "jax")])
    jx_evaluate_all.main()
    out = pt_evaluate_all.main(argv + ["--serving_artifact", served["validate"], "--save_dir",
                                       str(tmp_path / "port"), "--device", "cpu"])
    rows = {k: (tmp_path / k / "results.csv").read_text().strip().splitlines()
            for k in ("jax", "port")}
    assert rows["port"][0] == rows["jax"][0] == ",".join(["epoch"] + pt_evaluate_all.METRICS)
    assert len(rows["port"]) == len(rows["jax"]) == 2
    assert rows["port"][1].startswith("artifact,") and rows["jax"][1].startswith("artifact,")
    assert out["rows"][0][0] == "artifact" and out["weights"] == []
    assert os.path.getsize(out["reports"][1])
    (want,) = seen
    got = out["metrics"][0]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_timed_serving_on_the_cpu(served, capsys):
    """``evaluate_time --serving_artifact`` on the CPU: the host clock over
    the bs=1 program; the CLI prints the root's line."""
    out = pt_evaluate_time.main(["--serving_artifact", served["evaluate_all"], "--device", "cpu",
                                 "--niters", "4"] + TINY_ARGS)
    assert 0 < out["latency_ms_bs1"] < 60_000
    assert out["serving_artifact"] == served["evaluate_all"]
    assert capsys.readouterr().out.splitlines()[0] == \
        f"{out['latency_ms_bs1']:.3f} ms (serving artifact)"


def _post(base, arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(f"{base}/predict", data=buf.getvalue(), method="POST")
    with np.load(io.BytesIO(urllib.request.urlopen(req, timeout=120).read())) as z:
        return z["depth"]


def test_http_endpoint(served):
    """(i) A server on port 0 over the f32 artifact: /healthz, /manifest,
    /predict (one request of 3 rows, and 5 concurrent single-row requests
    coalesced by the micro-batcher) equal to ``ServingModel.predict``, and
    400 on a body that is no .npz."""
    img, hist, mask = served["inputs"]
    m = served["models"]["validate"]
    server = pt_http.make_server(served["validate"], port=0, batch_wait_ms=500.0, device="cpu")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert urllib.request.urlopen(f"{base}/healthz", timeout=60).read() == b"ok"
        manifest = json.loads(urllib.request.urlopen(f"{base}/manifest", timeout=60).read())
        assert manifest["format"] == "cfpnet-torch-serving-v1"
        depth = _post(base, dict(image_u8=img[:3], hist=hist[:3], mask=mask[:3]))
        np.testing.assert_array_equal(depth, m.predict(img[:3], hist[:3], mask[:3]))
        batches = server.batcher.batches_run
        results = [None] * N_INPUTS

        def one(i):
            results[i] = _post(base, dict(image_u8=img[i:i + 1], hist=hist[i:i + 1],
                                          mask=mask[i:i + 1]))

        threads = [threading.Thread(target=one, args=(i,)) for i in range(N_INPUTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i in range(N_INPUTS):
            np.testing.assert_allclose(results[i], m.predict(img[i:i + 1], hist[i:i + 1],
                                                             mask[i:i + 1]),
                                       rtol=1e-5, atol=1e-5)
        assert server.batcher.batches_run - batches < N_INPUTS
        bad = urllib.request.Request(f"{base}/predict", data=b"not an npz", method="POST")
        with pytest.raises(HTTPError) as ei:
            urllib.request.urlopen(bad, timeout=60)
        assert ei.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.close()


def test_microbatcher_slices_mixed_sizes():
    """(i) ``tests/test_serving.py``'s case on the port's MicroBatcher."""
    calls = []

    def fake_predict(img, hist, mask):
        calls.append(int(img.shape[0]))
        return img.astype(np.float32).mean(axis=(1, 2, 3))

    mb = pt_http.MicroBatcher(fake_predict, max_rows=8, max_wait_s=0.25)
    try:
        sizes = {0: 1, 1: 3, 2: 2}
        results = {}

        def one(i):
            results[i] = mb.submit(*_mb_inputs(sizes[i], v=10 * (i + 1)))

        threads = [threading.Thread(target=one, args=(i,)) for i in sizes]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        for i, n in sizes.items():
            np.testing.assert_array_equal(results[i], np.full(n, 10.0 * (i + 1), np.float32))
        assert mb.rows_run == 6
        assert mb.batches_run < 3, f"no coalescing: {calls}"
    finally:
        mb.close()


def test_microbatcher_error_isolated_to_batch():
    def fake_predict(img, hist, mask):
        if (img == 66).any():
            raise RuntimeError("boom")
        return np.zeros(img.shape[0], np.float32)

    mb = pt_http.MicroBatcher(fake_predict, max_rows=8, max_wait_s=0.0)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            mb.submit(*_mb_inputs(2, v=66))
        out = mb.submit(*_mb_inputs(1, v=5))
        np.testing.assert_array_equal(out, np.zeros(1, np.float32))
        assert mb.batches_run == 1 and mb.rows_run == 1
    finally:
        mb.close()


def test_microbatcher_close_joins_dispatcher():
    mb = pt_http.MicroBatcher(lambda i, h, m: np.zeros(i.shape[0], np.float32),
                              max_rows=4, max_wait_s=0.0)
    mb.submit(*_mb_inputs(1, v=1))
    mb.close()
    assert not mb._thread.is_alive()


NEW_MODULES = ("cfpnet_torch/serve/__init__.py", "cfpnet_torch/serve/export.py",
               "cfpnet_torch/serve/http.py", "cfpnet_torch/export_serving.py")


def test_new_modules_import_no_jax():
    """(j) ``tests/test_torch_port_bridge.py::test_port_imports_no_jax``
    reads every file of the port; these are this slice's. None names the
    JAX stack, and importing them with JAX made unimportable works."""
    for name in NEW_MODULES:
        path = ROOT / name
        assert path.is_file(), name
        assert not set(_imports(path)) & FORBIDDEN, name
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'cfpnet_tpu', 'tools'):\n"
            "    sys.modules[m] = None\n"
            "import cfpnet_torch.serve, cfpnet_torch.serve.export, cfpnet_torch.serve.http\n"
            "import cfpnet_torch.export_serving, cfpnet_torch.evaluate_all\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
