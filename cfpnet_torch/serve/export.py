"""Serving artifacts through ``torch.export``.

Port of ``cfpnet_tpu/serve/export.py`` (``geometry_dict``,
``make_serving_forward``, ``export_serving_artifact``, ``ServingModel``).
A serving artifact is a directory:

    manifest.json   shapes, dtypes, protocol, device, the custom ops each
                    program calls, file map
    fwd_bs{N}.pt2   one ``torch.export.save``d ``ExportedProgram`` per
                    exported batch size, the weights inside

The exported computation is the complete eval path: raw uint8 RGB in,
ImageNet normalization in f32 (``train/steps.py::normalize_image_u8``), the
image and histograms cast to the compute dtype, the forward on the model
cast to it (``models/deltar.py::cast_to_compute_dtype``), and the eval
protocol's post-processing (``train/steps.py::eval_prediction``, which
``make_eval_step`` runs too). Output is metric depth [B, H, W] in float32.

The JAX artifact is StableHLO for several platforms, and so it refuses the
Pallas kernels. This one is one device's (``cuda`` or ``cpu``, in the
manifest), and the reverse holds: its graph calls the three hand-written
kernels as the ``torch.library`` ops ``cfpnet::linear_attention``,
``cfpnet::dwconv2d`` and ``cfpnet::fused_loftr`` (6 / 6 / 18 calls in the
production model), which run the CUDA kernels on the card and their plain
versions on the CPU; a card's program also calls ``cfpnet::bn_act`` once a
BatchNorm (122 calls), where a CPU program has BatchNorm's plain formula
(``models/layers.py``). Neither package reads the other's artifact.

Batch sizes are static (one program per size): ``ServingModel.predict``
pads a partial batch to the smallest exported size that fits and chunks a
larger one, as the JAX class does. ``predict_sharded`` splits each batch
over the local cards, each running the program of its share on its own
copy of the artifact (JAX ``:273-315`` partitions one program instead). On the card each program's module is
captured once in a CUDA graph (``graphs.py::CapturedCall``), the
counterpart of the JAX artifact's compiled ``Exported.call``. Loading an
artifact needs ``cfpnet_torch.kernels`` importable: it registers the ops,
and builds the kernels from the repo's sources at their first call on the
card.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from collections import Counter
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .. import kernels  # noqa: F401  (registers the custom ops the programs call)
from ..graphs import CapturedCall
from ..kernels.dtypes import dtype_name
from ..models.deltar import (cast_to_compute_dtype, make_model, model_geometries,
                             require_deltar)
from ..models.deltar import compute_dtype as dtype_of
from ..train import steps

MANIFEST_NAME = "manifest.json"
FORMAT = "cfpnet-torch-serving-v1"
CUSTOM_OPS = ("cfpnet::linear_attention", "cfpnet::dwconv2d", "cfpnet::fused_loftr",
              "cfpnet::bn_act")


def geometry_dict(geoms) -> Dict[str, dict]:
    """JSON form of a per-scale geometry map ({conv_patch_size:
    ScaleGeometry}), the JAX package's: recorded in the manifest so that
    artifact-backed evaluation can check the exported zone geometry against
    the eval dataset's (measured ZJUL5 rigs against the config grid)."""
    return {str(cps): dataclasses.asdict(g) for cps, g in sorted(geoms.items())}


class ServingForward(nn.Module):
    """``(image_u8, hist, mask) -> depth_m``: the eval step's arithmetic on a
    uint8 image (``make_serving_forward``)."""

    def __init__(self, model: nn.Module, config, geoms, dtype: torch.dtype, protocol: str):
        super().__init__()
        self.model = model
        self.config, self.geoms, self.dtype, self.protocol = config, geoms, dtype, protocol

    def forward(self, image_u8: torch.Tensor, hist: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        image = steps.normalize_image_u8(image_u8)
        pred, _ = steps.eval_prediction(self.model, self.config, self.geoms, self.protocol,
                                        image, hist, mask, self.dtype)
        return pred[..., 0].to(torch.float32)


def make_serving_forward(model: nn.Module, config, geoms, compute_dtype=None,
                         protocol: str = "validate") -> ServingForward:
    """The module ``(image_u8, hist, mask) -> depth_m`` over ``model``'s
    weights. image_u8: [B,H,W,3] uint8 raw RGB; hist: [B,Z,S] f32 sampled
    depth points; mask: [B,Z] bool valid zones. Returns [B,H,W] f32 meters.

    The body is the eval step's (``train/steps.py::make_eval_step`` with
    ``compute_dtype``): normalize as ``eval_batch_image`` does, cast image
    and histograms to ``compute_dtype`` (default ``config.compute_dtype``),
    the forward with ``geoms`` closed over, then the protocol's
    post-processing. A model whose parameters are in another dtype is
    copied and the copy cast (``cast_to_compute_dtype``); ``model`` itself
    is left as it is."""
    dtype = dtype_of(compute_dtype or config.compute_dtype)
    if next(model.parameters()).dtype != dtype:
        model = cast_to_compute_dtype(copy.deepcopy(model), dtype)
    return ServingForward(model.eval(), config, geoms, dtype, protocol)


def custom_op_calls(program) -> Dict[str, int]:
    """Calls of each of ``CUSTOM_OPS`` in an ``ExportedProgram``'s graph."""
    ops = {getattr(torch.ops.cfpnet, name.split("::")[1]).default: name for name in CUSTOM_OPS}
    calls = Counter(ops[n.target] for n in program.graph.nodes
                    if n.op == "call_function" and n.target in ops)
    return {name: calls[name] for name in CUSTOM_OPS}


def export_serving_artifact(
    config,
    state_dict,
    dst: str,
    batch_sizes: Sequence[int] = (1,),
    compute_dtype: Optional[str] = None,
    protocol: str = "validate",
    device="cuda",
    tiny: bool = False,
    geoms=None,
    geometry_source: str = "config",
) -> str:
    """Export the eval path for each batch size on ``device``; write ``dst/``.

    Returns the manifest path. The weights (``state_dict``, cast to the
    compute dtype) are inside each program, so ``dst`` is the complete
    deployable unit for that device.

    ``geoms`` overrides the config-derived zone geometry: pass a dataset's
    measured ``scale_geoms`` (ZJUL5 ``fr`` rects) to bake the real rig's
    zone-to-pixel mapping into the artifact, as the live eval driver uses
    it. The zone count of the hist input follows the geometry, and the
    geometry is recorded in the manifest for pre-deployment validation
    (``evaluate_all.artifact_eval_steps``).
    """
    require_deltar(config, "serving export")
    config = config.replace(mode="online_eval")
    device = torch.device(device)
    model = make_model(config, tiny=tiny, device=device)
    model.load_state_dict(state_dict, strict=True)
    if geoms is None:
        geoms = model_geometries(config, "online_eval")
    h, w = config.native_height, config.native_width
    zn = next(iter(geoms.values())).zone_num
    zones, s = zn * zn, config.zone_sample_num
    dtype = dtype_of(compute_dtype or config.compute_dtype)
    fwd = make_serving_forward(model, config, geoms, compute_dtype=dtype, protocol=protocol)

    os.makedirs(dst, exist_ok=True)
    files: Dict[str, str] = {}
    op_calls: Dict[str, Dict[str, int]] = {}
    for bs in sorted(set(int(b) for b in batch_sizes)):
        args = (torch.zeros(bs, h, w, 3, dtype=torch.uint8, device=device),
                torch.full((bs, zones, s), 2.0, dtype=torch.float32, device=device),
                torch.ones(bs, zones, dtype=torch.bool, device=device))
        with torch.no_grad():
            program = torch.export.export(fwd, args, strict=False)
        fname = f"fwd_bs{bs}.pt2"
        torch.export.save(program, os.path.join(dst, fname))
        files[str(bs)] = fname
        op_calls[str(bs)] = custom_op_calls(program)

    manifest = {
        "format": FORMAT,
        "device": device.type,
        "protocol": protocol,
        "compute_dtype": dtype_name(dtype),
        "batch_sizes": sorted(int(b) for b in files),
        "input": {
            "image_u8": [None, h, w, 3],
            "hist": [None, zones, s],
            "mask": [None, zones],
        },
        "output": "depth_m [B, H, W] float32",
        "geometry": {
            "source": geometry_source,
            "zone_num": zn,
            "scales": geometry_dict(geoms),
        },
        "n_bins": int(config.n_bins),
        "torch_version": torch.__version__,
        "custom_ops": op_calls,
        "files": files,
    }
    mpath = os.path.join(dst, MANIFEST_NAME)
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=2)
    return mpath


class ServingModel:
    """Load a serving artifact and predict, with no model code of its own.

    >>> m = ServingModel("artifacts/cfpnet", "cuda")
    >>> depth = m.predict(image_u8, hist, mask)   # [N,H,W] f32 meters

    ``device`` must be of the manifest's type (default: the manifest's
    device; a card with an index, such as ``cuda:1``, gets the programs
    moved there, ``torch.export.passes.move_to_device_pass``). Partial
    batches are
    padded to the smallest exported batch size that fits (padding rows are
    zero images with all-invalid masks) and the result sliced back; N larger
    than the largest exported size is chunked. On the card each batch size's
    program runs as one CUDA graph replay (``captured``), captured at its
    first use.
    """

    def __init__(self, path: str, device=None):
        self.path = path
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format") != FORMAT:
            raise ValueError(f"not a {FORMAT} artifact: {self.manifest.get('format')!r}")
        self.device = torch.device(self.manifest["device"])
        if device is not None and torch.device(device).type != self.device.type:
            raise ValueError(f"{path} was exported for {self.device.type} and cannot run on "
                             f"{torch.device(device)}: export it again with --device "
                             f"{torch.device(device).type}")
        # a card named by its index: the programs are moved to it
        self._placed = device is not None and torch.device(device).index is not None
        if self._placed:
            self.device = torch.device(device)
        self._replicas: Dict[str, "ServingModel"] = {}
        self.batch_sizes = sorted(int(b) for b in self.manifest["files"])
        self._programs: Dict[int, object] = {}
        self._modules: Dict[int, nn.Module] = {}
        self._graphs: Dict[int, CapturedCall] = {}

    def exported(self, batch_size: int):
        """The loaded ``torch.export.ExportedProgram`` of one exported batch
        size."""
        if batch_size not in self.batch_sizes:
            raise KeyError(
                f"batch size {batch_size} not exported; have {self.batch_sizes}")
        if batch_size not in self._programs:
            fname = self.manifest["files"][str(batch_size)]
            program = torch.export.load(os.path.join(self.path, fname))
            if self._placed:
                from torch.export.passes import move_to_device_pass

                program = move_to_device_pass(program, self.device)
            self._programs[batch_size] = program
        return self._programs[batch_size]

    def module(self, batch_size: int) -> nn.Module:
        """The runnable module of ``exported(batch_size)``, made once."""
        if batch_size not in self._modules:
            self._modules[batch_size] = self.exported(batch_size).module()
        return self._modules[batch_size]

    def captured(self, batch_size: int) -> CapturedCall:
        """``module(batch_size)`` captured in a CUDA graph over static input
        buffers (a zero image, histograms of 2.0, all zones valid), made
        once; on a card artifact only."""
        if batch_size not in self._graphs:
            spec = self.manifest["input"]
            h, w = spec["image_u8"][1:3]
            zones, s = spec["hist"][1:3]
            inputs = (torch.zeros(batch_size, h, w, 3, dtype=torch.uint8, device=self.device),
                      torch.full((batch_size, zones, s), 2.0, device=self.device),
                      torch.ones(batch_size, zones, dtype=torch.bool, device=self.device))
            self._graphs[batch_size] = CapturedCall(self.module(batch_size), inputs,
                                                    ("image_u8", "hist", "mask"))
        return self._graphs[batch_size]

    def call(self, image_u8: torch.Tensor, hist: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
        """Depth [B,H,W] f32 of tensors on the artifact's device at an
        exported batch size B: a replay of the batch size's graph on the
        card (its output cloned), the program's module on the CPU."""
        bs = int(image_u8.shape[0])
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):  # the kernels launch on the current card
                return self.captured(bs)(image_u8, hist, mask).clone()
        with torch.no_grad():
            return self.module(bs)(image_u8, hist, mask)

    def _predict_exact(self, image_u8, hist, mask) -> np.ndarray:
        tensors = (torch.from_numpy(a).to(self.device) for a in (image_u8, hist, mask))
        return self.call(*tensors).cpu().numpy()

    def _chunked(self, image_u8, hist, mask, sizes, run) -> np.ndarray:
        """Pad/chunk ``n`` samples through the exported sizes ``sizes``,
        calling ``run(img, hist, mask)`` per exact-size chunk."""
        image_u8 = np.ascontiguousarray(image_u8, np.uint8)
        hist = np.ascontiguousarray(hist, np.float32)
        mask = np.ascontiguousarray(mask, bool)
        n = image_u8.shape[0]
        outs = []
        i = 0
        while i < n:
            take = min(n - i, sizes[-1])
            bs = next(b for b in sizes if b >= take)
            take = min(take, bs)
            pad = bs - take

            def pick(a):
                chunk = a[i:i + take]
                if pad:
                    z = np.zeros((pad,) + a.shape[1:], a.dtype)
                    chunk = np.concatenate([chunk, z], axis=0)
                return chunk

            pred = np.asarray(run(pick(image_u8), pick(hist), pick(mask)))
            outs.append(pred[:take])
            i += take
        return np.concatenate(outs, axis=0)

    def predict(self, image_u8, hist, mask) -> np.ndarray:
        return self._chunked(image_u8, hist, mask, self.batch_sizes, self._predict_exact)

    def replica(self, device) -> "ServingModel":
        """This artifact on ``device``, a device of its type: itself where
        ``device`` is its own, else a ``ServingModel`` placed there, loaded
        once."""
        device = torch.device(device)
        if device == self.device:
            return self
        if str(device) not in self._replicas:
            self._replicas[str(device)] = ServingModel(self.path, device)
        return self._replicas[str(device)]

    def predict_sharded(self, image_u8, hist, mask, devices=None) -> np.ndarray:
        """Data-parallel predict over several devices (JAX ``:273-315``).

        ``devices`` defaults to the local cards, as many as
        ``parallel/mesh.py::dp_world_size`` allows for the largest exported
        size (one card, or a CPU artifact: ``predict``). Each batch of an
        exported size
        ``b`` divisible by their number n, whose share ``b / n`` is exported
        too, is split by rows: device i runs rows ``[i * b / n, (i + 1) * b
        / n)`` through its replica's program of that size (``replica``), all
        launched before any is read. Partial batches pad and chunk as in
        ``predict``, over those sizes only; ``ValueError`` where none fits.
        With one device it is ``predict``. The programs of the shares are
        not the whole batch's, so the result matches ``predict`` to the
        reassociation of float32 sums, not bit for bit."""
        from ..parallel.mesh import dp_world_size

        if devices is None:
            cards = torch.cuda.device_count() if self.device.type == "cuda" else 1
            n = dp_world_size(0, cards, self.batch_sizes[-1])
            if n == 1:
                return self.predict(image_u8, hist, mask)
            devices = [torch.device("cuda", i) for i in range(n)]
        replicas = [self.replica(d) for d in devices]
        n = len(replicas)
        if n == 1:
            return replicas[0].predict(image_u8, hist, mask)
        sizes = [b for b in self.batch_sizes if b % n == 0 and b // n in self.batch_sizes]
        if not sizes:
            raise ValueError(
                f"no exported batch size in {self.batch_sizes} is divisible by the {n}-device "
                f"mesh into exported shares; re-export with a divisible --serve_batch_sizes "
                f"or pass fewer devices")

        def run(img, hh, mm):
            per = img.shape[0] // n
            outs = [r.call(*(torch.from_numpy(a[i * per:(i + 1) * per]).to(r.device)
                             for a in (img, hh, mm)))
                    for i, r in enumerate(replicas)]
            return np.concatenate([o.cpu().numpy() for o in outs])

        return self._chunked(image_u8, hist, mask, sizes, run)
