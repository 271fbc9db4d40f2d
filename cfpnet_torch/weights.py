"""Weight bridge between the JAX package's parameter trees and the port.

Port of the name map and layout transforms of
``tools/import_torch_weights.py`` (``reference_mapping`` and its helpers,
inverse ``export_reference_style``), kept here so the port imports nothing
of the JAX package or ``tools``. The port's parameter names are the
reference torch graph's, so

- ``from_flax(params, batch_stats, config)`` turns flax trees of numpy
  arrays into the port's ``state_dict``;
- ``loftr_params_from_flax(tree)`` turns one flax ``LoFTREncoderLayer``
  param dict into the fused LoFTR op's ``LoFTRParams``;
- ``flax_param_spec(config)`` lists every flax leaf (collection, path,
  shape in flax layout) of the model, without JAX, so that weights defined
  on flax paths can be rebuilt here (``deterministic_state_dict``);
- ``load_reference_checkpoint`` reads a reference-trained ``Deltar``
  checkpoint: ``module.`` prefixes, the reference's dead parameters and BN
  ``num_batches_tracked`` counters are dropped, the rest loads as is.

Layouts (flax -> torch): conv HWIO -> OIHW, depthwise [k,k,1,C] ->
[C,1,k,k], dense [I,O] -> [O,I], PointNet Conv1d [I,O] -> [O,I,1],
positional encodings [H,W,D] -> [H*W,D], BN/LN ``scale`` -> ``weight``,
``mean``/``var`` -> ``running_mean``/``running_var``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .models.deltar import make_model
from .models.efficientnetv2 import V2_B3_STAGES, V2_TINY_STAGES
from .ops.loftr import LoFTRParams

# kind: "conv" | "dwconv" | "dense" | "conv1d" | "raw" | ("pos", h, w)
Entry = Tuple[Tuple[str, ...], object, str]  # (flax path, kind, collection)


def _bn(tname: str, fname: str):
    return [
        (f"{tname}.weight", (fname, "scale"), "raw", "params"),
        (f"{tname}.bias", (fname, "bias"), "raw", "params"),
        (f"{tname}.running_mean", (fname, "mean"), "raw", "batch_stats"),
        (f"{tname}.running_var", (fname, "var"), "raw", "batch_stats"),
    ]


def _ln(tname: str, fname: str):
    return [
        (f"{tname}.weight", (fname, "scale"), "raw", "params"),
        (f"{tname}.bias", (fname, "bias"), "raw", "params"),
    ]


def _block_entries(block_kind: str):
    if block_kind == "cn":
        return [("conv.weight", ("conv", "kernel"), "conv", "params")] + _bn("bn1", "bn1")
    if block_kind == "er":
        return ([("conv_exp.weight", ("conv_exp", "kernel"), "conv", "params")]
                + _bn("bn1", "bn1")
                + [("conv_pwl.weight", ("conv_pwl", "kernel"), "conv", "params")]
                + _bn("bn2", "bn2"))
    return ([("conv_pw.weight", ("conv_pw", "kernel"), "conv", "params")]
            + _bn("bn1", "bn1")
            + [("conv_dw.weight", ("conv_dw", "kernel"), "dwconv", "params")]
            + _bn("bn2", "bn2")
            + [("se.conv_reduce.weight", ("se", "conv_reduce", "kernel"), "conv", "params"),
               ("se.conv_reduce.bias", ("se", "conv_reduce", "bias"), "raw", "params"),
               ("se.conv_expand.weight", ("se", "conv_expand", "kernel"), "conv", "params"),
               ("se.conv_expand.bias", ("se", "conv_expand", "bias"), "raw", "params"),
               ("conv_pwl.weight", ("conv_pwl", "kernel"), "conv", "params")]
            + _bn("bn3", "bn3"))


def _loftr_entries():
    e = [(f"{n}.weight", (n, "kernel"), "dense", "params")
         for n in ("q_proj", "k_proj", "v_proj", "merge")]
    e.append(("mlp.0.weight", ("mlp_0", "kernel"), "dense", "params"))
    e.append(("mlp.2.weight", ("mlp_1", "kernel"), "dense", "params"))
    return e + _ln("norm1", "norm1") + _ln("norm2", "norm2")


def loftr_params_from_flax(tree) -> LoFTRParams:
    """A flax ``LoFTREncoderLayer`` param dict (numpy arrays) -> the
    ``LoFTRParams`` that ``LoFTREncoderLayer.loftr_params`` gives once the
    same tree is loaded through ``from_flax``: [in, out] views of [out, in]
    storage, which the CUDA kernel takes as they are."""
    sd = {tkey: torch.from_numpy(np.ascontiguousarray(_to_torch_layout(
        np.asarray(tree[fpath[0]][fpath[1]]), kind))) for tkey, fpath, kind, _ in _loftr_entries()}
    return LoFTRParams(
        wq=sd["q_proj.weight"].t(), wk=sd["k_proj.weight"].t(), wv=sd["v_proj.weight"].t(),
        wm=sd["merge.weight"].t(), g1=sd["norm1.weight"], b1=sd["norm1.bias"],
        w0=sd["mlp.0.weight"].t(), w1=sd["mlp.2.weight"].t(),
        g2=sd["norm2.weight"], b2=sd["norm2.bias"])


def _block14_entries():
    e = [("dwconv2.weight", ("dwconv2_kernel",), "dwconv", "params"),
         ("dwconv2.bias", ("dwconv2_bias",), "raw", "params")]
    e += _bn("bn1", "bn1") + _ln("norm", "norm")
    for n in ("pwconv1", "pwconv2"):
        e.append((f"{n}.weight", (n, "kernel"), "dense", "params"))
        e.append((f"{n}.bias", (n, "bias"), "raw", "params"))
    return e


def _newcross_entries():
    # only q/k/v + conv1/bn1/conv2/bn2 run (reference transformer.py:204-248)
    e = [(f"{n}.weight", (n, "kernel"), "dense", "params")
         for n in ("q_proj", "k_proj", "v_proj")]
    e += [("conv1.weight", ("conv1", "kernel"), "conv", "params")] + _bn("bn1", "bn1")
    e += [("conv2.weight", ("conv2", "kernel"), "conv", "params")] + _bn("bn2", "bn2")
    return e


def _fusion_entries(layer_names, h: int, w: int) -> Dict[str, Entry]:
    out = {"positional_encodings": (("positional_encodings",), ("pos", h, w), "params"),
           "positional_encodings2": (("positional_encodings2",), "raw", "params")}
    for i, name in enumerate(layer_names):
        li = f"layers_{i}"
        if name == "hist2image":
            for tn, fp, kind, col in _loftr_entries():
                out[f"layers.{i}.{tn}"] = ((li,) + fp, kind, col)
        elif name == "image":
            for tn, fp, kind, col in _loftr_entries():
                for sub in ("lga", "gsa"):
                    out[f"layers.{i}.{sub}.encoder_layer.{tn}"] = (
                        (li, sub, "encoder_layer") + fp, kind, col)
            out[f"layers.{i}.gsa.sr.weight"] = ((li, "gsa", "sr", "kernel"), "conv", "params")
            out[f"layers.{i}.gsa.sr.bias"] = ((li, "gsa", "sr", "bias"), "raw", "params")
            for tn, fp, kind, col in _ln("norm", "norm"):
                out[f"layers.{i}.gsa.{tn}"] = ((li, "gsa") + fp, kind, col)
        elif name == "combine1":
            for tn, fp, kind, col in _newcross_entries():
                out[f"layers.{i}.transformer_path.{tn}"] = (
                    (li, "transformer_path") + fp, kind, col)
            for tn, fp, kind, col in _block14_entries():
                out[f"layers.{i}.large_kernel_path.{tn}"] = (
                    (li, "large_kernel_path") + fp, kind, col)
    return out


def name_map(config, stages=V2_B3_STAGES) -> Dict[str, Entry]:
    """Port (= reference torch) key -> (flax path, layout kind, collection)."""
    out: Dict[str, Entry] = {}
    bb = ("img_encoder", "backbone")
    out["img_encoder.conv0.0.weight"] = (bb + ("conv_stem", "kernel"), "conv", "params")
    for tn, fp, kind, col in _bn("conv0.1", "bn1"):
        out[f"img_encoder.{tn}"] = (bb + fp, kind, col)
    wrapper = {"conv0.2": 0, "conv1": 1, "conv2": 2, "conv3.0": 3, "conv3.1": 4, "conv4": 5}
    for prefix, si in wrapper.items():
        spec = stages[si]
        for bi in range(spec.repeats):
            for tn, fp, kind, col in _block_entries(spec.block):
                out[f"img_encoder.{prefix}.{bi}.{tn}"] = (bb + (f"blocks_{si}_{bi}",) + fp,
                                                          kind, col)

    for k in (1, 2, 3):
        base = f"hist_encoder.hist_extractor{k}.pointnet_encoder"
        ours = ("hist_encoder", f"hist_extractor{k}", "pointnet_encoder")
        for i in (1, 2, 3):
            out[f"{base}.conv{i}.weight"] = (ours + (f"conv{i}", "kernel"), "conv1d", "params")
            out[f"{base}.conv{i}.bias"] = (ours + (f"conv{i}", "bias"), "raw", "params")
            for tn, fp, kind, col in _bn(f"bn{i}", f"bn{i}"):
                out[f"{base}.{tn}"] = (ours + fp, kind, col)

    for name in ("conv4", "conv3", "conv2", "conv1", "conv0"):
        out[f"decoder.{name}.weight"] = (("decoder", name, "kernel"), "conv", "params")
        out[f"decoder.{name}.bias"] = (("decoder", name, "bias"), "raw", "params")
    for k in (1, 2, 3, 4):
        up, ours = f"decoder.up{k}._net", ("decoder", f"up{k}")
        for ti, fi, bn_t, bn_f in ((0, 0, "1", "bn0"), (3, 1, "4", "bn1")):
            out[f"{up}.{ti}.weight"] = (ours + (f"conv{fi}", "kernel"), "conv", "params")
            out[f"{up}.{ti}.bias"] = (ours + (f"conv{fi}", "bias"), "raw", "params")
            for tn, fp, kind, col in _bn(bn_t, bn_f):
                out[f"{up}.{tn}"] = (ours + fp, kind, col)

    nh, nw = config.native_height, config.native_width
    for name, scale in (("cross_atten1", 4), ("cross_atten2", 8), ("cross_atten3", 16)):
        for tn, (fp, kind, col) in _fusion_entries(config.attention_layer, nh // scale,
                                                   nw // scale).items():
            out[f"decoder.{name}.{tn}"] = (("decoder", name) + fp, kind, col)

    for cname in ("conv3x3", "conv1x1"):
        out[f"depth_head.{cname}.weight"] = (("depth_head", cname, "kernel"), "conv", "params")
    out["depth_head.conv3x3.bias"] = (("depth_head", "conv3x3", "bias"), "raw", "params")
    for i in (0, 2, 4):
        out[f"depth_head.regressor.{i}.weight"] = (
            ("depth_head", f"regressor_{i}", "kernel"), "dense", "params")
        out[f"depth_head.regressor.{i}.bias"] = (
            ("depth_head", f"regressor_{i}", "bias"), "raw", "params")
    out["conv_out.0.weight"] = (("conv_out", "kernel"), "conv", "params")
    out["conv_out.0.bias"] = (("conv_out", "bias"), "raw", "params")
    return out


def _to_torch_layout(a: np.ndarray, kind) -> np.ndarray:
    if kind in ("conv", "dwconv"):
        return np.transpose(a, (3, 2, 0, 1))
    if kind == "dense":
        return np.transpose(a, (1, 0))
    if kind == "conv1d":
        return np.transpose(a, (1, 0))[:, :, None]
    if kind == "raw":
        return a
    return a.reshape(-1, a.shape[-1])  # ("pos", h, w)


def _flax_shape(shape: Tuple[int, ...], kind) -> Tuple[int, ...]:
    if kind in ("conv", "dwconv"):
        return (shape[2], shape[3], shape[1], shape[0])
    if kind == "dense":
        return (shape[1], shape[0])
    if kind == "conv1d":
        return (shape[1], shape[0])
    if kind == "raw":
        return tuple(shape)
    return (kind[1], kind[2], shape[1])  # ("pos", h, w)


def from_flax(params, batch_stats, config) -> Dict[str, torch.Tensor]:
    """Flax ``params`` / ``batch_stats`` trees (nested dicts of arrays) ->
    the port's state_dict. Paths absent from the trees are skipped, so any
    backbone depth (full or tiny) maps with the same table."""
    trees = {"params": params, "batch_stats": batch_stats or {}}
    out = {}
    for tkey, (fpath, kind, col) in name_map(config).items():
        node = trees[col]
        for p in fpath:
            if not isinstance(node, dict) or p not in node:
                node = None
                break
            node = node[p]
        if node is None:
            continue
        out[tkey] = torch.from_numpy(np.ascontiguousarray(_to_torch_layout(np.asarray(node),
                                                                           kind)))
    return out


def flax_param_spec(config, tiny: bool = False) -> List[Tuple[str, Tuple[str, ...],
                                                             Tuple[int, ...]]]:
    """Every flax leaf of the model as (collection, path, shape in flax
    layout), in the port's state_dict order."""
    model = make_model(config, tiny=tiny, device="meta")  # shapes only, no memory
    table = name_map(config, V2_TINY_STAGES if (tiny or config.tiny_model) else V2_B3_STAGES)
    spec = []
    for tkey, t in model.state_dict().items():
        if tkey not in table:
            raise KeyError(f"port parameter {tkey} has no flax counterpart")
        fpath, kind, col = table[tkey]
        spec.append((col, fpath, _flax_shape(tuple(t.shape), kind)))
    return spec


def det_leaf(name: str, shape: Tuple[int, ...]) -> np.ndarray:
    """Deterministic, shape-derived leaf values (no RNG): the rule of the
    JAX package's golden tests (``tests/test_golden.py::_det_leaf``), keyed
    by the '/'-joined flax path."""
    size = int(np.prod(shape)) if shape else 1
    v = ((np.arange(size, dtype=np.float64) * 2654435761 % 97) / 97.0 - 0.5) * 0.1
    v = v.reshape(shape).astype(np.float32)
    if name.endswith("var"):
        v = np.abs(v) + 0.5
    if name.endswith("scale"):
        v = v + 1.0
    return v


def deterministic_state_dict(config, tiny: bool = False) -> Dict[str, torch.Tensor]:
    """The port's state_dict filled by ``det_leaf`` on every flax path: the
    weights of the JAX package's golden forwards."""
    trees: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for col, fpath, shape in flax_param_spec(config, tiny):
        node = trees[col]
        for p in fpath[:-1]:
            node = node.setdefault(p, {})
        node[fpath[-1]] = det_leaf("/".join((col,) + fpath), shape)
    return from_flax(trees["params"], trees["batch_stats"], config)


def _dead(key: str) -> bool:
    """Reference parameters that never execute: Block14.conv1 (convnext.py:38),
    layer-scale ``gamma``, and newcross9's LoFTR tail (transformer.py:183-194)."""
    if "large_kernel_path.conv1." in key or key.endswith(".gamma"):
        return True
    if key.endswith("num_batches_tracked"):
        return True
    if "transformer_path." in key:
        tail = key.split("transformer_path.", 1)[1]
        return tail.startswith(("merge.", "mlp.", "norm1.", "norm2."))
    return False


def load_reference_checkpoint(src) -> Dict[str, torch.Tensor]:
    """A reference ``Deltar`` checkpoint (path or loaded dict, optionally
    under ``"model"``, with DataParallel ``module.`` prefixes) -> a
    state_dict the port loads with ``load_state_dict(strict=True)``."""
    sd = torch.load(src, map_location="cpu", weights_only=True) if isinstance(src, str) else src
    if "model" in sd and hasattr(sd["model"], "items"):
        sd = sd["model"]
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if not _dead(k):
            out[k] = torch.as_tensor(v)
    return out


def _fields(node) -> Dict[str, object]:
    """The named children of an optax state node: a NamedTuple's fields or
    a dict's items; {} for anything else."""
    if hasattr(node, "_fields"):
        return {f: getattr(node, f) for f in node._fields}
    return dict(node) if isinstance(node, dict) else {}


def _children(node):
    if hasattr(node, "_fields") or isinstance(node, dict):
        return list(_fields(node).values())
    return list(node) if isinstance(node, (tuple, list)) else []


def _find(node, key):
    """Every value stored under ``key`` anywhere in ``node``, depth first."""
    found = []
    fields = _fields(node)
    if key in fields:
        found.append(fields[key])
    for child in _children(node):
        found.extend(_find(child, key))
    return found


def _array_leaves(tree):
    """A flax-shaped tree with optax's ``MaskedNode`` leaves (empty
    NamedTuples: the other group's parameters) left out."""
    if isinstance(tree, dict):
        out = {k: _array_leaves(v) for k, v in tree.items()}
        return {k: v for k, v in out.items() if not (isinstance(v, dict) and not v)}
    return {} if isinstance(tree, tuple) else np.asarray(tree)


def opt_state_from_optax(opt_state, config) -> Dict[str, dict]:
    """The JAX package's optax state (``train/optim.py::make_optimizer``:
    ``multi_transform`` of two ``inject_hyperparams(adamw)`` groups, after
    ``clip_by_global_norm`` unless ``--disable_clip_grad``), its leaves as
    numpy arrays, -> the state of the port's ``train/optim.py::AdamW``
    (``AdamW.load_state_dict``): each group's Adam moments under the port's
    parameter names and layouts (``from_flax``) and its count. Raises unless
    every count of a group (Adam's, the injector's, each schedule's) is the
    same, as the port keeps one."""
    inner = _find(opt_state, "inner_states")
    if len(inner) != 1:
        raise ValueError("not the optax state of make_optimizer: no single multi_transform")
    out = {}
    for group, gstate in _fields(inner[0]).items():
        nodes = [n for n in _all_nodes(gstate) if {"mu", "nu"} <= set(_fields(n))]
        if len(nodes) != 1:
            raise ValueError(f"group {group}: expected one Adam state, found {len(nodes)}")
        counts = {int(np.asarray(c)) for c in _find(gstate, "count")}
        if len(counts) != 1:
            raise ValueError(f"group {group}: counts differ: {sorted(counts)}")
        adam = _fields(nodes[0])
        out[group] = {"count": counts.pop(),
                      **{key: from_flax(_array_leaves(adam[key]), None, config)
                         for key in ("mu", "nu")}}
    return out


def _all_nodes(node):
    """Every node below ``node``, depth first."""
    out = []
    for child in _children(node):
        out.append(child)
        out.extend(_all_nodes(child))
    return out
