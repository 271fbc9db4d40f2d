"""TransformerFusion: per-scale fusion of image features with zone histogram
features.

Port of ``cfpnet_tpu/models/fusion.py::TransformerFusion`` (reference
src/models/fusion.py:12-188), for every layer name the JAX package builds,
chosen by the same tests in the same order (``layer_kind``): ``image``,
``hist2image``, then any name holding ``new_cross`` (one bare
``LoFTRNewCross9``), ``combine`` (``combine1``: one ``Combine1``;
``combine_N``, any name with a ``_``: N of them in sequence), ``cvxt``
(``Block14`` on the 2-D map, ``cvxt_N`` N of them); any other name raises.

- The reference cannot construct ``new_cross``, ``combine_N`` or
  ``cvxt[_N]`` (its constructor raises), so it has no torch keys for them.
  The port's keys follow the flax names one index for one index: flax
  ``layers_{i}`` is ``layers.{i}.*`` and flax ``layers_{i}_{j}`` is
  ``layers.{i}.{j}.*`` (an ``nn.ModuleList``). So ``weights.py`` maps them
  by one rule, and ``combine_1`` keeps the ``.0`` that flax's
  ``layers_{i}_0`` has, while ``cvxt_1`` is ``layers.{i}.*`` as flax's
  ``layers_{i}`` is.

- All zone geometry arrives as a static ``ScaleGeometry``, so every slice,
  pad and reshape has a fixed shape.
- The ``hist2image`` write-back is a static-rectangle slice assignment.
- The train-time positional-encoding crop draws from an explicit CPU
  ``torch.Generator`` (``crop_offsets``) and slices; given ``DeviceCrops``
  instead (a CUDA graph of the train step), it gathers the crop's rows at
  offsets held on the device; without either (eval) the crop is centered.
- Invalid zones are zeroed after cross-attention by a per-zone multiply.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..data.geometry import ScaleGeometry
from ..ops.interp import device_constant, resize_bilinear_align_corners
from .convnext import Block14
from .transformer import (Combine1, LoFTREncoderLayer, LoFTRNewCross9, TwinsTransformer,
                          twins_window_size)


def crop_offsets(H: int, W: int, maxH: int, maxW: int,
                 generator: Optional[torch.Generator] = None) -> Tuple[int, int]:
    """Top-left corner of the H x W crop of the maxH x maxW positional
    encoding: uniform over every position (``cfpnet_tpu/models/fusion.py:80-93``,
    ``jax.random.randint`` from the 'fusion' RNG), or centered without a
    generator. ``generator`` is a CPU ``torch.Generator`` on the host: the
    draws are Python ints that slice the encoding, so a CUDA generator would
    cost a stream sync a layer. The train step seeds one a step
    (``train/steps.py::step_generator``). The JAX package's draws cannot be
    matched bit for bit; the tests pin both sides to the same offsets."""
    if generator is None:
        return (maxH - H) // 2, (maxW - W) // 2
    off_y = int(torch.randint(0, maxH - H + 1, (), generator=generator))
    off_x = int(torch.randint(0, maxW - W + 1, (), generator=generator))
    return off_y, off_x


CropShape = Tuple[int, int, int, int]  # (H, W, maxH, maxW) of one crop

_CROP_ROWS: Dict[tuple, torch.Tensor] = {}


def _crop_rows(H: int, W: int, maxW: int, device) -> torch.Tensor:
    """The rows ``i * maxW + j`` (i < H, j < W) of the flattened encoding
    that the crop at offset (0, 0) takes, int64 on ``device``, made once."""
    return device_constant(
        _CROP_ROWS, (H, W, maxW, device),
        lambda: (torch.arange(H)[:, None] * maxW + torch.arange(W)).reshape(-1).to(device))


class DeviceCrops:
    """The positional-encoding crops of one train step at offsets held on
    the device, for a step whose host does not see them (a CUDA graph's
    replay, ``graphs.py::CapturedTrainStep``). A fusion given one in place
    of a generator takes its crops in call order: crop i starts at row
    ``starts[i] = off_y * maxW + off_x`` of the flattened ``[maxH * maxW, C]``
    encoding and gathers the rows ``starts[i] + _crop_rows``, the values the
    slice at (off_y, off_x) takes; the rows of one crop are distinct, so the
    gather's gradient writes each row once into zeros, the slice's gradient.

    ``starts``: an int64 device tensor of the step's starts, written before
    the step runs (``crop_starts``). Or ``generator``: a CPU generator that
    each crop draws from as it comes (``crop_offsets``), the draws of the
    eager step in the same order. ``shapes`` records each crop taken, which
    ``crop_starts`` draws for."""

    def __init__(self, starts: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        if (starts is None) == (generator is None):
            raise ValueError("DeviceCrops takes the starts or a generator")
        self.starts, self.generator = starts, generator
        self.shapes: List[CropShape] = []

    def crop(self, pos: torch.Tensor, H: int, W: int) -> torch.Tensor:
        """The next crop, [H, W, C], of ``pos`` [maxH, maxW, C]."""
        maxH, maxW, C = pos.shape
        i = len(self.shapes)
        self.shapes.append((H, W, maxH, maxW))
        if self.generator is None:
            start = self.starts[i]
        else:
            start = torch.full((), crop_starts(self.shapes[-1:], self.generator)[0],
                               dtype=torch.int64, device=pos.device)
        rows = _crop_rows(H, W, maxW, pos.device) + start
        return pos.reshape(maxH * maxW, C).index_select(0, rows).reshape(H, W, C)


def crop_starts(shapes: Sequence[CropShape], generator: torch.Generator) -> List[int]:
    """The starts (``DeviceCrops``) of crops of ``shapes``, in order, from
    the offsets that ``crop_offsets`` draws from ``generator``: the eager
    step's draws for the same crops."""
    starts = []
    for H, W, maxH, maxW in shapes:
        off_y, off_x = crop_offsets(H, W, maxH, maxW, generator)
        starts.append(off_y * maxW + off_x)
    return starts


def layer_kind(name: str) -> Tuple[str, Optional[int]]:
    """(kind, n) of a fusion layer name, by the tests of
    ``cfpnet_tpu/models/fusion.py:106-192`` in their order. n is None where
    flax builds one sublayer named ``layers_{i}`` and the number of
    sublayers where it names them ``layers_{i}_{j}``: ``combine_N`` (any
    ``combine`` name with a ``_``, N = 1 included) and ``cvxt_N`` with N > 1."""
    if name in ("image", "hist2image"):
        return name, None
    if "new_cross" in name:
        return "new_cross", None
    if "combine" in name:
        return "combine", int(name.split("_")[-1]) if "_" in name else None
    if "cvxt" in name:
        reps = int(name.split("_")[-1]) if "_" in name else 1
        return "cvxt", None if reps == 1 else reps
    raise NotImplementedError(f"attention layer '{name}'")


class TransformerFusion(nn.Module):
    def __init__(self, embedding_dim: int, max_resolution: Tuple[int, int],
                 layer_names: Sequence[str], num_heads: int = 4, large_kernel: int = 7,
                 zone_sample_num: int = 16, change_embedding: bool = False,
                 no_skip_inside: bool = False):
        super().__init__()
        self.max_resolution = tuple(max_resolution)
        self.layer_names = tuple(layer_names)
        self.zone_sample_num = zone_sample_num
        self.change_embedding = change_embedding
        self.no_skip_inside = no_skip_inside
        maxH, maxW = self.max_resolution
        # reference layout: [H*W, D] and [n, D]
        self.positional_encodings = nn.Parameter(0.2 * torch.randn(maxH * maxW, embedding_dim))
        self.positional_encodings2 = nn.Parameter(0.2 * torch.randn(zone_sample_num,
                                                                    embedding_dim))
        ws = twins_window_size(maxH, maxW)
        build = {
            "image": lambda: TwinsTransformer(embedding_dim, ws),
            "hist2image": lambda: LoFTREncoderLayer(embedding_dim, num_heads),
            "new_cross": lambda: LoFTRNewCross9(embedding_dim, num_heads),
            "combine": lambda: Combine1(embedding_dim, num_heads, large_kernel),
            "cvxt": lambda: Block14(embedding_dim, large_kernel),
        }
        kinds = [layer_kind(name) for name in self.layer_names]
        self.kinds = tuple(kind for kind, _ in kinds)
        self.layers = nn.ModuleList(
            build[kind]() if n is None else nn.ModuleList(build[kind]() for _ in range(n))
            for kind, n in kinds)

    def forward(self, x: torch.Tensor, feat1: torch.Tensor, hist_mask: torch.Tensor,
                geom: ScaleGeometry,
                generator: Union[torch.Generator, DeviceCrops, None] = None):
        """x: [B, H, W, C] image features; feat1: [B, Z, n, C] histogram
        features; hist_mask: [B, Z] zones with signal; ``generator``: the
        crop's (module docstring). Returns [B, H, W, C]."""
        B, H, W, C = x.shape
        maxH, maxW = self.max_resolution
        zn, p1, p2 = geom.zone_num, geom.p1, geom.p2
        Z = zn * zn

        pos = self.positional_encodings.reshape(maxH, maxW, C).to(x.dtype)
        pos2 = self.positional_encodings2.to(x.dtype)
        # random crop of the 2D positional encoding (reference :88-96), or a
        # centered one when no generator is given
        if H < maxH or W < maxW:
            if isinstance(generator, DeviceCrops):
                pos = generator.crop(pos, H, W)
            else:
                off_y, off_x = crop_offsets(H, W, maxH, maxW, generator)
                pos = pos[off_y:off_y + H, off_x:off_x + W]
        embeddings = x + pos[None]
        feat0 = embeddings.reshape(B, H * W, C)

        # histogram tokens (reference :123-125)
        feat1_tokens = (feat1 + pos2[None, None]).reshape(B * Z, self.zone_sample_num, C)
        zone_valid = hist_mask.reshape(B * Z, 1, 1).to(x.dtype)
        rect = (geom.zy0, geom.zy1, geom.zx0, geom.zx1)

        for kind, layer in zip(self.kinds, self.layers):
            if kind == "image":
                feat0 = layer(feat0, (H, W))
            elif kind == "hist2image":
                src2d = feat0.reshape(B, H, W, C) if self.change_embedding else embeddings
                padded = F.pad(src2d, (0, 0, geom.pad_w, geom.pad_w, geom.pad_h, geom.pad_h))
                zone = padded[:, geom.sy:geom.ey, geom.sx:geom.ex, :]
                if geom.interpolate:
                    zone = resize_bilinear_align_corners(zone, zn * p1, zn * p2)
                tokens = (zone.reshape(B, zn, p1, zn, p2, C).permute(0, 1, 3, 2, 4, 5)
                          .reshape(B * Z, p1 * p2, C))
                tokens = layer(tokens, feat1_tokens) * zone_valid  # reference :144
                zone_out = (tokens.reshape(B, zn, zn, p1, p2, C).permute(0, 1, 3, 2, 4, 5)
                            .reshape(B, zn * p1, zn * p2, C))
                if geom.interpolate:
                    zone_out = resize_bilinear_align_corners(zone_out, geom.tzh, geom.tzw)
                # static-rectangle write-back (reference :154-157)
                oy0 = max(0, -geom.sy_wo)
                ox0 = max(0, -geom.sx_wo)
                block = zone_out[:, oy0:oy0 + (geom.zy1 - geom.zy0),
                                 ox0:ox0 + (geom.zx1 - geom.zx0), :]
                f2d = feat0.reshape(B, H, W, C).clone()
                region = f2d[:, geom.zy0:geom.zy1, geom.zx0:geom.zx1, :]
                f2d[:, geom.zy0:geom.zy1, geom.zx0:geom.zx1, :] = (
                    block if self.no_skip_inside else region + block)
                feat0 = f2d.reshape(B, H * W, C)
            elif kind in ("new_cross", "combine"):
                for sub in _sublayers(layer):
                    feat0 = sub(feat0, rect, H, W)
            else:  # cvxt: Block14s on the 2-D map
                f2d = feat0.reshape(B, H, W, C)
                for sub in _sublayers(layer):
                    f2d = sub(f2d)
                feat0 = f2d.reshape(B, H * W, C)

        return feat0.reshape(B, H, W, C)


def _sublayers(layer: nn.Module):
    """The modules a layer name runs in sequence: those of its
    ``nn.ModuleList``, or the one module."""
    return layer if isinstance(layer, nn.ModuleList) else (layer,)
