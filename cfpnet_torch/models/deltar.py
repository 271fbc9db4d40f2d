"""CFPNet model assembly (class name ``Deltar`` kept for surface parity).

Port of ``cfpnet_tpu/models/deltar.py`` (``Deltar``, ``make_model``,
``model_geometries``; reference src/models/deltar.py:8-82), eval forward.

``Deltar.forward`` takes and returns the JAX package's layouts: rgb
[B, H, W, 3] ImageNet-normalized, hist_data [B, Z, n], hist_mask [B, Z] and
the static per-scale geometry in; ``(bin_edges [B, n_bins+1], pred
[B, h, w, 1], prob [B, h, w, n_bins], None)`` out in eval mode and
``(bin_edges, pred)`` in training mode (``cfpnet_tpu/models/deltar.py:116-117``),
with ``pred = Σ softmax_prob · bin_centers``. Inside, the backbone and decoder
run NCHW and the fusion path on NHWC tokens. In training mode BatchNorm uses
and updates batch statistics (``models/layers.py``) and the fusion layers
crop their positional encodings at offsets drawn from ``generator``, or
held on the device by a ``fusion.DeviceCrops`` passed in its place
(``models/fusion.py``); ``make_model`` returns the model in eval mode and
the train step switches it (``train/steps.py``).

``remat`` (``--remat``, ``cfpnet_tpu/models/deltar.py:51-53, 69-70``): in
training the image encoder runs under ``torch.utils.checkpoint`` (not
reentrant), which keeps its inputs and recomputes its activations in the
backward. The recompute runs inside ``layers.frozen_running_stats`` (the
running statistics move once a step) and on the parameters the forward
saw: the tensors that ``torch.func.functional_call`` swapped in for a bf16
step are handed to the checkpoint as inputs, so the recompute, which runs
after that call has put the masters back, uses them again.

``grid`` (``--spatial_shards``, ``parallel/spatial.py``): the same modules
and parameters walk a batch whose image rows are split over a device grid
(``forward_rows`` of each module), with the one-device forward's results.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..data.geometry import ScaleGeometry, geometry_for
from ..parallel import spatial
from . import depth_anything
from .decoder import Decoder, DepthRegression
from .efficientnetv2 import V2_B3_STAGES, V2_B3_STEM, V2_TINY_STAGES, V2_TINY_STEM
from .encoder import HistogramEncoder, ImageEncoder
from .layers import frozen_running_stats


class Deltar(nn.Module):
    def __init__(self, n_bins: int = 256, min_val: float = 1e-3, max_val: float = 10.0,
                 norm: str = "linear",
                 attention_layers: Sequence[str] = ("hist2image", "image", "hist2image", "image"),
                 zone_sample_num: int = 16, change_embedding: bool = False,
                 no_skip_inside: bool = False, native_resolution: Tuple[int, int] = (480, 640),
                 stem_chs: int = V2_B3_STEM, stages=V2_B3_STAGES,
                 encoder_channels: Sequence[int] = (232, 136, 56, 40, 16),
                 decoder_channels: Sequence[int] = (256, 256, 128, 64, 32),
                 num_classes: int = 128, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.min_val = min_val
        self.max_val = max_val
        self.img_encoder = ImageEncoder(stem_chs, stages)
        dc = decoder_channels
        self.hist_encoder = HistogramEncoder((dc[3] // 2, dc[2] // 2, dc[1] // 2))
        self.decoder = Decoder(num_classes, encoder_channels, decoder_channels,
                               native_resolution, attention_layers, zone_sample_num,
                               change_embedding, no_skip_inside)
        self.depth_head = DepthRegression(num_classes, n_bins, num_classes, norm)
        self.conv_out = nn.Sequential(nn.Conv2d(num_classes, n_bins, 1))

    def forward(self, rgb, hist_data, hist_mask, geoms: Dict[int, ScaleGeometry],
                generator: Optional[torch.Generator] = None, grid=None):
        """The forward of one device, or with ``grid`` the row-sharded
        forward of a batch placed by ``parallel/spatial.py::
        shard_batch_spatial`` (``forward_rows``)."""
        if grid is not None:
            return self.forward_rows(rgb, hist_data, hist_mask, geoms, generator, grid)
        img_features = self.encode_image(rgb.permute(0, 3, 1, 2))
        hist_features = self.hist_encoder(hist_data[..., None])
        unet_out = self.decoder(img_features, hist_features, hist_mask, geoms, generator)
        bin_widths_normed, range_attention_maps = self.depth_head(unet_out)
        out = self.conv_out(range_attention_maps)
        rdt = torch.promote_types(out.dtype, torch.float32)
        bin_edges, centers = self._bins(bin_widths_normed, rdt)
        prob = torch.softmax(out.to(rdt), dim=1)
        pred = torch.sum(prob * centers[:, :, None, None], dim=1, keepdim=True)
        if self.training:
            return bin_edges, pred.permute(0, 2, 3, 1)
        return bin_edges, pred.permute(0, 2, 3, 1), prob.permute(0, 2, 3, 1), None

    def _bins(self, bin_widths_normed, rdt):
        """(bin_edges, bin centers). The depth reconstruction (reference
        deltar.py:53-61) runs in f32 (or wider) whatever the compute dtype,
        as in the JAX package."""
        bin_widths = (self.max_val - self.min_val) * bin_widths_normed.to(rdt)
        bin_widths = F.pad(bin_widths, (1, 0), value=self.min_val)
        bin_edges = torch.cumsum(bin_widths, dim=1)
        return bin_edges, 0.5 * (bin_edges[:, :-1] + bin_edges[:, 1:])

    def forward_rows(self, rgb, hist_data, hist_mask, geoms, generator, grid):
        """The forward over a grid (``parallel/spatial.py``): ``rgb`` and
        the outputs ``pred`` and ``prob`` row-sharded NHWC maps
        (``X[d][s]``), ``hist_data`` and ``hist_mask`` lists over the data
        groups, ``bin_edges`` the whole batch's on the grid's root. The
        histogram encoder and the fusions run once on the whole batch on the
        root, the rest shard by shard; the reconstruction stays per pixel,
        with each image's bin centers."""
        img_features = self.encode_image(spatial.each(lambda x: x.permute(0, 3, 1, 2), rgb),
                                         grid)
        hist_features = self.hist_encoder(spatial.whole(hist_data, grid.root)[..., None])
        unet_out = self.decoder.forward_rows(img_features, hist_features,
                                             spatial.whole(hist_mask, grid.root), geoms,
                                             generator, grid)
        bin_widths_normed, range_attention_maps = self.depth_head.forward_rows(unet_out, grid)
        out = spatial.apply_rows(self.conv_out, range_attention_maps, grid)
        rdt = torch.promote_types(out[0][0].dtype, torch.float32)
        bin_edges, centers = self._bins(bin_widths_normed, rdt)
        prob = spatial.each(lambda o: torch.softmax(o.to(rdt), dim=1), out)
        pred = spatial.per_group(
            lambda p, c: torch.sum(p * c[:, :, None, None], dim=1, keepdim=True), prob,
            centers, grid)
        pred = spatial.each(lambda p: p.permute(0, 2, 3, 1), pred)
        if self.training:
            return bin_edges, pred
        return bin_edges, pred, spatial.each(lambda p: p.permute(0, 2, 3, 1), prob), None

    def encode_image(self, x: torch.Tensor, grid=None):
        """The image encoder (row-sharded on ``grid``); rematerialized in
        training under ``remat``."""
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return self.img_encoder(x, grid)
        names, params = zip(*self.img_encoder.named_parameters())

        def run(x, *params):
            return functional_call(self.img_encoder, dict(zip(names, params)), (x, grid))

        return checkpoint(run, x, *params, use_reentrant=False, preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              frozen_running_stats()))


MODEL_NAMES = ("deltar", "depth_anything_v2")  # the values of --model_name


def make_model(config, tiny: bool = False, device="cuda") -> nn.Module:
    """Model factory (reference src/utils/utils.py:7-10), in eval mode on
    ``device``, by ``config.model_name``: ``"deltar"`` CFPNet's ``Deltar``
    (and its baselines, by ``attention_layer``), ``"depth_anything_v2"``
    Depth Anything V2 metric (``models/depth_anything.py``). Weights are
    torch's default init; load real ones through ``cfpnet_torch.weights``
    (``Deltar``) or ``load_state_dict``."""
    name = getattr(config, "model_name", "deltar")
    if name not in MODEL_NAMES:
        raise ValueError(f"--model_name {name!r} is not one of {MODEL_NAMES}")
    tiny = tiny or getattr(config, "tiny_model", False)
    if name == "depth_anything_v2":
        return depth_anything.build(config, tiny, device)
    kw = dict(
        remat=getattr(config, "remat", False),
        n_bins=config.n_bins,
        min_val=config.min_depth,
        max_val=config.max_depth,
        norm=config.norm,
        attention_layers=tuple(config.attention_layer),
        zone_sample_num=config.zone_sample_num,
        change_embedding=config.change_embedding,
        no_skip_inside=config.no_skip_inside,
        native_resolution=(config.native_height, config.native_width),
    )
    if tiny:
        kw.update(
            stem_chs=V2_TINY_STEM,
            stages=V2_TINY_STAGES,
            encoder_channels=(16, 16, 8, 8, 8),
            decoder_channels=(64, 64, 32, 16, 8),
            num_classes=32,
        )
    with torch.device(device):
        model = Deltar(**kw)
    return model.eval()


def require_deltar(config, what: str) -> None:
    """Raises for a ``--model_name`` other than ``"deltar"``: ``what`` (the
    train step and loop, with or without spatial sharding, ``--selfsup``,
    serving export, the evaluation and ToF sweep drivers) reads the ToF
    histograms or CFPNet's modules, which no other model has. Nothing builds
    ``Deltar`` in another model's place."""
    name = getattr(config, "model_name", "deltar")
    if name != "deltar":
        raise ValueError(f"{what} runs CFPNet (--model_name deltar) only, not --model_name "
                         f"{name!r}")


def cast_to_compute_dtype(model: nn.Module, dtype) -> nn.Module:
    """``model`` with every floating parameter and buffer (the BatchNorm
    statistics included) cast to ``dtype`` in place, as the JAX drivers cast
    ``params`` and ``batch_stats`` for ``--compute_dtype``
    (``evaluate_time.py:88-92``, ``tests/test_bf16.py:140-142``,
    ``cfpnet_tpu/serve/export.py:69-81``: a tree map of ``astype`` over
    every floating leaf). The forward then runs in ``dtype`` where its
    inputs are in ``dtype``; only the depth tail promotes to float32
    (``Deltar.forward``). Returns ``model``."""
    return model.to(dtype=compute_dtype(dtype))


def compute_dtype(name) -> torch.dtype:
    """The torch dtype of ``--compute_dtype`` ("float32", "bfloat16"), or
    ``name`` itself where it is one already."""
    dtype = name if isinstance(name, torch.dtype) else getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"--compute_dtype {name!r} is not a floating dtype")
    return dtype


def model_geometries(config, mode: str, offset=(0, 0)) -> Dict[int, ScaleGeometry]:
    """Static per-scale geometry for a (config, mode) pair."""
    return geometry_for(config, mode, offset).scales()
