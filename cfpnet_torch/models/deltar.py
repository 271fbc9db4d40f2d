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
crop their positional encodings at offsets drawn from ``generator``
(``models/fusion.py``); ``make_model`` returns the model in eval mode and
the train step switches it (``train/steps.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..data.geometry import ScaleGeometry, geometry_for
from .decoder import Decoder, DepthRegression
from .efficientnetv2 import V2_B3_STAGES, V2_B3_STEM, V2_TINY_STAGES, V2_TINY_STEM
from .encoder import HistogramEncoder, ImageEncoder


class Deltar(nn.Module):
    def __init__(self, n_bins: int = 256, min_val: float = 1e-3, max_val: float = 10.0,
                 norm: str = "linear",
                 attention_layers: Sequence[str] = ("hist2image", "image", "hist2image", "image"),
                 zone_sample_num: int = 16, change_embedding: bool = False,
                 no_skip_inside: bool = False, native_resolution: Tuple[int, int] = (480, 640),
                 stem_chs: int = V2_B3_STEM, stages=V2_B3_STAGES,
                 encoder_channels: Sequence[int] = (232, 136, 56, 40, 16),
                 decoder_channels: Sequence[int] = (256, 256, 128, 64, 32),
                 num_classes: int = 128):
        super().__init__()
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

    def forward(self, rgb: torch.Tensor, hist_data: torch.Tensor, hist_mask: torch.Tensor,
                geoms: Dict[int, ScaleGeometry], generator: Optional[torch.Generator] = None):
        img_features = self.img_encoder(rgb.permute(0, 3, 1, 2))
        hist_features = self.hist_encoder(hist_data[..., None])
        unet_out = self.decoder(img_features, hist_features, hist_mask, geoms, generator)
        bin_widths_normed, range_attention_maps = self.depth_head(unet_out)
        out = self.conv_out(range_attention_maps)

        # Depth reconstruction (reference deltar.py:53-61) runs in f32 (or
        # wider) whatever the compute dtype, as in the JAX package.
        rdt = torch.promote_types(out.dtype, torch.float32)
        prob = torch.softmax(out.to(rdt), dim=1)
        bin_widths = (self.max_val - self.min_val) * bin_widths_normed.to(rdt)
        bin_widths = F.pad(bin_widths, (1, 0), value=self.min_val)
        bin_edges = torch.cumsum(bin_widths, dim=1)
        centers = 0.5 * (bin_edges[:, :-1] + bin_edges[:, 1:])
        pred = torch.sum(prob * centers[:, :, None, None], dim=1, keepdim=True)
        if self.training:
            return bin_edges, pred.permute(0, 2, 3, 1)
        return bin_edges, pred.permute(0, 2, 3, 1), prob.permute(0, 2, 3, 1), None


def make_model(config, tiny: bool = False, device="cuda") -> Deltar:
    """Model factory (reference src/utils/utils.py:7-10), in eval mode on
    ``device``. Weights are torch's default init; load real ones through
    ``cfpnet_torch.weights``."""
    tiny = tiny or getattr(config, "tiny_model", False)
    kw = dict(
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


def model_geometries(config, mode: str, offset=(0, 0)) -> Dict[int, ScaleGeometry]:
    """Static per-scale geometry for a (config, mode) pair."""
    return geometry_for(config, mode, offset).scales()
