"""UNet decoder + AdaBins-style depth regression head, NCHW.

Port of ``cfpnet_tpu/models/decoder.py`` (``UpSampleBN``,
``DepthRegression``, ``Decoder``; reference src/models/decoder.py).
- ``UpSampleBN``: align-corners bilinear upsample to the skip's size,
  concat, 2x (conv3x3 + BN + LeakyReLU), as ``_net`` (the reference's
  ``nn.Sequential`` and parameter names); each LeakyReLU runs inside the
  BatchNorm call before it (``models/layers.py``, ``act``).
- ``Decoder``: encoder chans [232,136,56,40,16], decoder chans
  [256,256,128,64,32]; three ``TransformerFusion`` insertions at 1/16, 1/8,
  1/4 with embed dims 128/64/32 and large kernels 7/15/31. The fusion path
  runs on NHWC tokens; its output is concatenated back onto the NCHW map.
- ``DepthRegression``: 3x3 conv -> range-attention maps; 1x1 conv (no bias)
  + GAP + MLP -> normalized bin widths.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..data.geometry import ScaleGeometry
from ..ops.interp import resize_bilinear_align_corners
from ..parallel import spatial
from .fusion import TransformerFusion
from .layers import BatchNorm


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _cat(x, y):
    return torch.cat([x, y], dim=1)


class UpSampleBN(nn.Module):
    def __init__(self, skip_input: int, output_features: int):
        super().__init__()
        self._net = nn.Sequential(
            nn.Conv2d(skip_input, output_features, 3, padding=1),
            BatchNorm(output_features, 1e-5),
            nn.LeakyReLU(0.01),
            nn.Conv2d(output_features, output_features, 3, padding=1),
            BatchNorm(output_features, 1e-5),
            nn.LeakyReLU(0.01),
        )

    def forward(self, x, concat_with):
        up = _nchw(resize_bilinear_align_corners(_nhwc(x), concat_with.shape[2],
                                                 concat_with.shape[3]))
        conv1, bn1, _, conv2, bn2, _ = self._net
        y = bn1(conv1(torch.cat([up, concat_with], dim=1)), "leaky_relu")
        return bn2(conv2(y), "leaky_relu")

    def forward_rows(self, X, skip, grid):
        """Over row-sharded maps: each shard resizes to its rows of the
        skip's global size."""
        up = spatial.each(_nchw, spatial.resize_rows(spatial.each(_nhwc, X),
                                                     spatial.height(skip), skip[0][0].shape[3]))
        conv1, bn1, _, conv2, bn2, _ = self._net
        y = bn1.forward_rows(spatial.apply_rows(conv1, spatial.each(_cat, up, skip), grid), grid,
                             "leaky_relu")
        return bn2.forward_rows(spatial.apply_rows(conv2, y, grid), grid, "leaky_relu")


class DepthRegression(nn.Module):
    def __init__(self, in_channels: int, dim_out: int = 256, embedding_dim: int = 128,
                 norm: str = "linear"):
        super().__init__()
        self.norm = norm
        self.conv3x3 = nn.Conv2d(in_channels, embedding_dim, 3, padding=1)
        self.conv1x1 = nn.Conv2d(in_channels, embedding_dim, 1, bias=False)
        self.regressor = nn.Sequential(
            nn.Linear(embedding_dim, 256),
            nn.LeakyReLU(0.01),
            nn.Linear(256, 256),
            nn.LeakyReLU(0.01),
            nn.Linear(256, dim_out),
        )

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        range_attention_maps = self.conv3x3(x)
        return self._bins(self.conv1x1(x).mean(dim=(2, 3))), range_attention_maps

    def _bins(self, mean):
        """Normalized bin widths [B, dim_out] of the embedding's means."""
        y = self.regressor(mean)
        if self.norm == "linear":
            y = F.relu(y) + 0.1
        elif self.norm == "softmax":
            return torch.softmax(y, dim=1)
        else:
            y = torch.sigmoid(y)
        return y / y.sum(dim=1, keepdim=True)

    def forward_rows(self, X, grid):
        """Over a row-sharded map: the range-attention maps row-sharded, the
        bin widths of the whole batch on the grid's root from each image's
        mean over all its rows."""
        return (self._bins(spatial.image_means(spatial.apply_rows(self.conv1x1, X, grid), grid)),
                spatial.apply_rows(self.conv3x3, X, grid))


class Decoder(nn.Module):
    def __init__(self, num_classes: int = 128,
                 encoder_channels: Sequence[int] = (232, 136, 56, 40, 16),
                 decoder_channels: Sequence[int] = (256, 256, 128, 64, 32),
                 native_resolution: Tuple[int, int] = (480, 640),
                 attention_layers: Sequence[str] = ("hist2image", "image", "hist2image", "image"),
                 zone_sample_num: int = 16, change_embedding: bool = False,
                 no_skip_inside: bool = False):
        super().__init__()
        ec, dc = encoder_channels, decoder_channels
        half = [c // 2 for c in dc]
        nh, nw = native_resolution

        def fusion(embed_dim, scale, kernel):
            return TransformerFusion(
                embed_dim, (nh // scale, nw // scale), attention_layers,
                large_kernel=kernel, zone_sample_num=zone_sample_num,
                change_embedding=change_embedding, no_skip_inside=no_skip_inside)

        self.conv4 = nn.Conv2d(ec[0], dc[0], 1)
        self.up1 = UpSampleBN(dc[0] + ec[1], dc[1])
        self.conv3 = nn.Conv2d(dc[1], half[1], 1)
        self.cross_atten3 = fusion(half[1], 16, 7)
        self.up2 = UpSampleBN(2 * half[1] + ec[2], dc[2])
        self.conv2 = nn.Conv2d(dc[2], half[2], 1)
        self.cross_atten2 = fusion(half[2], 8, 15)
        self.up3 = UpSampleBN(2 * half[2] + ec[3], dc[3])
        self.conv1 = nn.Conv2d(dc[3], half[3], 1)
        self.cross_atten1 = fusion(half[3], 4, 31)
        self.up4 = UpSampleBN(2 * half[3] + ec[4], dc[4])
        self.conv0 = nn.Conv2d(dc[4], num_classes, 3, padding=1)

    def forward(self, img_features, hist_features, hist_mask,
                geoms: Dict[int, ScaleGeometry], generator: Optional[torch.Generator] = None):
        x_block0, x_block1, x_block2, x_block3, x_block4 = img_features
        depth_feat1, depth_feat2, depth_feat3 = hist_features

        def fuse(x, fusion, feat, scale):
            fused = fusion(_nhwc(x), feat, hist_mask, geoms[scale], generator)
            return torch.cat([x, _nchw(fused)], dim=1)

        x_d4 = self.conv4(x_block4)
        x_d3 = self.conv3(self.up1(x_d4, x_block3))
        x_d3 = fuse(x_d3, self.cross_atten3, depth_feat3, 16)
        x_d2 = self.conv2(self.up2(x_d3, x_block2))
        x_d2 = fuse(x_d2, self.cross_atten2, depth_feat2, 8)
        x_d1 = self.conv1(self.up3(x_d2, x_block1))
        x_d1 = fuse(x_d1, self.cross_atten1, depth_feat1, 4)
        x_d0 = self.up4(x_d1, x_block0)
        return self.conv0(x_d0)

    def forward_rows(self, img_features, hist_features, hist_mask,
                     geoms: Dict[int, ScaleGeometry], generator: Optional[torch.Generator],
                     grid):
        """Over row-sharded feature maps. Each fusion runs once, on the
        gathered map of the whole batch on the grid's root (its zones,
        windows and crop of the positional encoding span the map), and each
        shard takes back its rows of the result."""
        x_block0, x_block1, x_block2, x_block3, x_block4 = img_features
        depth_feat1, depth_feat2, depth_feat3 = hist_features

        def run(m, X):
            return spatial.apply_rows(m, X, grid)

        def fuse(X, fusion, feat, scale):
            fused = fusion(_nhwc(spatial.gather(X, grid.root)), feat, hist_mask, geoms[scale],
                           generator)
            return spatial.each(_cat, X, spatial.scatter(_nchw(fused), grid))

        x_d4 = run(self.conv4, x_block4)
        x_d3 = run(self.conv3, self.up1.forward_rows(x_d4, x_block3, grid))
        x_d3 = fuse(x_d3, self.cross_atten3, depth_feat3, 16)
        x_d2 = run(self.conv2, self.up2.forward_rows(x_d3, x_block2, grid))
        x_d2 = fuse(x_d2, self.cross_atten2, depth_feat2, 8)
        x_d1 = run(self.conv1, self.up3.forward_rows(x_d2, x_block1, grid))
        x_d1 = fuse(x_d1, self.cross_atten1, depth_feat1, 4)
        x_d0 = self.up4.forward_rows(x_d1, x_block0, grid)
        return run(self.conv0, x_d0)
