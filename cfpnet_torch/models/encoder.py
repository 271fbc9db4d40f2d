"""Image + histogram encoders.

Port of ``cfpnet_tpu/models/encoder.py`` (``PointNetEncoder``,
``HistExtractor``, ``HistogramEncoder``, ``ImageEncoder``).

- ``HistogramEncoder``: 3-stage shared-MLP PointNet over per-zone sampled
  depth points (1 -> 32 -> 64 -> 128 dims, per-point features kept). The
  reference's Conv1d(k=1) weights [O, I, 1] are applied as a dense layer
  over the last axis of [B·Z, N, C]; BN normalizes per channel.
- ``ImageEncoder``: the EfficientNetV2 pyramid, grouped as the reference's
  wrapper names it: ``conv0`` = (conv_stem, bn1, stage 0), ``conv1`` and
  ``conv2`` = stages 1 and 2, ``conv3`` = (stage 3, stage 4), ``conv4`` =
  stage 5.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import spatial
from .efficientnetv2 import V2_B3_STAGES, V2_B3_STEM, Conv2dSame, make_stages, BN_EPS
from .layers import BatchNorm

HIST_CHANNELS = (32, 64, 128)


class PointNetEncoder(nn.Module):
    """3x (Dense + BN + ReLU) shared MLP (reference encoder.py:6-24)."""

    def __init__(self, in_channel: int, out_channel: int):
        super().__init__()
        for i in range(1, 4):
            setattr(self, f"conv{i}", nn.Conv1d(in_channel if i == 1 else out_channel,
                                                out_channel, 1))
            setattr(self, f"bn{i}", BatchNorm(out_channel, 1e-5, channel_dim=-1))

    def forward(self, x):
        # x: [B', N, D]
        for i in range(1, 4):
            conv = getattr(self, f"conv{i}")
            x = getattr(self, f"bn{i}")(F.linear(x, conv.weight[:, :, 0], conv.bias), "relu")
        return x


class HistExtractor(nn.Module):
    def __init__(self, in_channel: int, out_channel: int):
        super().__init__()
        self.out_channel = out_channel
        self.pointnet_encoder = PointNetEncoder(in_channel, out_channel)

    def forward(self, hist_data):
        # hist_data: [B, Z, N, D]
        B, Z, N, D = hist_data.shape
        x = self.pointnet_encoder(hist_data.reshape(B * Z, N, D))
        return x.reshape(B, Z, N, self.out_channel)


class HistogramEncoder(nn.Module):
    def __init__(self, channels: Sequence[int] = HIST_CHANNELS):
        super().__init__()
        in_ch = 1
        for i, c in enumerate(channels, start=1):
            setattr(self, f"hist_extractor{i}", HistExtractor(in_ch, c))
            in_ch = c
        self.n = len(channels)

    def forward(self, hist_data) -> List[torch.Tensor]:
        feats = []
        x = hist_data
        for i in range(1, self.n + 1):
            x = getattr(self, f"hist_extractor{i}")(x)
            feats.append(x)
        return feats  # [depth_feat1 (32d), depth_feat2 (64d), depth_feat3 (128d)]


class ImageEncoder(nn.Module):
    """5-scale EfficientNetV2 pyramid (reference encoder.py:54-79), NCHW."""

    def __init__(self, stem_chs: int = V2_B3_STEM, stages=V2_B3_STAGES):
        super().__init__()
        s = make_stages(stem_chs, stages)
        self.conv0 = nn.ModuleList([Conv2dSame(3, stem_chs, 3, 2), BatchNorm(stem_chs, BN_EPS),
                                    s[0]])
        self.conv1 = s[1]
        self.conv2 = s[2]
        self.conv3 = nn.ModuleList([s[3], s[4]])
        self.conv4 = s[5]

    def forward(self, x, grid=None) -> List[torch.Tensor]:
        """The five scales of an NCHW image, or of a row-sharded one on
        ``grid`` (``parallel/spatial.py``)."""
        if grid is not None:
            return self.forward_rows(x, grid)
        stem, bn1, stage0 = self.conv0
        x0 = stage0(bn1(stem(x), "silu"))
        x1 = self.conv1(x0)
        x2 = self.conv2(x1)
        x3 = self.conv3[1](self.conv3[0](x2))
        x4 = self.conv4(x3)
        return [x0, x1, x2, x3, x4]

    def forward_rows(self, X, grid):
        stem, bn1, stage0 = self.conv0
        x0 = spatial.apply_rows(stage0, bn1.forward_rows(spatial.apply_rows(stem, X, grid), grid,
                                                         "silu"), grid)
        x1 = spatial.apply_rows(self.conv1, x0, grid)
        x2 = spatial.apply_rows(self.conv2, x1, grid)
        x3 = spatial.chain(self.conv3, x2, grid)
        x4 = spatial.apply_rows(self.conv4, x3, grid)
        return [x0, x1, x2, x3, x4]
