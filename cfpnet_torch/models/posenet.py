"""Pose network of the self-supervised variant.

Port of ``cfpnet_tpu/models/posenet.py::PoseNet``: the target and source
frames concatenated on channels, seven stride-2 3x3 convs (widths 16, 32,
64, 128, 256, 256, 256) each followed by ReLU, a spatial mean, and a dense
head to 6 values scaled by 0.01: (axis-angle [B,3], translation [B,3]).

The convs pad as flax's stride-2 ``SAME`` does, (0, 1) on an even side and
(1, 1) on an odd one (``efficientnetv2.Conv2dSame``); at 416x544 both
occur (416 -> 208 -> ... -> 13 -> 7 -> 4). A fresh network takes flax's
initialisation: conv kernels normal with variance 2 / fan_out (fan_out =
9 x width), zero biases, a zero head, so that the first pose is the
identity.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .efficientnetv2 import Conv2dSame

WIDTHS = (16, 32, 64, 128, 256, 256, 256)


class PoseNet(nn.Module):
    """frames [B,H,W,3] x 2 (NHWC) -> (axisangle [B,3], translation [B,3])."""

    def __init__(self, widths: Tuple[int, ...] = WIDTHS):
        super().__init__()
        self.widths = tuple(widths)
        c = 6
        for i, w in enumerate(self.widths):
            self.add_module(f"conv{i}", Conv2dSame(c, w, 3, stride=2, bias=True))
            c = w
        self.pose_head = nn.Linear(c, 6)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """flax's initialisation: ``variance_scaling(2.0, "fan_out",
        "normal")`` kernels, zero biases, a zero head."""
        for i, w in enumerate(self.widths):
            conv = getattr(self, f"conv{i}")
            conv.weight.normal_(0.0, math.sqrt(2.0 / (9 * w)))
            conv.bias.zero_()
        self.pose_head.weight.zero_()
        self.pose_head.bias.zero_()

    def forward(self, frame_a: torch.Tensor, frame_b: torch.Tensor):
        x = torch.cat([frame_a, frame_b], dim=-1).permute(0, 3, 1, 2)
        for i in range(len(self.widths)):
            x = F.relu(getattr(self, f"conv{i}")(x))
        out = 0.01 * self.pose_head(x.mean(dim=(2, 3)))
        return out[:, :3], out[:, 3:]
