"""A toy depth model in plain PyTorch: the reference of the test family
``toy``. Two 3x3 convolutions with a ReLU between them, the depth a sigmoid
times ``max_depth``; images [B,H,W,3] in, depth maps [B,H,W,1] out."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn


class ToyDepth(nn.Module):
    def __init__(self, channels: int, max_depth: float):
        super().__init__()
        self.max_depth = max_depth
        self.conv1_weight = nn.Parameter(torch.empty(channels, 3, 3, 3))
        self.conv1_bias = nn.Parameter(torch.empty(channels))
        self.conv2_weight = nn.Parameter(torch.empty(1, channels, 3, 3))
        self.conv2_bias = nn.Parameter(torch.empty(1))

    def forward(self, image):
        x = F.relu(F.conv2d(image.permute(0, 3, 1, 2), self.conv1_weight, self.conv1_bias,
                            padding=1))
        x = F.conv2d(x, self.conv2_weight, self.conv2_bias, padding=1)
        return (torch.sigmoid(x) * self.max_depth).permute(0, 2, 3, 1)


def build(settings: Dict, device, channels: int) -> ToyDepth:
    with torch.device(device):
        return ToyDepth(channels, settings["max_depth"])
