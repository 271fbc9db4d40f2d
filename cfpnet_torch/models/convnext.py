"""Large-kernel ConvNeXt block.

Port of ``cfpnet_tpu/models/convnext.py::Block14`` (reference
src/models/convnext.py:16-58): depthwise conv (31/15/7 kernel) -> BN ->
ReLU -> LayerNorm (eps 1e-6) -> 4x MLP (exact GELU) -> residual, on an NHWC
map. The depthwise conv goes through ``ops.dispatch.dwconv2d``: the CUDA
kernel on the card, its plain twin on the CPU. The reference's unused
``conv1`` (dim*2 -> dim) is not created.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dispatch import dwconv2d
from .layers import BatchNorm


class LargeKernelDWConv(nn.Module):
    """Parameters of the reference's ``dwconv2`` (``nn.Conv2d(dim, dim, k,
    padding=k//2, groups=dim)``: weight [C, 1, k, k], bias [C]), applied to an
    NHWC map through the dispatch switch."""

    def __init__(self, dim: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, 1, k, k))
        self.bias = nn.Parameter(torch.zeros(dim))
        nn.init.kaiming_normal_(self.weight, mode="fan_out")

    def forward(self, x):
        return dwconv2d(x, self.weight, self.bias)


class Block14(nn.Module):
    def __init__(self, dim: int, large_kernel: int = 7):
        super().__init__()
        self.dwconv2 = LargeKernelDWConv(dim, large_kernel)
        self.bn1 = BatchNorm(dim, 1e-5, channel_dim=-1)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        # x: [B, H, W, C]
        y = F.relu(self.bn1(self.dwconv2(x)))
        y = self.pwconv2(F.gelu(self.pwconv1(self.norm(y))))
        return x + y
