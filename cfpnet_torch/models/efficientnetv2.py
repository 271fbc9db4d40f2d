"""EfficientNetV2-B3 image backbone, NCHW.

Port of ``cfpnet_tpu/models/efficientnetv2.py`` (``ConvBnAct``,
``EdgeResidual``, ``InvertedResidual``, ``SqueezeExcite``,
``EfficientNetV2Features``, the B3 and tiny ``StageSpec`` tables), which is
the graph the reference pulls from timm (``tf_efficientnetv2_b3``):

- TF "SAME" asymmetric padding, done by an explicit ``F.pad`` (the extra
  pixel lands bottom/right), as flax ``padding='SAME'`` does;
- BatchNorm eps 1e-3; SiLU; SE with rd_channels = round(block_in_chs/4);
- the k=3 depthwise convs are ``F.conv2d(groups=C)``: the JAX package
  leaves them to XLA too, so they are no kernel of the port.

Blocks carry timm's parameter names (``conv_exp``, ``bn1``, ``conv_dw``,
``se.conv_reduce`` ...) so that the reference ``img_encoder`` weights load
unchanged (see ``encoder.ImageEncoder`` for the stage grouping).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm

BN_EPS = 1e-3


def _same_pad(i: int, k: int, s: int) -> Tuple[int, int]:
    total = max((math.ceil(i / s) - 1) * s + k - i, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Conv2d):
    """Conv2d with TF-style asymmetric SAME padding."""

    def __init__(self, in_chs, out_chs, kernel_size, stride=1, groups=1, bias=False):
        super().__init__(in_chs, out_chs, kernel_size, stride=stride, padding=0,
                         groups=groups, bias=bias)

    def forward(self, x):
        pt, pb = _same_pad(x.shape[-2], self.kernel_size[0], self.stride[0])
        pl, pr = _same_pad(x.shape[-1], self.kernel_size[1], self.stride[1])
        return super().forward(F.pad(x, (pl, pr, pt, pb)))


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class SqueezeExcite(nn.Module):
    """SE block: GAP -> 1x1 reduce (SiLU) -> 1x1 expand (sigmoid gate)."""

    def __init__(self, chs: int, rd_channels: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(chs, rd_channels, 1, bias=True)
        self.conv_expand = nn.Conv2d(rd_channels, chs, 1, bias=True)

    def forward(self, x):
        se = x.mean((2, 3), keepdim=True)
        se = F.silu(self.conv_reduce(se))
        return x * torch.sigmoid(self.conv_expand(se))


class ConvBnAct(nn.Module):
    def __init__(self, in_chs, out_chs, kernel=3, stride=1):
        super().__init__()
        self.conv = Conv2dSame(in_chs, out_chs, kernel, stride)
        self.bn1 = BatchNorm(out_chs, BN_EPS)
        self.has_residual = stride == 1 and in_chs == out_chs

    def forward(self, x):
        y = F.silu(self.bn1(self.conv(x)))
        return y + x if self.has_residual else y


class EdgeResidual(nn.Module):
    """Fused-MBConv: kxk expand conv -> 1x1 project."""

    def __init__(self, in_chs, out_chs, exp_ratio=4.0, kernel=3, stride=1):
        super().__init__()
        mid = _make_divisible(in_chs * exp_ratio)
        self.conv_exp = Conv2dSame(in_chs, mid, kernel, stride)
        self.bn1 = BatchNorm(mid, BN_EPS)
        self.conv_pwl = nn.Conv2d(mid, out_chs, 1, bias=False)
        self.bn2 = BatchNorm(out_chs, BN_EPS)
        self.has_residual = stride == 1 and in_chs == out_chs

    def forward(self, x):
        y = F.silu(self.bn1(self.conv_exp(x)))
        y = self.bn2(self.conv_pwl(y))
        return y + x if self.has_residual else y


class InvertedResidual(nn.Module):
    """MBConv: 1x1 expand -> kxk depthwise -> SE -> 1x1 project."""

    def __init__(self, in_chs, out_chs, exp_ratio=4.0, kernel=3, stride=1, se_ratio=0.25):
        super().__init__()
        mid = _make_divisible(in_chs * exp_ratio)
        self.conv_pw = nn.Conv2d(in_chs, mid, 1, bias=False)
        self.bn1 = BatchNorm(mid, BN_EPS)
        self.conv_dw = Conv2dSame(mid, mid, kernel, stride, groups=mid)
        self.bn2 = BatchNorm(mid, BN_EPS)
        # rd_channels = round(block input chs * se_ratio) — timm semantics
        self.se = SqueezeExcite(mid, max(1, round(in_chs * se_ratio)))
        self.conv_pwl = nn.Conv2d(mid, out_chs, 1, bias=False)
        self.bn3 = BatchNorm(out_chs, BN_EPS)
        self.has_residual = stride == 1 and in_chs == out_chs

    def forward(self, x):
        y = F.silu(self.bn1(self.conv_pw(x)))
        y = F.silu(self.bn2(self.conv_dw(y)))
        y = self.bn3(self.conv_pwl(self.se(y)))
        return y + x if self.has_residual else y


@dataclass(frozen=True)
class StageSpec:
    block: str  # 'cn' | 'er' | 'ir'
    repeats: int
    out_chs: int
    stride: int
    exp_ratio: float = 1.0
    kernel: int = 3
    se_ratio: float = 0.0


# tf_efficientnetv2_b3: v2_base scaled (channels x1.2 round_limit=0, depth x1.4 ceil)
V2_B3_STEM = 40
V2_B3_STAGES: Tuple[StageSpec, ...] = (
    StageSpec("cn", 2, 16, 1, 1.0, 3),
    StageSpec("er", 3, 40, 2, 4.0, 3),
    StageSpec("er", 3, 56, 2, 4.0, 3),
    StageSpec("ir", 5, 112, 2, 4.0, 3, 0.25),
    StageSpec("ir", 7, 136, 1, 6.0, 3, 0.25),
    StageSpec("ir", 12, 232, 2, 6.0, 3, 0.25),
)

# tiny variant for unit tests / dry runs (same topology, 1 block per stage)
V2_TINY_STEM = 8
V2_TINY_STAGES: Tuple[StageSpec, ...] = (
    StageSpec("cn", 1, 8, 1, 1.0, 3),
    StageSpec("er", 1, 8, 2, 2.0, 3),
    StageSpec("er", 1, 8, 2, 2.0, 3),
    StageSpec("ir", 1, 16, 2, 2.0, 3, 0.25),
    StageSpec("ir", 1, 16, 1, 2.0, 3, 0.25),
    StageSpec("ir", 1, 16, 2, 2.0, 3, 0.25),
)


def make_stages(stem_chs: int, stages) -> nn.ModuleList:
    """One ``nn.Sequential`` of blocks per stage spec."""
    out = []
    in_chs = stem_chs
    for spec in stages:
        blocks = []
        for bi in range(spec.repeats):
            stride = spec.stride if bi == 0 else 1
            if spec.block == "cn":
                m = ConvBnAct(in_chs, spec.out_chs, spec.kernel, stride)
            elif spec.block == "er":
                m = EdgeResidual(in_chs, spec.out_chs, spec.exp_ratio, spec.kernel, stride)
            else:
                m = InvertedResidual(in_chs, spec.out_chs, spec.exp_ratio, spec.kernel, stride,
                                     spec.se_ratio)
            blocks.append(m)
            in_chs = spec.out_chs
        out.append(nn.Sequential(*blocks))
    return nn.ModuleList(out)
