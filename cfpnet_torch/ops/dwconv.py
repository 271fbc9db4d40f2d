"""Large-kernel depthwise 2D convolution, plain PyTorch.

Port of ``cfpnet_tpu/ops/dwconv.py::depthwise_conv2d`` (SAME-padded,
stride 1, plus bias) in NHWC. It is written as the k·k shifted
multiply-adds that the CUDA kernel (``kernels/dwconv.py``) performs, in the
same tap order, so that it is the kernel's plain twin: the CPU path and the
version the kernel is held against on the card. It is no yardstick of
speed; ``F.conv2d(groups=C)`` is, and the port never calls it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def depthwise_conv2d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [B, H, W, C]; weight: [C, 1, k, k] (torch depthwise layout), odd k;
    bias: [C]. Zero padding (k-1)//2 on each side, as torch ``padding=k//2``
    and the JAX package's SAME rule for odd k."""
    B, H, W, C = x.shape
    k = weight.shape[-1]
    p = (k - 1) // 2
    xp = F.pad(x, (0, 0, p, p, p, p))
    w = weight.reshape(C, k, k)
    out = torch.zeros_like(x)
    for dy in range(k):
        rows = xp[:, dy:dy + H]
        for dx in range(k):
            out = out + rows[:, :, dx:dx + W] * w[:, dy, dx]
    if bias is not None:
        out = out + bias
    return out
