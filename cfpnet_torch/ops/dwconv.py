"""Large-kernel depthwise 2D convolution, plain PyTorch.

Port of ``cfpnet_tpu/ops/dwconv.py::depthwise_conv2d`` (SAME-padded,
stride 1, plus bias) in NHWC. It is written as the k·k shifted
multiply-adds that the CUDA kernel (``kernels/dwconv.py``) performs, so
that it is the kernel's plain twin: the CPU path and the version the kernel
is held against on the card. At k=7 the kernel adds the taps in this
order, (dy, dx) then the bias; at k=15 and k=31 it sums two halves of the
kernel columns apart and adds the second half's sum to the first's, then
the bias (the tolerance note of ``chip_smoke.py`` covers that). It is no
yardstick of speed; ``F.conv2d(groups=C)`` is, and the port never calls it.

In bfloat16 it is the Pallas kernel's bf16 arithmetic
(``cfpnet_tpu/ops/pallas_dwconv.py:33-37``): the taps, weights and bias
upcast to f32, the f32 conv, the output rounded to bf16 once.
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
    if x.dtype == torch.bfloat16:
        return depthwise_conv2d(x.float(), weight.float(),
                                None if bias is None else bias.float()).to(torch.bfloat16)
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
