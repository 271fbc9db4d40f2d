"""Normalization with the JAX package's numerics.

``BatchNorm`` is flax ``nn.BatchNorm`` at inference, written out:
``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` along one channel
axis, with the reference torch graph's parameter names (``weight``,
``bias``, ``running_mean``, ``running_var``) and no ``num_batches_tracked``
counter. Train-mode statistics (flax momentum and its biased running
variance) come with the train step; until then a module in training mode
raises.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    def __init__(self, num_features: int, eps: float = 1e-5, channel_dim: int = 1):
        super().__init__()
        self.eps = eps
        self.channel_dim = channel_dim
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("train-mode BatchNorm is not ported yet; call .eval()")
        shape = [1] * x.dim()
        shape[self.channel_dim] = -1
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean.view(shape)) * mul.view(shape) + self.bias.view(shape)

    def extra_repr(self) -> str:
        return f"{self.weight.shape[0]}, eps={self.eps}, channel_dim={self.channel_dim}"
