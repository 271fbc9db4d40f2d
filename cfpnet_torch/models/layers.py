"""Normalization with the JAX package's numerics.

``BatchNorm`` is flax ``nn.BatchNorm`` written out, with the reference torch
graph's parameter names (``weight``, ``bias``, ``running_mean``,
``running_var``) and no ``num_batches_tracked`` counter, along one channel
axis (``channel_dim`` 1 for NCHW, -1 for channels-last tokens).

- Eval: ``y = (x - running_mean) * (rsqrt(running_var + eps) * weight) +
  bias``.
- Train: the same formula on the batch's statistics over every axis but the
  channel, computed as flax 0.12 computes them (``use_fast_variance``):
  ``var = max(0, E[x^2] - E[x]^2)``, the *biased* variance, in float32 or
  wider. The running statistics then move as flax moves them, with momentum
  the weight of the old value (0.9 everywhere in the JAX package:
  ``cfpnet_tpu/models/efficientnetv2.py:43``, ``decoder.py:40``,
  ``encoder.py:41``, ``convnext.py:40``, ``transformer.py:195,199``):
  ``running = 0.9 * running + (1 - 0.9) * batch``, the biased batch
  variance included (torch's ``nn.BatchNorm2d`` would use 0.1 for the new
  value and the unbiased variance). The update is made in place under
  ``no_grad``.
"""

from __future__ import annotations

import torch
from torch import nn

MOMENTUM = 0.9  # flax: the weight of the old running value


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
        shape = [1] * x.dim()
        shape[self.channel_dim] = -1
        if self.training:
            mean, var = self._batch_stats(x)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)

    def _batch_stats(self, x: torch.Tensor):
        """flax ``_compute_stats`` with ``use_fast_variance``, then the
        running update."""
        axes = [d for d in range(x.dim()) if d != self.channel_dim % x.dim()]
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xs.mean(axes)
        var = torch.clamp_min((xs * xs).mean(axes) - mean * mean, 0.0)
        with torch.no_grad():
            for running, batch in ((self.running_mean, mean), (self.running_var, var)):
                running.copy_(MOMENTUM * running + (1 - MOMENTUM) * batch)
        return mean, var

    def extra_repr(self) -> str:
        return f"{self.weight.shape[0]}, eps={self.eps}, channel_dim={self.channel_dim}"
