"""Normalization with the JAX package's numerics.

``BatchNorm`` is flax ``nn.BatchNorm`` written out, with the reference torch
graph's parameter names (``weight``, ``bias``, ``running_mean``,
``running_var``) and no ``num_batches_tracked`` counter, along one channel
axis (``channel_dim`` 1 for NCHW, -1 for channels-last tokens).

- Eval: ``y = (x - running_mean) * (rsqrt(running_var + eps) * weight) +
  bias``. A call may name the activation that follows (``act``: SiLU,
  LeakyReLU(0.01) or ReLU) and the shortcut added after it (``residual``),
  so that the blocks hand their epilogue to one call:
  ``act(bn(x)) + residual``.
- The route: ``ops/dispatch.py::batch_norm`` sends an eval call on the
  card that needs no gradient to the hand-written kernel
  ``kernels/bn_act.py`` (scale and shift computed in f32 from the
  parameters and running statistics at each call, the activation and the
  shortcut on the way, one rounding to the element type), and every other
  call to the formula written out in PyTorch, then ``act``, then
  ``+ residual``, op for op as before the kernel.
- Train: the same formula on the batch's statistics over every axis but the
  channel, computed as flax 0.12 computes them (``use_fast_variance``):
  ``var = max(0, E[x^2] - E[x]^2)``, the *biased* variance, in float32 or
  wider, whatever the input's dtype. The running statistics then move as
  flax moves them, with momentum the weight of the old value (0.9
  everywhere in the JAX package:
  ``cfpnet_tpu/models/efficientnetv2.py:43``, ``decoder.py:40``,
  ``encoder.py:41``, ``convnext.py:40``, ``transformer.py:195,199``):
  ``running = 0.9 * running + (1 - 0.9) * batch``, the biased batch
  variance included (torch's ``nn.BatchNorm2d`` would use 0.1 for the new
  value and the unbiased variance). The update is made in place under
  ``no_grad``, in the statistics' own float32, so that an increment below
  one bf16 ulp lands in a bf16 step.
- The output takes the dtype of (x, weight, bias), as flax's
  ``_normalize`` does: bf16 in a bf16 step, whose statistics stay float32.
- In a data-parallel run (``parallel/mesh.py``, a world of more than one
  process) the statistics are the global batch's, as the JAX step's over
  the sharded global array: each process sums x, x^2 and its count per
  channel, and one differentiable all-reduce (``all_reduce_sum``) adds
  them over the processes. Every process then normalizes with, and moves
  its running statistics by, the same values. Eval mode communicates
  nothing. Over a row-sharded map (``forward_rows``, ``--spatial_shards``)
  the same sums run over every shard of one process's grid.
- Inside ``frozen_running_stats()`` a training forward normalizes with the
  batch's statistics and leaves the running ones as they are: the
  recompute of a rematerialized forward (``models/deltar.py``, ``--remat``)
  runs there, so the statistics move once a step, as flax's ``nn.remat``
  discards the recompute's ``batch_stats``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
from torch import nn

from ..ops import dispatch
from ..parallel import spatial
from ..parallel.mesh import all_reduce_sum, world_size

MOMENTUM = 0.9  # flax: the weight of the old running value

_frozen = threading.local()


@contextlib.contextmanager
def frozen_running_stats():
    """Training forwards of ``BatchNorm`` on this thread leave the running
    statistics alone while inside."""
    old = getattr(_frozen, "on", False)
    _frozen.on = True
    try:
        yield
    finally:
        _frozen.on = old


class BatchNorm(nn.Module):
    def __init__(self, num_features: int, eps: float = 1e-5, channel_dim: int = 1):
        super().__init__()
        self.eps = eps
        self.channel_dim = channel_dim
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, act: str = "identity",
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``act(BatchNorm(x)) + residual`` (``act`` one of
        ``kernels/bn_act.py::ACTS``; no shortcut where ``residual`` is None)."""
        if self.training:
            mean, var = self._batch_stats(x)
        else:
            mean, var = self.running_mean, self.running_var
        return self._normalize(x, mean, var, act, residual)

    def forward_rows(self, X, grid, act: str = "identity", residual=None):
        """Over a row-sharded map (``parallel/spatial.py``): in training the
        statistics of every shard of every data group, summed on the
        grid's root, the running statistics moved once; ``act`` and the
        row-sharded ``residual`` shard by shard."""
        if self.training:
            sums = spatial.sum_to([self._sums(x) for parts in X for x in parts], grid.root)
            mean, var = self._update_running(*self._from_sums(sums))
        else:
            mean, var = self.running_mean, self.running_var

        def normalize(x, r=None):
            return self._normalize(x, mean.to(x.device), var.to(x.device), act, r)

        return spatial.each(normalize, X) if residual is None else spatial.each(normalize, X,
                                                                                residual)

    def _normalize(self, x, mean, var, act="identity", residual=None):
        weight, bias = self.weight, self.bias
        if weight.device != x.device:  # a shard on another device of the grid
            weight, bias = weight.to(x.device), bias.to(x.device)
        return dispatch.batch_norm(x, weight, bias, mean, var, self.eps, act, self.channel_dim,
                                   residual, self.training)

    def _sums(self, x: torch.Tensor) -> torch.Tensor:
        """[sum x, sum x^2 per channel, count], in float32 or wider."""
        axes = [d for d in range(x.dim()) if d != self.channel_dim % x.dim()]
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        count = xs.new_full((1,), xs.numel() // xs.shape[self.channel_dim])
        return torch.cat([xs.sum(axes), (xs * xs).sum(axes), count])

    def _from_sums(self, sums: torch.Tensor):
        C = (sums.shape[0] - 1) // 2
        mean = sums[:C] / sums[-1]
        return mean, torch.clamp_min(sums[C:2 * C] / sums[-1] - mean * mean, 0.0)

    def _batch_stats(self, x: torch.Tensor):
        """flax ``_compute_stats`` with ``use_fast_variance``, over the
        global batch in a data-parallel run, then the running update."""
        if world_size() > 1:
            return self._update_running(*self._from_sums(all_reduce_sum(self._sums(x))))
        axes = [d for d in range(x.dim()) if d != self.channel_dim % x.dim()]
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xs.mean(axes)
        return self._update_running(mean,
                                    torch.clamp_min((xs * xs).mean(axes) - mean * mean, 0.0))

    def _update_running(self, mean, var):
        """The running update with the batch's statistics (none inside
        ``frozen_running_stats``); returns them."""
        if getattr(_frozen, "on", False):
            return mean, var
        with torch.no_grad():
            for running, batch in ((self.running_mean, mean), (self.running_var, var)):
                running.copy_(MOMENTUM * running + (1 - MOMENTUM) * batch)
        return mean, var

    def extra_repr(self) -> str:
        return f"{self.weight.shape[0]}, eps={self.eps}, channel_dim={self.channel_dim}"
