"""SILog loss and the depth metric suite.

Port of ``cfpnet_tpu/train/losses.py`` (``silog_loss``, ``compute_errors``,
``RunningAverage``, ``RunningAverageDict``; reference src/loss.py:4-19,
src/utils/metrics.py:4-24 and src/utils/utils.py:14-41). Both take a
validity mask and masked means, as the JAX version does, instead of boolean
indexing, so the shapes stay fixed.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.interp import resize_bilinear_align_corners


def silog_loss(pred: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor] = None,
               interpolate: bool = True) -> torch.Tensor:
    """Scale-invariant log loss ``10 * sqrt(var(g) + 0.15 * mean(g)^2)`` of
    ``g = log(pred) - log(target)`` over the masked pixels, with the unbiased
    (n - 1) variance of torch's ``var``. pred [B, h, w, 1] is first
    upsampled align-corners to target's [B, H, W, 1] where ``interpolate``;
    mask [B, H, W, 1] bool, all pixels when None."""
    if interpolate:
        pred = resize_bilinear_align_corners(pred, target.shape[1], target.shape[2])
    g = torch.log(pred) - torch.log(target)
    if mask is None:
        mask = torch.ones_like(g, dtype=torch.bool)
    n = mask.to(g.dtype).sum()
    g = torch.where(mask, g, 0.0)
    mean = g.sum() / n
    var = torch.where(mask, (g - mean) ** 2, 0.0).sum() / (n - 1.0)
    return 10.0 * torch.sqrt(var + 0.15 * mean ** 2)


def compute_errors(gt: torch.Tensor, pred: torch.Tensor,
                   valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """9-metric depth suite over valid pixels (masked means)."""
    n = valid.to(gt.dtype).sum()

    def mmean(x):
        return torch.where(valid, x.to(gt.dtype), 0.0).sum() / n

    one = torch.ones((), dtype=gt.dtype, device=gt.device)
    safe_gt = torch.where(valid, gt, one)
    safe_pred = torch.where(valid, pred, one)

    thresh = torch.maximum(safe_gt / safe_pred, safe_pred / safe_gt)
    a1 = mmean(thresh < 1.25)
    a2 = mmean(thresh < 1.25 ** 2)
    a3 = mmean(thresh < 1.25 ** 3)

    abs_rel = mmean(torch.abs(safe_gt - safe_pred) / safe_gt)
    sq_rel = mmean((safe_gt - safe_pred) ** 2 / safe_gt)
    rmse = torch.sqrt(mmean((safe_gt - safe_pred) ** 2))

    lg, lp = torch.log(safe_gt), torch.log(safe_pred)
    rmse_log = torch.sqrt(mmean((lg - lp) ** 2))
    err = lp - lg
    silog = torch.sqrt(mmean(err ** 2) - mmean(err) ** 2) * 100.0
    log_10 = mmean(torch.abs(torch.log10(safe_gt) - torch.log10(safe_pred)))

    return dict(a1=a1, a2=a2, a3=a3, abs_rel=abs_rel, rmse=rmse, log_10=log_10,
                rmse_log=rmse_log, silog=silog, sq_rel=sq_rel)


class RunningAverage:
    """Streaming mean (reference src/utils/utils.py:14-24)."""

    def __init__(self):
        self.avg = 0.0
        self.count = 0

    def append(self, value):
        self.avg = (value + self.count * self.avg) / (self.count + 1)
        self.count += 1

    def get_value(self):
        return self.avg


class RunningAverageDict:
    """Streaming per-key means (reference src/utils/utils.py:27-41)."""

    def __init__(self):
        self._dict = None

    def update(self, new_dict):
        if self._dict is None:
            self._dict = {k: RunningAverage() for k in new_dict}
        for k, v in new_dict.items():
            self._dict[k].append(float(v))

    def get_value(self):
        return {k: v.get_value() for k, v in (self._dict or {}).items()}
