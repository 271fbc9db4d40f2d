"""Train step, eval steps and the metric sweep.

Port of ``cfpnet_tpu/train/steps.py`` (``make_loss_fn``,
``make_train_step``, ``create_train_state``, ``make_eval_step`` for both
protocols, ``make_metric_step``) and of
``cfpnet_tpu/train/loop.py::evaluate`` (per-image metrics streamed through
``RunningAverageDict``; a ragged last batch is padded by repeating its last
sample and the pad images are left out).

The train step is the JAX one written eagerly: the model in training mode
(batch statistics, running statistics updated in place, a random crop of
each positional encoding), the masked SILog loss, its backward through the
three kernels (``kernels/``), and one step of ``train/optim.py::AdamW``.
The crop offsets come from a CPU ``torch.Generator`` seeded once a step
(``step_generator``), the counterpart of the JAX step's 'fusion' RNG. Not
ported, and refused: ``--grad_accum > 1``, ``--remat`` and a
``--compute_dtype`` other than float32 (ROADMAP §A).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..data.datasets import collate
from ..ops.interp import resize_bilinear_align_corners
from .losses import RunningAverageDict, compute_errors, silog_loss
from .optim import AdamW, make_optimizer


def refuse_unported(config) -> None:
    """Raises for the train options the port does not have yet."""
    if int(getattr(config, "grad_accum", 1) or 1) > 1:
        raise NotImplementedError("--grad_accum > 1 is not ported yet (ROADMAP.md §A)")
    if getattr(config, "remat", False):
        raise NotImplementedError("--remat is not ported yet (ROADMAP.md §A)")
    if getattr(config, "compute_dtype", "float32") != "float32":
        raise NotImplementedError(f"--compute_dtype {config.compute_dtype}: only float32 is "
                                  "ported (ROADMAP.md §A)")


def step_generator(seed: int) -> torch.Generator:
    """The CPU generator of one train step's crop offsets
    (``models/fusion.py::crop_offsets``), seeded with the step's seed."""
    return torch.Generator().manual_seed(int(seed))


def make_loss_fn(model, config, geoms):
    """Returns ``loss_fn(batch, generator) -> loss``: the model's training
    forward (which updates its BatchNorm running statistics), pred clipped
    at ``min_depth`` and the SILog loss over ``depth > min_depth``
    (reference train.py:121-123). batch: image [B,H,W,3], depth [B,H,W,1],
    hist_data [B,Z,n], mask [B,Z]."""
    refuse_unported(config)

    def loss_fn(batch: Dict[str, torch.Tensor], generator: torch.Generator) -> torch.Tensor:
        model.train()
        _, pred = model(batch["image"], batch["hist_data"], batch["mask"], geoms, generator)
        pred = torch.clamp(pred, min=config.min_depth)
        dmask = batch["depth"] > config.min_depth
        return silog_loss(pred, batch["depth"], dmask, interpolate=True)

    return loss_fn


@dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics) and its optimizer;
    ``step`` is the optimizer's count."""
    model: torch.nn.Module
    tx: AdamW

    @property
    def step(self) -> int:
        return self.tx.count


def create_train_state(model, config, total_steps: int) -> TrainState:
    """``model`` as it is (weights loaded or torch's init) with a fresh
    ``make_optimizer`` over its parameters."""
    refuse_unported(config)
    return TrainState(model, make_optimizer(model, config, total_steps))


def make_train_step(model, config, geoms):
    """Returns ``train_step(state, batch, seed) -> loss``: forward, loss,
    backward and one optimizer step, in place on ``state``; the loss comes
    back as a 0-d tensor on the device, with no host sync."""
    loss_fn = make_loss_fn(model, config, geoms)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int) -> torch.Tensor:
        for p in state.tx.params:
            p.grad = None
        loss = loss_fn(batch, step_generator(seed))
        loss.backward()
        state.tx.step()
        return loss.detach()

    return train_step


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


def make_eval_step(model, config, geoms, protocol: str = "evaluate_all"):
    """Returns ``batch -> (pred_full [B,H,W,1], prob)``.

    protocol='evaluate_all': clip to [min_depth, max_depth], then
    align-corners upsample to the input size (reference evaluate_all.py:37-44).
    protocol='validate': upsample first, then NaN -> min / Inf -> max and clip
    to the eval bounds (reference train.py:187-195).
    """

    @torch.no_grad()
    def eval_step(batch):
        image = batch["image"]
        _, pred, prob, _ = model(image, batch["hist_data"], batch["mask"], geoms)
        H, W = image.shape[1], image.shape[2]
        if protocol == "evaluate_all":
            pred = torch.clamp(pred, config.min_depth, config.max_depth)
            pred = resize_bilinear_align_corners(pred, H, W)
        else:
            pred = resize_bilinear_align_corners(pred, H, W)
            pred = torch.where(torch.isinf(pred), config.max_depth_eval, pred)
            pred = torch.where(torch.isnan(pred), config.min_depth_eval, pred)
            pred = torch.clamp(pred, config.min_depth_eval, config.max_depth_eval)
        return pred, prob

    return eval_step


def make_metric_step(config, protocol: str = "validate"):
    """Returns ``(gt, pred) -> (metrics dict of [B], valid counts [B])``,
    per image. The valid-mask bounds follow the two reference scripts:
    'evaluate_all' masks with min_depth/max_depth (reference
    evaluate_all.py:80), 'validate' with min_depth_eval/max_depth_eval
    (reference train.py:198)."""
    if protocol == "evaluate_all":
        lo, hi = config.min_depth, config.max_depth
    else:
        lo, hi = config.min_depth_eval, config.max_depth_eval

    @torch.no_grad()
    def metric_step(gt, pred):
        per = []
        counts = []
        for g, p in zip(gt, pred):
            valid = (g > lo) & (g < hi)
            per.append(compute_errors(g, p, valid))
            counts.append(valid.sum())
        return {k: torch.stack([m[k] for m in per]) for k in per[0]}, torch.stack(counts)

    return metric_step


def evaluate(model, config, dataset, geoms, protocol: str = "validate",
             batch_size: int = 1, device="cuda") -> Dict[str, float]:
    """Metric sweep over ``dataset`` in order, ``batch_size`` images at a
    time; metrics are per image and averaged image-weighted, as the
    reference's bs=1 protocol."""
    eval_step = make_eval_step(model, config, geoms, protocol)
    metric_step = make_metric_step(config, protocol)
    metrics = RunningAverageDict()
    for start in range(0, len(dataset), batch_size):
        samples = [dataset[j] for j in range(start, min(start + batch_size, len(dataset)))]
        n_real = len(samples)
        samples += [samples[-1]] * (batch_size - n_real)
        batch = batch_to_device(collate(samples), device)
        pred, _ = eval_step(batch)
        m, n = metric_step(batch["depth"], pred)
        m = {k: v.cpu().numpy() for k, v in m.items()}
        n = n.cpu().numpy()
        for j in range(n_real):
            if int(n[j]) > 0:
                metrics.update({k: float(v[j]) for k, v in m.items()})
    return metrics.get_value()
