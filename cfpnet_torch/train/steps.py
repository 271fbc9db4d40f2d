"""Train step, eval steps and the metric sweep.

Port of ``cfpnet_tpu/train/steps.py`` (``make_loss_fn``,
``make_train_step``, ``create_train_state``, ``eval_batch_image``,
``make_eval_step`` for both protocols, ``make_metric_step``). The sweep
over an eval loader is ``train/loop.py::evaluate``.

The train step is the JAX one written eagerly: the model in training mode
(batch statistics, running statistics updated in place, a random crop of
each positional encoding), the masked SILog loss, its backward through the
three kernels (``kernels/``), and one step of ``train/optim.py::AdamW``.
The crop offsets come from a CPU ``torch.Generator`` seeded once a step
(``step_generator``), the counterpart of the JAX step's 'fusion' RNG.

``--compute_dtype bfloat16`` is the JAX package's mixed precision
(``cfpnet_tpu/train/steps.py:55-88``): the forward and backward run on
bf16 copies of the floating parameters, cast inside the step with autograd
through the cast, so the gradients land in float32 on the float32 masters;
the image and the histograms are cast, the mask and the depth are not; the
BatchNorm statistics stay float32 and uncast; the depth tail, the loss and
the optimizer run in float32.

``--grad_accum N`` is the JAX step's microbatch loop
(``cfpnet_tpu/train/steps.py:131-197``): the batch's N slices of bs/N rows
run in order, each with its own crop offsets, and the BatchNorm running
statistics thread through them (the in-place update); their unscaled
losses are backpropagated into ``.grad``, which sums them, and the sum is
divided by N once before the optimizer; the step's loss is the mean of
the N losses. ``--remat`` is the model's (``models/deltar.py``).

In a data-parallel run (``parallel/mesh.py``) each process steps on its
rows of the global batch, laid out by the loader so that its microbatch i
is its share of global microbatch i (``mesh.rank_rows``). The BatchNorm
statistics and the loss are the global batch's, the same loss on every
process; after the backward one all-reduce averages the gradients over the
processes (``mesh.average_gradients``), which gives the global batch's
gradient, and every process takes the same optimizer step. A process group
of one process reduces too, over itself.

On a CUDA device, off a grid, outside a process group and without
``--remat``, the step runs as one CUDA graph (``graph_engages``,
``graphs.py::CapturedTrainStep``): its first call is eager, its second
captures forward, loss, backward and the optimizer's update and replays
them, and every later call replays, the crop offsets and the optimizer's
per-step scalars drawn and computed on the host as the eager step does and
copied to the device before the replay. The crops of a graphed step gather
their rows at those offsets (``models/fusion.py::DeviceCrops``), with the
slice's values and gradients. Every other step, and any step under
autograd's anomaly mode, runs eager.

An eager step is the span ``train.step`` (``tracing.py``) over
``train.forward`` (each microbatch's loss), ``train.backward``,
``train.allreduce`` (in a process group) and ``train.optimizer`` (the clip
and the update), and counts ``train.eager_steps``. A replayed one is
``train.step`` over ``train.copy_in`` (the batch's copy, the draws and the
scalars' copy) and ``train.replay``, and counts ``train.graph.replays``;
the capture is the span ``train.capture`` and counts ``train.graph.captures``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from .. import tracing
from ..graphs import CapturedTrainStep, SharedPool
from ..models.deltar import compute_dtype, require_deltar
from ..ops.interp import device_constant, resize_bilinear_align_corners
from ..parallel import spatial
from ..parallel.mesh import average_gradients, is_distributed
from .losses import compute_errors, silog_loss, silog_loss_rows
from .optim import AdamW, make_optimizer


def step_generator(seed: int) -> torch.Generator:
    """The CPU generator of one train step's crop offsets
    (``models/fusion.py::crop_offsets``), seeded with the step's seed."""
    return torch.Generator().manual_seed(int(seed))


def make_loss_fn(model, config, geoms, grid=None):
    """Returns ``loss_fn(batch, generator) -> loss``: the model's training
    forward (which updates its BatchNorm running statistics), pred clipped
    at ``min_depth`` and the SILog loss over ``depth > min_depth``
    (reference train.py:121-123). batch: image [B,H,W,3], depth [B,H,W,1],
    hist_data [B,Z,n], mask [B,Z]; on ``grid``, the batch as
    ``parallel/spatial.py::shard_batch_spatial`` places it, the forward
    row-sharded and the loss over the shards' global sums.

    In a compute dtype other than float32 the forward runs on
    ``cast_params(model, dtype)`` and the image and histograms cast to it
    (module docstring); the model's own parameters and statistics stay
    float32."""
    cdt = compute_dtype(config.compute_dtype)

    def forward(image, hist, mask, generator):
        if cdt == torch.float32:
            return model(image, hist, mask, geoms, generator, grid)
        if grid is None:
            image, hist = image.to(cdt), hist.to(cdt)
        else:
            image, hist = spatial.each(lambda t: t.to(cdt), image), [h.to(cdt) for h in hist]
        return functional_call(model, cast_params(model, cdt),
                               (image, hist, mask, geoms, generator, grid))

    def loss_fn(batch, generator: torch.Generator) -> torch.Tensor:
        model.train()
        _, pred = forward(batch["image"], batch["hist_data"], batch["mask"], generator)
        if grid is None:
            pred = torch.clamp(pred, min=config.min_depth)
            dmask = batch["depth"] > config.min_depth
            return silog_loss(pred, batch["depth"], dmask, interpolate=True)
        pred = spatial.each(lambda p: torch.clamp(p, min=config.min_depth), pred)
        dmask = spatial.each(lambda d: d > config.min_depth, batch["depth"])
        return silog_loss_rows(pred, batch["depth"], dmask, grid)

    return loss_fn


def cast_params(model, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """``dtype`` copies of the model's parameters (all floating) by name,
    each one differentiable cast (``Tensor.to``): a gradient through a copy
    lands in the parameter's own dtype on the parameter. The JAX loss's
    ``cast_tree`` of ``params``; buffers (the BatchNorm statistics) are
    left out."""
    return {name: p.to(dtype) for name, p in model.named_parameters()}


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
    return TrainState(model, make_optimizer(model, config, total_steps))


def graph_engages(device: torch.device, config, grid=None) -> bool:
    """Whether ``make_train_step`` captures the step of a model on
    ``device`` in a CUDA graph: a CUDA device, no grid, no process group and
    no ``--remat``."""
    return (device.type == "cuda" and grid is None and not is_distributed()
            and not config.remat)


def make_train_step(model, config, geoms, grid=None, pool: Optional[SharedPool] = None):
    """Returns ``train_step(state, batch, seed) -> loss``: forward, loss,
    backward and one optimizer step, in place on ``state``; the loss comes
    back as a 0-d tensor on the device, with no host sync, a new tensor each
    call. Under ``--grad_accum N`` the batch runs as N microbatches (module
    docstring); ``ValueError`` where N does not divide the batch. In a
    process group the gradients are averaged over its processes before the
    optimizer.

    Where ``graph_engages``, the step is a ``graphs.CapturedTrainStep``
    (module docstring), bound to the state of its second call and to that
    batch's shapes; ``pool``, a ``graphs.SharedPool`` that the steps of one
    run share, holds its memory.

    On ``grid`` (``--spatial_shards``) each microbatch is placed on the grid
    (``shard_batch_spatial_presplit``: microbatch i is the batch's rows
    ``[i * mb, (i + 1) * mb)``, as JAX's host pre-split) and runs the
    row-sharded forward; autograd sums every shard's gradient into the
    model's own ``.grad`` through the copies, so nothing else changes."""
    require_deltar(config, "the train step")
    loss_fn = make_loss_fn(model, config, geoms, grid)
    accum = int(getattr(config, "grad_accum", 1) or 1)

    def microbatches(batch):
        if grid is not None:
            if accum <= 1:
                return [spatial.shard_batch_spatial(batch, grid)]
            return spatial.shard_batch_spatial_presplit(batch, grid, accum)
        if accum <= 1:
            return [batch]
        bs = next(iter(batch.values())).shape[0]
        if bs % accum != 0:
            raise ValueError(f"--grad_accum {accum} does not divide batch size {bs}")
        mb = bs // accum
        return [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()} for i in range(accum)]

    def run(state: TrainState, batch, crops, scalars: Optional[torch.Tensor]) -> torch.Tensor:
        """The step's work on the device: ``crops`` a generator or
        ``DeviceCrops``; the optimizer's ``update`` on ``scalars``, or its
        ``step()`` where None."""
        for p in state.tx.params:
            p.grad = None
        loss = None
        for part in microbatches(batch):  # the crops draw each microbatch's own offsets
            with tracing.span("train.forward"):
                part_loss = loss_fn(part, crops)
            with tracing.span("train.backward"):
                part_loss.backward()  # .grad sums the microbatches' gradients
            loss = part_loss.detach() if loss is None else loss + part_loss.detach()
        grads = [p.grad for p in state.tx.params if p.grad is not None]
        if is_distributed():
            with tracing.span("train.allreduce"):
                average_gradients(grads)
        if accum > 1:
            torch._foreach_div_(grads, float(accum))
            loss = loss / accum
        with tracing.span("train.optimizer"):
            if scalars is None:
                state.tx.step()
            else:
                state.tx.update(scalars)
        return loss

    def eager_step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int) -> torch.Tensor:
        with tracing.span("train.step"):
            tracing.count("train.eager_steps")
            return run(state, batch, step_generator(seed), None)

    if not graph_engages(next(model.parameters()).device, config, grid):
        return eager_step
    captured = CapturedTrainStep(run, step_generator, pool)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int) -> torch.Tensor:
        if torch.is_anomaly_enabled():  # its checks read the backward's values on the host
            return eager_step(state, batch, seed)
        return captured(state, batch, seed)

    return train_step


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


# ImageNet statistics (reference nyu.py:266-288 / zjuL5.py:211)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


_IMAGENET_STATS: Dict[tuple, torch.Tensor] = {}


def _imagenet_stats(device: torch.device):
    """(mean, std) as f32 tensors on ``device``, copied there once
    (``ops/interp.py::device_constant``: never one a trace made)."""
    return tuple(device_constant(_IMAGENET_STATS, (name, device),
                                 lambda: torch.tensor(values, dtype=torch.float32, device=device))
                 for name, values in (("mean", IMAGENET_MEAN), ("std", IMAGENET_STD)))


def normalize_image_u8(u8: torch.Tensor) -> torch.Tensor:
    """Raw uint8 RGB [B, H, W, 3] normalized on its device in f32 with the
    JAX package's operations."""
    mean, std = _imagenet_stats(u8.device)
    return (u8.to(torch.float32) / 255.0 - mean) / std


def eval_batch_image(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Normalized f32 image of an eval batch: ``image_u8`` (raw uint8, as
    the NYU and ZJUL5 eval samples ship it) through ``normalize_image_u8``,
    or the batch's normalized ``image``."""
    if "image_u8" in batch:
        return normalize_image_u8(batch["image_u8"])
    return batch["image"]


def eval_prediction(model, config, geoms, protocol: str, image: torch.Tensor,
                    hist: torch.Tensor, mask: torch.Tensor, dtype=None):
    """``(pred_full [B,H,W,1], prob)``: the eval forward on a normalized
    image, image and histograms cast to ``dtype`` where it is given (the
    model's compute dtype), and the protocol's post-processing
    (``postprocess``)."""
    if dtype is not None:
        image, hist = image.to(dtype), hist.to(dtype)
    _, pred, prob, _ = model(image, hist, mask, geoms)
    return postprocess(config, protocol, pred, image.shape[1], image.shape[2]), prob


def postprocess(config, protocol: str, pred: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """The protocol's post-processing of the forward's pred [B,h,w,1].

    protocol='evaluate_all': clip to [min_depth, max_depth], then
    align-corners upsample to the input size H x W (reference
    evaluate_all.py:37-44).
    protocol='validate': upsample first, then NaN -> min / Inf -> max and clip
    to the eval bounds (reference train.py:187-195).
    """
    if protocol == "evaluate_all":
        pred = torch.clamp(pred, config.min_depth, config.max_depth)
        return resize_bilinear_align_corners(pred, H, W)
    pred = resize_bilinear_align_corners(pred, H, W)
    pred = torch.where(torch.isinf(pred), config.max_depth_eval, pred)
    pred = torch.where(torch.isnan(pred), config.min_depth_eval, pred)
    return torch.clamp(pred, config.min_depth_eval, config.max_depth_eval)


def make_eval_step(model, config, geoms, protocol: str = "evaluate_all", compute_dtype=None):
    """Returns ``(batch, grid=None) -> (pred_full [B,H,W,1], prob)``, the
    model in eval mode: ``eval_prediction`` on ``eval_batch_image(batch)``.
    The JAX eval step casts nothing, and neither does this one unless
    ``compute_dtype`` is given (a model cast by
    ``models/deltar.py::cast_to_compute_dtype``: the serving forward's
    arithmetic, ``serve/export.py``).

    With ``grid`` (``--spatial_shards``) the batch, whole on the grid's
    root, is placed on the grid (``shard_batch_spatial``), the forward runs
    row-sharded, and the prediction's and probabilities' rows are gathered
    on the root before the post-processing."""

    @torch.no_grad()
    def eval_step(batch, grid=None):
        model.eval()
        if grid is None:
            return eval_prediction(model, config, geoms, protocol, eval_batch_image(batch),
                                   batch["hist_data"], batch["mask"], compute_dtype)
        placed = spatial.shard_batch_spatial(
            {k: batch[k] for k in ("image_u8", "image", "hist_data", "mask") if k in batch},
            grid)
        key = "image_u8" if "image_u8" in placed else "image"
        image = spatial.each(lambda x: eval_batch_image({key: x}), placed[key])
        hist = placed["hist_data"]
        if compute_dtype is not None:
            image = spatial.each(lambda x: x.to(compute_dtype), image)
            hist = [h.to(compute_dtype) for h in hist]
        _, pred, prob, _ = model(image, hist, placed["mask"], geoms, grid=grid)
        H, W = batch[key].shape[1], batch[key].shape[2]
        return (postprocess(config, protocol, spatial.gather(pred, grid.root, dim=1), H, W),
                spatial.gather(prob, grid.root, dim=1))

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
