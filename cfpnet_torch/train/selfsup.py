"""Self-supervised training: photometric warping with a pose branch.

Port of ``cfpnet_tpu/train/selfsup.py`` (``zone_mean_depth``,
``make_selfsup_train_step``, ``run_selfsup_training``,
``create_selfsup_state``). The objective on video pairs:

    loss = min(reproj(warped src, target), reproj(src, target))   # automask
         + smoothness_weight * edge-aware smoothness
         + zone_loss_weight  * ToF zone-mean consistency

The zone term holds each 8x8 zone's mean predicted depth to the sensor's
zone mean, which makes the variant metric. The depth network is the full
model with its three kernels, forward and backward; the pose branch is
``models/posenet.py``; the warp and the losses are ``ops/warp.py`` (plain
PyTorch, as the JAX package's are plain XLA). Both networks train jointly:
``SelfSupModel`` holds them as ``depth`` and ``pose``, and one
``train/optim.py::AdamW`` steps both (the depth model's backbone at lr/10,
PoseNet with the rest; the clip's global norm over both).

Behaviours of the JAX path that the port keeps as they are:

- the step casts nothing: it runs in float32 whatever ``--compute_dtype``
  says; ``--grad_accum`` and ``--resume`` are not read;
- ``--remat`` applies (``make_model``), ``--debug_nans`` too
  (``loop.debug_nans_step``);
- the step's geometries are those of zone offset 0; under
  ``--train_zone_random_offset`` the pair samples stay at offset 0 as well
  (``data/datasets.py``);
- validation runs every epoch (``--validate_every`` is not read), and only
  the depth model's weights are saved, ``weights/{name}/{epoch}_{rmse:.3f}``
  and ``best``; no full checkpoint;
- in a data-parallel run (``parallel/mesh.py``) the pairs are split over
  the processes as the supervised batches are, the objective is the
  global batch's (each term a mean, or a ratio of sums, over every
  process's rows), the gradients are averaged over the processes before
  the optimizer and so before its clip, and every process validates on
  the whole eval set, as the JAX loop runs plain ``evaluate`` on each
  (``cfpnet_tpu/train/selfsup.py:164``); rank 0 writes the weights.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
from torch import nn

from .. import tracing
from ..data.geometry import geometry_for
from ..data.pipeline import make_loader
from ..models.deltar import make_model, model_geometries, require_deltar
from ..models.posenet import PoseNet
from ..ops.interp import resize_bilinear_align_corners
from ..ops.warp import (absolute, clip, photometric_loss, pose_to_transform, smoothness_loss,
                        warp_frame)
from ..parallel import mesh
from .checkpoint import save_weights
from .loop import JsonlLogger, debug_nans_step, epoch_seconds, epoch_timing, evaluate
from .optim import make_optimizer
from .steps import TrainState, make_eval_step, make_metric_step, step_generator

LOSS_TERMS = ("loss", "photometric", "smooth", "zone")


class SelfSupModel(nn.Module):
    """The jointly trained pair: the depth model (``depth``) and PoseNet
    (``pose``), the JAX state's ``{"depth": ..., "pose": ...}`` tree."""

    def __init__(self, depth: nn.Module, pose: nn.Module):
        super().__init__()
        self.depth = depth
        self.pose = pose


def zone_mean_depth(depth_full: torch.Tensor, geom) -> torch.Tensor:
    """[B,H,W,1] -> [B, Z]: the mean depth of each zone of the pixel-level
    geometry (``zone_num``^2 zones of ``patch_px`` starting at
    (``sy_px``, ``sx_px``))."""
    zn, ph, pw = geom.zone_num, geom.patch_px_h, geom.patch_px_w
    region = depth_full[:, geom.sy_px:geom.sy_px + zn * ph, geom.sx_px:geom.sx_px + zn * pw, 0]
    B = region.shape[0]
    zones = region.reshape(B, zn, ph, zn, pw).permute(0, 1, 3, 2, 4)
    return zones.reshape(B, zn * zn, ph * pw).mean(dim=-1)


def selfsup_terms(pose_model, config, pixel_geom, batch: Dict[str, torch.Tensor],
                  depth_full: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The objective on the target frame's depth ``depth_full`` [B,H,W,1]
    (upsampled, clipped): the pose, the warp, the automasked photometric
    term, the smoothness and the zone term, and their weighted sum.
    Returns {loss, photometric, smooth, zone} (0-d tensors), the global
    batch's in a data-parallel run."""
    aa, tt = pose_model(batch["image_raw"], batch["src_raw"])
    T = pose_to_transform(aa, tt)
    warped, valid = warp_frame(batch["src_raw"], depth_full, batch["K"], batch["K_inv"], T)
    reproj = photometric_loss(warped, batch["image_raw"], config.ssim_alpha)
    # monodepth2's automask: the identity reprojection competes; where the
    # warp leaves the frame it always wins, and the unmasked reproj is kept
    ident = photometric_loss(batch["src_raw"], batch["image_raw"], config.ssim_alpha)
    ph = torch.where(reproj * valid + (1 - valid) * 1e3 < ident, reproj, ident)
    # the global batch's means: every process holds as many rows
    ph_loss = mesh.global_mean(ph.mean())

    smooth = mesh.global_mean(smoothness_loss(depth_full, batch["image_raw"]))

    zmean = zone_mean_depth(depth_full, pixel_geom)
    zvalid = batch["mask"].to(depth_full.dtype)
    sums = torch.stack([(absolute(zmean - batch["zone_mu"]) * zvalid).sum(), zvalid.sum()])
    if mesh.world_size() > 1:
        sums = mesh.all_reduce_sum(sums)
    zone = sums[0] / (sums[1] + 1e-6)

    loss = ph_loss + config.smoothness_weight * smooth + config.zone_loss_weight * zone
    return dict(loss=loss, photometric=ph_loss, smooth=smooth, zone=zone)


def make_selfsup_loss_fn(depth_model, pose_model, config, geoms, pixel_geom):
    """Returns ``loss_fn(batch, generator) -> {loss, photometric, smooth,
    zone}`` (0-d tensors, ``loss`` differentiable): the depth model's
    training forward (its running statistics updated in place, crop offsets
    from ``generator``), the prediction upsampled to the input size and
    clipped at ``min_depth``, then ``selfsup_terms``.

    batch: image [B,H,W,3] (normalized target), image_raw (target in 0..1),
    src_raw (source in 0..1), hist_data [B,Z,n], mask [B,Z], zone_mu [B,Z],
    K, K_inv [B,3,3]."""

    def loss_fn(batch: Dict[str, torch.Tensor], generator: torch.Generator):
        depth_model.train()
        _, pred = depth_model(batch["image"], batch["hist_data"], batch["mask"], geoms,
                              generator)
        H, W = batch["image"].shape[1], batch["image"].shape[2]
        depth_full = clip(resize_bilinear_align_corners(pred, H, W), config.min_depth)
        return selfsup_terms(pose_model, config, pixel_geom, batch, depth_full)

    return loss_fn


def make_selfsup_train_step(state: TrainState, config, geoms, pixel_geom):
    """Returns ``train_step(state, batch, seed) -> {loss, photometric,
    smooth, zone}``: forward, backward through both networks and one
    optimizer step, in place on ``state`` (``create_selfsup_state``); the
    terms come back as detached 0-d tensors on the device, with no host
    sync. Crop offsets from ``steps.step_generator(seed)``."""
    joint = state.model
    loss_fn = make_selfsup_loss_fn(joint.depth, joint.pose, config, geoms, pixel_geom)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int):
        with tracing.span("train.step"):
            for p in state.tx.params:
                p.grad = None
            with tracing.span("train.forward"):
                terms = loss_fn(batch, step_generator(seed))
            with tracing.span("train.backward"):
                terms["loss"].backward()
            if mesh.is_distributed():
                with tracing.span("train.allreduce"):
                    mesh.average_gradients([p.grad for p in state.tx.params
                                            if p.grad is not None])
            with tracing.span("train.optimizer"):
                state.tx.step()
        return {k: v.detach() for k, v in terms.items()}

    return train_step


def create_selfsup_state(depth_model: nn.Module, config, total_steps: int,
                         pose_model: Optional[nn.Module] = None) -> TrainState:
    """``SelfSupModel(depth_model, pose_model)`` (a fresh PoseNet with
    flax's initialisation on the depth model's device where none is given)
    with ``make_optimizer`` over both."""
    if pose_model is None:
        pose_model = PoseNet().to(next(depth_model.parameters()).device)
    joint = SelfSupModel(depth_model, pose_model)
    return TrainState(joint, make_optimizer(joint, config, total_steps))


def run_selfsup_training(config, tiny: bool = False, max_steps_per_epoch: Optional[int] = None,
                         device="cuda") -> TrainState:
    """The self-supervised loop (``run_training``'s shape with the joint
    objective): each epoch, train steps over the pair loader (at most
    ``max_steps_per_epoch``), the ``validate`` sweep of the depth model on
    the eval loader, a ``selfsup_val`` line in
    ``{save_dir}/selfsup_log.jsonl`` (the metrics, and the epoch's timing
    spans and counters as ``loop.epoch_timing`` gives them) and the depth weights.
    The loop traces in a ``tracing.session()``. Step ``s`` draws
    its crop offsets from ``steps.step_generator(seed + s)``. Returns the
    final state."""
    require_deltar(config, "--selfsup")
    device = torch.device(device)
    train_loader = make_loader(config, "train", device=device)
    eval_loader = make_loader(config, "online_eval", device=device)
    torch.manual_seed(config.seed)
    model = make_model(config, tiny=tiny, device=device)
    geoms = model_geometries(config, "train")
    pixel_geom = geometry_for(config, "train")

    steps_per_epoch = len(train_loader)
    if max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)
    state = create_selfsup_state(model, config, config.epochs * steps_per_epoch)
    if mesh.is_distributed():
        mesh.broadcast_module(state.model)  # every process starts from rank 0's weights
    writer = mesh.rank() == 0 and not config.no_logging
    train_step = make_selfsup_train_step(state, config, geoms, pixel_geom)
    if config.debug_nans:
        train_step = debug_nans_step(train_step)
    eval_steps = (make_eval_step(model, config, model_geometries(config, "online_eval"),
                                 protocol="validate"),
                  make_metric_step(config, protocol="validate"))

    logger = JsonlLogger(
        os.path.join(config.save_dir, "selfsup_log.jsonl") if writer else None)
    step, best_rmse = 0, float("inf")
    with tracing.session() as spans:
        for epoch in range(config.epochs):
            counted = tracing.counters()
            with tracing.span("loop.train"):
                train_loader.set_epoch(epoch)
                loss_sum = torch.zeros((), device=device)
                n_steps = 0
                batches = iter(train_loader)
                try:
                    while n_steps < steps_per_epoch:
                        with tracing.span("loop.step"):
                            batch = next(batches, None)
                            if batch is None:
                                break
                            loss_sum += train_step(state, batch, config.seed + step)["loss"]
                            n_steps += 1
                            step += 1
                finally:
                    batches.close()
                loss = float(loss_sum) / max(n_steps, 1)  # the epoch's one read of the losses
            with tracing.span("loop.validate"):
                metrics = evaluate(model, config, eval_loader, protocol="validate",
                                   steps=eval_steps)
            rmse = metrics.get("rmse", float("inf"))
            print(f"selfsup epoch {epoch}: loss {loss:.4f} rmse {rmse:.4f} "
                  f"({epoch_seconds(spans.snapshot()):.0f}s)")
            if writer:
                with tracing.span("loop.checkpoint"):
                    save_weights(f"weights/{config.name}/{epoch}_{rmse:.3f}", model)
                    if rmse < best_rmse:
                        best_rmse = rmse
                        save_weights(f"weights/{config.name}/best", model)
            mesh.barrier()
            logger.log(kind="selfsup_val", epoch=epoch, step=step, loss=loss, **metrics,
                       **epoch_timing(spans.drain(), n_steps, counted))
    logger.close()
    return state
