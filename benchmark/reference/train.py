"""The published training step in plain PyTorch: the benchmark's reference.

CFPNet's recipe (``train.py:79-94, 121-123`` of denyingmxd/CFPNet): the
model in training mode, its prediction clipped below at ``min_depth`` and
upsampled to the depth map, the scale-invariant log loss over the pixels
deeper than ``min_depth``, and AdamW under a OneCycle schedule with two
learning rates, the encoder's at a tenth. The optimizer is optax's AdamW
(the form the system under test was first written in): the momentum
schedule's current b1 in the bias correction, eps added outside the square
root, the weight decay added to the Adam direction before the learning rate
scales it, every parameter decayed; the schedules in float32 at the count
before the step. Plain per-parameter tensor ops, no foreach kernels.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .model import resize

B2, EPS = 0.999, 1e-8


def silog(pred, depth, min_depth: float):
    """``10 * sqrt(var(g) + 0.15 * mean(g)^2)`` of ``g = log(pred) -
    log(depth)`` over the pixels with depth above ``min_depth`` (the unbiased
    variance), pred [B,h,w,1] clipped at ``min_depth`` and upsampled to
    depth [B,H,W,1]. Masked sums keep every shape static."""
    pred = resize(torch.clamp(pred, min=min_depth), depth.shape[1], depth.shape[2])
    mask = depth > min_depth
    n = mask.sum()
    g = torch.where(mask, torch.log(pred) - torch.log(torch.where(mask, depth, 1.0)), 0.0)
    mean = g.sum() / n
    var = torch.where(mask, (g - mean) ** 2, 0.0).sum() / (n - 1)
    return 10.0 * torch.sqrt(var + 0.15 * mean ** 2)


def onecycle(max_lr: float, total: int, div: float, final_div: float):
    """(lr(step), momentum(step)) of the OneCycle schedule (cosine, 30% up,
    momentum 0.95 -> 0.85 -> 0.95), in float32."""
    f32 = np.float32
    up = float(0.3 * total) - 1.0
    down = float(total - up) - 1.0

    def anneal(a, b, pct):
        return f32(b) + f32((a - b) / 2.0) * (f32(math.cos(f32(math.pi) * pct)) + f32(1.0))

    def phase(step, rise, fall):
        step = f32(step)
        if step <= f32(up):
            return anneal(*rise, np.clip(step / f32(up), f32(0), f32(1)))
        return anneal(*fall, np.clip((step - f32(up)) / f32(down), f32(0), f32(1)))

    lo = max_lr / div
    return (lambda s: phase(s, (lo, max_lr), (max_lr, lo / final_div)),
            lambda s: phase(s, (0.95, 0.85), (0.85, 0.95)))


class AdamW:
    """AdamW over the model's parameters with the encoder (and, unless
    ``hist_encoder_10x``, the histogram encoder) at a tenth of the rate."""

    def __init__(self, model, settings: Dict, total_steps: int):
        s = settings
        if not s.get("disable_clip_grad", False):
            raise NotImplementedError("gradient clipping is not in the reference")
        slow = {"img_encoder"} if s.get("hist_encoder_10x", False) else {"img_encoder",
                                                                         "hist_encoder"}
        self.params = [(p, 0.1 if n.split(".", 1)[0] in slow else 1.0)
                       for n, p in model.named_parameters()]
        self.lr, self.mom = onecycle(s["lr"], total_steps, s["div_factor"],
                                     s["final_div_factor"])
        self.wd = s["wd"]
        self.mu = [torch.zeros_like(p) for p, _ in self.params]
        self.nu = [torch.zeros_like(p) for p, _ in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self):
        f32 = np.float32
        b1, t = f32(self.mom(self.count)), f32(self.count + 1)
        bc1, bc2 = float(f32(1) - b1 ** t), float(f32(1) - f32(B2) ** t)
        lr = f32(self.lr(self.count))
        for (p, scale), mu, nu in zip(self.params, self.mu, self.nu):
            g = p.grad
            mu.mul_(float(b1)).add_(g * float(f32(1) - b1))
            nu.mul_(B2).add_(g * g * float(f32(1) - f32(B2)))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS) + self.wd * p
            p.add_(u * -float(f32(lr * f32(scale))))
        self.count += 1


def first_moment_factor(settings: Dict) -> float:
    """1 - b1 at the first step: the first moment after one step is the
    first gradient times this."""
    _, mom = onecycle(settings["lr"], settings["total_steps"], settings["div_factor"],
                      settings["final_div_factor"])
    return float(np.float32(1) - np.float32(mom(0)))


def step_generator(seed: int) -> torch.Generator:
    """The CPU generator of one step's positional-encoding crops."""
    return torch.Generator().manual_seed(int(seed))


def train_steps(model, settings: Dict, geoms, batches: List[Dict[str, torch.Tensor]],
                seeds: List[int], total_steps: int):
    """Runs one optimizer step a batch on ``model`` (in place) and returns
    ``(losses, first_grad_norms, change_norms)``: each step's loss, each
    parameter's gradient norm at the first step, and the norm of each
    parameter's change over all the steps, in ``named_parameters`` order."""
    opt = AdamW(model, settings, total_steps)
    start = [p.detach().clone() for p, _ in opt.params]
    losses, grad_norms = [], None
    model.train()
    for batch, seed in zip(batches, seeds):
        for p, _ in opt.params:
            p.grad = None
        _, pred = model(batch["image"], batch["hist_data"], batch["mask"], geoms,
                        step_generator(seed))
        loss = silog(pred, batch["depth"], settings["min_depth"])
        loss.backward()
        if grad_norms is None:
            grad_norms = [float(torch.linalg.vector_norm(p.grad)) for p, _ in opt.params]
        opt.step()
        losses.append(float(loss.detach()))
    change = [float(torch.linalg.vector_norm(p.detach() - p0))
              for (p, _), p0 in zip(opt.params, start)]
    return losses, grad_norms, change
