"""Optimizer: AdamW with two learning-rate groups and the OneCycle schedule,
with optax's semantics.

Port of ``cfpnet_tpu/train/optim.py`` (``onecycle_schedules``,
``param_group_labels``, ``make_optimizer``; reference train.py:79-94). The
JAX optimizer is ``optax.multi_transform`` of two
``optax.inject_hyperparams(optax.adamw)`` (backbone at lr/10, the rest at
lr), chained after ``optax.clip_by_global_norm(0.1)`` unless
``--disable_clip_grad``. ``AdamW`` below is that chain written out on the
model's parameters and their ``.grad``; ``torch.optim.AdamW`` differs from
it in every point listed here, so it is not used:

- b1 is the momentum schedule, and the bias correction ``1 - b1**t`` takes
  the current b1 at each count t;
- b2 = 0.999 and eps = 1e-8, added outside the square root;
- the weight decay (``--wd``, 0.1) is added to the Adam direction before
  the step scales it by -lr, and it reaches every parameter, BatchNorm
  scales and biases included (optax gets no mask here);
- both schedules are read at the count before it is incremented, in
  float32 (as the JAX schedules compute), and cast to the parameters' type
  (``inject_hyperparams`` casts to the type of the first update leaf);
- the clip scales every gradient by max/norm where the global norm is not
  below max (``optax.clip_by_global_norm``), with no 1e-6 added to the norm
  as ``torch.nn.utils.clip_grad_norm_`` adds.

The state (moments, count) lives on the parameters' device; a step launches
a few ``torch._foreach_*`` kernels per group and makes no host sync. Each
update is written as optax writes it, one rounding per operation (no fused
multiply-adds), so that float64 runs match optax to the last bits but one.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Tuple

import numpy as np
import torch

from ..kernels.dtypes import dtype_name

B2 = 0.999
EPS = 1e-8
CLIP_NORM = 0.1
LR_SCALE = {"backbone": 0.1, "rest": 1.0}


def onecycle_schedules(max_lr: float, total_steps: int, div_factor: float = 25.0,
                       final_div_factor: float = 100.0, pct_start: float = 0.3,
                       base_momentum: float = 0.85, max_momentum: float = 0.95
                       ) -> Tuple[Callable[[int], float], Callable[[int], float]]:
    """(lr_fn, momentum_fn) of a step count, torch OneCycleLR's cosine
    shapes with the JAX package's formulas, ``step_size_up = pct * total - 1``
    included. Each returns the ``np.float32`` that the JAX schedule computes:
    the arithmetic runs in numpy float32 with the same operations in the
    same order (Python constants rounded to float32 first, as JAX's weak
    types are), up to the last bit of the cosine."""
    f32 = np.float32
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    step_size_up = float(pct_start * total_steps) - 1.0
    step_size_down = float(total_steps - step_size_up) - 1.0

    def anneal(start, end, pct):
        # the cosine of the float32 angle, correctly rounded to float32; XLA's
        # own float32 cosine is off from it by one bit at a few angles
        cos_out = f32(math.cos(f32(math.pi) * pct)) + f32(1.0)
        return f32(end) + f32((start - end) / 2.0) * cos_out

    def phase(step, up_pair, down_pair):
        step = f32(step)
        up = anneal(*up_pair, np.clip(step / f32(step_size_up), f32(0.0), f32(1.0)))
        down = anneal(*down_pair, np.clip((step - f32(step_size_up)) / f32(step_size_down),
                                          f32(0.0), f32(1.0)))
        return up if step <= f32(step_size_up) else down

    def lr_fn(step: int) -> np.float32:
        return phase(step, (initial_lr, max_lr), (max_lr, min_lr))

    def mom_fn(step: int) -> np.float32:
        return phase(step, (max_momentum, base_momentum), (base_momentum, max_momentum))

    return lr_fn, mom_fn


def param_group_labels(names: Iterable[str], hist_encoder_10x: bool = True) -> Dict[str, str]:
    """'backbone' (lr/10) or 'rest' (lr) for each parameter name, by its
    top-level module (reference deltar.py:68-82): ``img_encoder`` is always
    slow; ``hist_encoder`` is slow unless ``hist_encoder_10x``.

    The self-supervised variant's joint model (``train/selfsup.py``, names
    ``depth.*`` and ``pose.*``) is labelled as the JAX package labels its
    ``{"depth", "pose"}`` tree: the depth model's names by their module
    below ``depth.``, every PoseNet parameter 'rest'."""
    names = list(names)
    slow = {"img_encoder"} if hist_encoder_10x else {"img_encoder", "hist_encoder"}
    if {n.split(".", 1)[0] for n in names} == {"depth", "pose"}:
        depth = param_group_labels([n[len("depth."):] for n in names if n.startswith("depth.")],
                                   hist_encoder_10x)
        return {n: depth[n[len("depth."):]] if n.startswith("depth.") else "rest"
                for n in names}
    return {n: "backbone" if n.split(".", 1)[0] in slow else "rest" for n in names}


class AdamW:
    """``make_optimizer``'s optax chain on ``named_params`` (name,
    parameter) pairs: ``step()`` reads each parameter's ``.grad`` and
    updates the parameter in place; parameters without a gradient are left
    as they are (a zero gradient in optax still decays them: every
    parameter of the model has one)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]], lr: float,
                 total_steps: int, wd: float = 0.1, div_factor: float = 25.0,
                 final_div_factor: float = 100.0, hist_encoder_10x: bool = True,
                 clip_grad: bool = False):
        named = list(named_params)
        self.labels = param_group_labels([n for n, _ in named], hist_encoder_10x)
        self.groups: Dict[str, List[torch.nn.Parameter]] = {g: [] for g in LR_SCALE}
        for name, p in named:
            self.groups[self.labels[name]].append(p)
        self.named = named
        self.params = [p for _, p in named]
        self.lr_fn, self.mom_fn = onecycle_schedules(lr, total_steps, div_factor,
                                                     final_div_factor)
        self.wd = wd
        self.clip_grad = clip_grad
        self.mu = {id(p): torch.zeros_like(p) for p in self.params}
        self.nu = {id(p): torch.zeros_like(p) for p in self.params}
        self.count = 0  # optimizer steps taken: the schedules' count

    def hyperparams(self, dtype) -> Dict[str, float]:
        """The scalars of this step in the parameters' type, as optax makes
        them: the schedules in float32 (the group's lr the float32 product
        ``lr_fn(count) * scale``), cast to ``dtype`` with b2, eps and wd, and
        ``1 - b1``, ``1 - b1**t``, ``1 - b2**t`` (t = count + 1) computed in
        ``dtype``. Python floats that hold those values exactly."""
        dt = np.dtype(dtype_name(dtype)).type
        b1, b2, one, t = dt(self.mom_fn(self.count)), dt(B2), dt(1), dt(self.count + 1)
        lr = {g: float(dt(self.lr_fn(self.count) * np.float32(scale)))
              for g, scale in LR_SCALE.items()}
        return dict(lr=lr, b1=float(b1), b2=float(b2), one_b1=float(one - b1),
                    one_b2=float(one - b2), bc1=float(one - b1 ** t), bc2=float(one - b2 ** t),
                    eps=float(dt(EPS)), wd=float(dt(self.wd)))

    @torch.no_grad()
    def step(self) -> None:
        grads = {id(p): p.grad for p in self.params if p.grad is not None}
        if self.clip_grad:
            grads = self._clip(grads)
        h = self.hyperparams(self.params[0].dtype)
        for group, params in self.groups.items():
            params = [p for p in params if id(p) in grads]
            if not params:
                continue
            g = [grads[id(p)] for p in params]
            mu = [self.mu[id(p)] for p in params]
            nu = [self.nu[id(p)] for p in params]
            # mu = (1 - b1) * g + b1 * mu;  nu = (1 - b2) * g**2 + b2 * nu
            torch._foreach_mul_(mu, h["b1"])
            torch._foreach_add_(mu, torch._foreach_mul(g, h["one_b1"]))
            torch._foreach_mul_(nu, h["b2"])
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), h["one_b2"]))
            # u = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd * p;  p += -lr * u
            den = torch._foreach_sqrt(torch._foreach_div(nu, h["bc2"]))
            torch._foreach_add_(den, h["eps"])
            u = torch._foreach_div(torch._foreach_div(mu, h["bc1"]), den)
            torch._foreach_add_(u, torch._foreach_mul(params, h["wd"]))
            torch._foreach_mul_(u, -h["lr"][group])
            torch._foreach_add_(params, u)
        self.count += 1

    def state_dict(self) -> Dict[str, dict]:
        """Each group's state as optax keeps it: ``{group: {"count": int,
        "mu": {name: tensor}, "nu": {name: tensor}}}`` (the tensors are the
        live moments; ``torch.save`` copies them)."""
        out = {g: {"count": self.count, "mu": {}, "nu": {}} for g in LR_SCALE}
        for name, p in self.named:
            g = out[self.labels[name]]
            g["mu"][name] = self.mu[id(p)]
            g["nu"][name] = self.nu[id(p)]
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, dict]) -> None:
        """Copies a ``state_dict()`` (from this optimizer, a checkpoint or
        ``weights.opt_state_from_optax``) into the moments and count; raises
        unless it holds exactly this optimizer's groups and parameters."""
        counts = {int(state[g]["count"]) for g in LR_SCALE}
        if len(counts) != 1:
            raise ValueError(f"the groups' counts differ: {counts}")
        for key in ("mu", "nu"):
            held = {(g, n) for g in LR_SCALE for n in state[g][key]}
            want = {(self.labels[n], n) for n, _ in self.named}
            if held != want:
                raise ValueError(f"{key} for other parameters or groups: "
                                 f"{sorted(held ^ want)[:5]}")
        for name, p in self.named:
            g = state[self.labels[name]]
            self.mu[id(p)].copy_(g["mu"][name])
            self.nu[id(p)].copy_(g["nu"][name])
        self.count = counts.pop()

    @staticmethod
    def _clip(grads: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
        """``optax.clip_by_global_norm(0.1)``: every gradient times
        max/norm unless norm < max, chosen on the device."""
        g = list(grads.values())
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
        keep = norm < CLIP_NORM
        clipped = [torch.where(keep, x, x / norm * CLIP_NORM) for x in g]
        return dict(zip(grads, clipped))


def make_optimizer(model: torch.nn.Module, config, total_steps: int) -> AdamW:
    """The optimizer of the train step (``cfpnet_tpu/train/optim.py::
    make_optimizer``) on ``model``'s parameters."""
    return AdamW(model.named_parameters(), config.lr, total_steps, wd=config.wd,
                 div_factor=config.div_factor, final_div_factor=config.final_div_factor,
                 hist_encoder_10x=config.hist_encoder_10x,
                 clip_grad=not config.disable_clip_grad)
