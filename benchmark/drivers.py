"""The two ways a traffic mix drives the system under test (``cfpnet_torch``).

A mix's ``driver`` names one of them; everything else it holds is a
parameter of that driver. Each driver builds the system in set-up, runs the
measured window, runs the traced items, and then judges what the timed path
produced against the reference (``check``), after freeing the system's
state. What belongs to the model (its inputs, weights, the port's model and
step, the plain reference, the comparison) the driver takes from the cell's
family (``families/<name>.py``), passed in as ``family``; ``tiny`` asks the
family for its test widths.

- ``frames``: one client in a closed loop sends frames of ``batch`` images
  from a pool of ``pool`` distinct ones, cycled. A frame is the family's
  captured forward (for ``cfpnet``: the port's eval forward in a CUDA graph,
  ``graphs.CapturedForward``) on the model cast to ``dtype``, called on the
  frame's pinned host tensors (``family.SERVED``), its first
  ``family.HOST_OUTPUTS`` outputs (for ``cfpnet``: bin edges and depth map)
  copied back to pinned host memory; its time runs from the call until they
  are on the host. ``check_frames`` outputs of the window, a sample drawn
  from the seed, are kept and compared with the reference's forward on the
  same inputs (``family.frame_gaps``).
- ``train``: the family's train step, eager, in a closed loop over a pool of
  ``pool`` distinct batches of ``batch`` images staged on the card, each step
  with its own seed. Set-up drives the step through its first
  ``check_steps`` steps, keeps their losses, the first gradient's norm per
  parameter (``family.first_gradient``, from the optimizer's state after one
  step) and the norm of each parameter's change, and the window continues
  from that state; the reference repeats those steps from the same weights.
"""

from __future__ import annotations

import gc
import random
import statistics
import time
from typing import Dict, List

import numpy as np
import torch


def step_seed(seed: int, i: int) -> int:
    """The seed of train step ``i`` of a run."""
    return (int(seed) * 1_000_003 + i) % 2 ** 62


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class Phases(dict):
    """Seconds of each phase of a driver's set-up, in order."""

    def __init__(self):
        super().__init__()
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self[name] = now - self.t
        self.t = now


class Frames:
    def __init__(self, family, settings: Dict, traffic: Dict, seed: int, device="cuda",
                 tiny: bool = False):
        self.family, self.settings, self.traffic, self.seed = family, settings, traffic, seed
        self.device, self.tiny = device, tiny
        self.phases = Phases()
        self.dtype = getattr(torch, traffic["dtype"])
        bs, n = traffic["batch"], traffic["pool"]
        data = family.inputs(settings, "frames", n * bs, seed)
        pin = torch.device(device).type == "cuda"
        # the served inputs, the floating ones in the dtype they are served in; the reference
        # reads the same values
        self.pool = [tuple(_served(torch.from_numpy(data[k][i * bs:(i + 1) * bs]), self.dtype)
                           for k in family.SERVED) for i in range(n)]
        if pin:
            self.pool = [tuple(t.pin_memory() for t in frame) for frame in self.pool]
        self.phases.mark("inputs")
        self.state = family.init_state(settings, seed, device, tiny)
        if pin:
            torch.cuda.reset_peak_memory_stats()
        self.phases.mark("weights")
        self.model = family.frame_model(settings, self.state, self.dtype, device, tiny)
        self.phases.mark("model")
        self.forward = family.capture_frames(self.model, settings, bs, tiny)
        self.out = [torch.empty(o.shape, dtype=o.dtype, pin_memory=pin)
                    for o in self.forward(*self.pool[0])[:family.HOST_OUTPUTS]]
        self.phases.mark("capture")
        self.sample: List = []
        self.frames = 0
        self.rnd = random.Random(seed)
        for i in range(traffic["warmup"]):
            self.frame(i)
        self.frames, self.sample = 0, []
        self.phases.mark("warmup")

    def frame(self, i: int):
        """Frame ``i`` of the loop: the pool's frame ``i % pool`` through the
        port and back to the host; its output kept in the sample as the
        seeded reservoir draws it."""
        k = i % len(self.pool)
        with torch.profiler.record_function("bench.frame"):
            outs = self.forward(*self.pool[k])
            for host, dev in zip(self.out, outs):
                host.copy_(dev, non_blocking=True)
            if self.out[0].is_pinned():
                torch.cuda.current_stream().synchronize()
        j = self.frames if self.frames < self.traffic["check_frames"] else \
            self.rnd.randint(0, self.frames)
        if j < self.traffic["check_frames"]:
            kept = (k, [o.clone() for o in self.out])
            if j < len(self.sample):
                self.sample[j] = kept
            else:
                self.sample.append(kept)
        self.frames += 1

    def window(self, seconds: float) -> Dict:
        lat = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            self.frame(self.frames)
            lat.append(time.perf_counter() - t)
        elapsed = time.perf_counter() - t0
        images = len(lat) * self.traffic["batch"]
        return dict(infer_img_s=images / elapsed,
                    infer_ms_p95=1e3 * statistics.quantiles(lat, n=100)[94],
                    attempted=len(lat), failed=0, rate=images / elapsed)

    def traced(self):
        """The traced frames, after the window; the sample stays the window's."""
        n, sample = self.traffic["trace_frames"], list(self.sample)
        for _ in range(n):
            self.frame(self.frames)
        self.sample = sample
        return n, n * self.traffic["batch"]

    def check(self, control=None):
        """Frees the port, runs the reference on each sampled frame's inputs
        and returns the gaps (``family.frame_gaps``) of the port's outputs;
        with ``control`` (a context the reference then runs in, for a lower
        precision) also those of the control's outputs on the same frames,
        else None."""
        del self.forward, self.model
        free(self.device)
        family = self.family
        model = family.frame_reference(self.settings, self.state, torch.float32, self.device,
                                       self.tiny)
        low = None
        if self.dtype != torch.float32:
            low = family.frame_reference(self.settings, self.state, self.dtype, self.device,
                                         self.tiny)
        want, same, got, ctl = [], [], [], []
        with torch.no_grad():
            for k, outs in self.sample:
                served = [t.to(self.device) for t in self.pool[k]]
                wide = [_served(t, torch.float32) for t in served]
                want.append([t.cpu() for t in model(*wide)])
                got.append(outs)
                if low is not None:
                    same.append([t.cpu() for t in low(*served)])
                if control is not None:
                    with control():
                        ctl.append([t.cpu() for t in model(*wide)])
        return (family.frame_gaps(got, want, same),
                family.frame_gaps(ctl, want, same) if control is not None else None)


def _served(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` in ``dtype`` where it is floating; a mask as it is."""
    return t.to(dtype) if t.is_floating_point() else t


class Train:
    def __init__(self, family, settings: Dict, traffic: Dict, seed: int, device="cuda",
                 tiny: bool = False):
        self.family, self.settings, self.traffic, self.seed = family, settings, traffic, seed
        self.device, self.tiny = device, tiny
        self.phases = Phases()
        bs, n = traffic["batch"], traffic["pool"]
        data = family.inputs(settings, "train", n * bs, seed)
        self.host = {k: torch.from_numpy(v) for k, v in data.items()}
        dev = {k: v.to(device) for k, v in self.host.items()}
        self.batches = [{k: v[i * bs:(i + 1) * bs] for k, v in dev.items()} for i in range(n)]
        self.phases.mark("inputs")
        state = family.init_state(settings, seed, device, tiny)
        self.start = {k: v.cpu() for k, v in state.items()}
        self.phases.mark("weights")
        self.model, self.opt_state, self.step = family.train_program(settings, state, traffic,
                                                                     device, tiny)
        del state
        self.phases.mark("model")
        self.steps = 0
        self.readings = self._first_steps(traffic["check_steps"])
        self.phases.mark("checked_steps")
        for _ in range(traffic["warmup"]):
            self.one()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        self.phases.mark("warmup")

    def one(self):
        i = self.steps
        with torch.profiler.record_function("bench.step"):
            loss = self.step(self.opt_state, self.batches[i % len(self.batches)],
                             step_seed(self.seed, i))
        self.steps += 1
        return loss

    @torch.no_grad()
    def _first_steps(self, n: int) -> Dict:
        """The check's readings of the system's first ``n`` steps."""
        named = list(self.model.named_parameters())
        start = [p.detach().clone() for _, p in named]
        losses = []
        for i in range(n):
            with torch.enable_grad():
                losses.append(self.one())
            if i == 0:  # from the optimizer's state after one step
                grads = self.family.first_gradient(self.opt_state, self.settings)
        change = torch.stack(torch._foreach_norm(torch._foreach_sub(
            [p.detach() for _, p in named], start))).cpu()
        names = [name for name, _ in named]
        return dict(losses=[float(v) for v in losses], grads=grads,
                    change=dict(zip(names, change.tolist())))

    def window(self, seconds: float) -> Dict:
        losses = []
        cuda = torch.device(self.device).type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            losses.append(self.one())
        if cuda:
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        images = len(losses) * self.traffic["batch"]
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return dict(train_img_s=images / elapsed, attempted=len(losses), failed=failed,
                    rate=images / elapsed)

    def traced(self):
        n = self.traffic["trace_steps"]
        for _ in range(n):
            self.one()
        return n, n * self.traffic["batch"]

    def check(self, control=None):
        """Frees the port, repeats the first steps with the reference and
        returns the worst gaps (``train_gaps``) of the port's readings; with
        ``control`` (a context the reference then runs in, for a lower
        precision) also those of the control's, else None."""
        del self.step, self.opt_state, self.model, self.batches
        free(self.device)
        want = self.reference()
        worst = train_gaps(self.readings, want)
        if control is None:
            return worst, None
        with control():
            return worst, train_gaps(self.reference(), want)

    def reference(self) -> Dict:
        """The reference's first steps from the same weights on the same
        batches and seeds (``family.reference_steps``)."""
        n, bs = self.traffic["check_steps"], self.traffic["batch"]
        batches = [{k: v[i * bs:(i + 1) * bs].to(self.device) for k, v in self.host.items()}
                   for i in range(n)]
        return self.family.reference_steps(self.settings, self.start, batches,
                                           [step_seed(self.seed, i) for i in range(n)],
                                           self.device, self.tiny)


def train_gaps(got: Dict, want: Dict) -> Dict[str, float]:
    """``loss``: the relative gap of the first step's loss; ``grad`` and
    ``change``: the largest gap of a parameter's first gradient norm and of
    its change norm over the steps, against the reference's norm of that
    parameter or of the median parameter, whichever is larger; ``change``
    over the parameters whose reference gradient is at least a thousandth of
    the median parameter's (the others move by rounding alone).
    ``loss_steps``: each step's relative loss gap, not compared: from the
    second step on, Adam's normalized update turns the rounding of tiny
    gradient elements into whole steps of the learning rate, on both sides
    alike, and the later losses carry that (1 to 13 float32 units against
    the first step's 0 to 1); the later steps are judged through ``change``."""
    g_med = float(np.median(list(want["grads"].values())))
    c_med = float(np.median(list(want["change"].values())))
    steps = [abs(p - r) / abs(r) for p, r in zip(got["losses"], want["losses"])]
    worst = dict(loss=steps[0], grad=0.0, change=0.0, loss_steps=steps)
    for name, g in want["grads"].items():
        worst["grad"] = max(worst["grad"], abs(got["grads"][name] - g) / max(g, g_med))
        if g >= 1e-3 * g_med:
            c = want["change"][name]
            worst["change"] = max(worst["change"], abs(got["change"][name] - c) / max(c, c_med))
    return worst


DRIVERS = {"frames": Frames, "train": Train}
