"""The two ways a traffic mix drives the system under test (``cfpnet_torch``).

A mix's ``driver`` names one of them; everything else it holds is a
parameter of that driver. Each driver builds the system in set-up, runs the
measured window, runs the traced items, and then judges what the timed path
produced against the reference (``check``), after freeing the system's
state.

- ``frames``: one client in a closed loop sends frames of ``batch`` images
  from a pool of ``pool`` distinct ones, cycled. A frame is the port's eval
  forward captured in a CUDA graph (``graphs.CapturedForward``) on the model
  cast to ``dtype`` (``models/deltar.py::cast_to_compute_dtype``), called on
  the frame's pinned host tensors, its depth map and bin edges copied back to
  pinned host memory; its time runs from the call until both are on the
  host. ``check_frames`` outputs of the window, a sample drawn from the seed,
  are kept and compared with the reference's forward on the same inputs.
- ``train``: the production train step (``train/steps.py::make_train_step``
  on ``create_train_state``), eager, in a closed loop over a pool of
  ``pool`` distinct batches of ``batch`` images staged on the card, each step
  with its own seed. Set-up drives the step through its first
  ``check_steps`` steps, keeps their losses, the first gradient's norm per
  parameter (worked out from the first moment after one step) and the norm
  of each parameter's change, and the window continues from that state; the
  reference repeats those steps from the same weights.
"""

from __future__ import annotations

import dataclasses
import gc
import random
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from . import inputs, weights
from .reference import geometry
from .reference import model as ref
from .reference import train as ref_train


def port_config(settings: Dict, **over):
    """The port's ``Config`` carrying a configuration's settings."""
    from cfpnet_torch.config import Config

    fields = {f.name for f in dataclasses.fields(Config)}
    return Config().replace(**{**{k: v for k, v in settings.items() if k in fields}, **over})


def step_seed(seed: int, i: int) -> int:
    """The seed of train step ``i`` of a run."""
    return (int(seed) * 1_000_003 + i) % 2 ** 62


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def capture_forward(model, geoms, batch: int, config):
    """The port's forward captured in a CUDA graph (the timed path)."""
    from cfpnet_torch.graphs import CapturedForward

    return CapturedForward(model, geoms, batch, config)


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
    def __init__(self, settings: Dict, traffic: Dict, seed: int, device="cuda",
                 widths: Dict = ref.B3):
        from cfpnet_torch.models.deltar import cast_to_compute_dtype, make_model, model_geometries

        self.settings, self.traffic, self.seed, self.device = settings, traffic, seed, device
        self.widths = widths
        self.phases = Phases()
        self.dtype = getattr(torch, traffic["dtype"])
        bs, n = traffic["batch"], traffic["pool"]
        data = inputs.make(settings, "online_eval", n * bs, seed)
        pin = torch.device(device).type == "cuda"
        # the served inputs, in the dtype they are served in; the reference reads the same values
        self.pool = [tuple(torch.from_numpy(data[k][i * bs:(i + 1) * bs]).to(
            self.dtype if k != "mask" else torch.bool) for k in ("image", "hist_data", "mask"))
            for i in range(n)]
        if pin:
            self.pool = [tuple(t.pin_memory() for t in frame) for frame in self.pool]
        self.phases.mark("inputs")
        self.state = weights.init_state(settings, seed, device, widths)
        if pin:
            torch.cuda.reset_peak_memory_stats()
        self.phases.mark("weights")
        config = port_config(settings, mode="online_eval",
                             tiny_model=widths is not ref.B3)
        model = make_model(config, device=device)
        model.load_state_dict(self.state)
        self.model = cast_to_compute_dtype(model, self.dtype)
        self.phases.mark("model")
        self.forward = capture_forward(self.model, model_geometries(config, "online_eval"), bs,
                                       config)
        self.out = [torch.empty(o.shape, dtype=o.dtype, pin_memory=pin)
                    for o in self.forward(*self.pool[0])[:2]]
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
            for host, dev in zip(self.out, outs[:2]):
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
        and returns the gaps (``frame_gaps``) of the port's outputs; with
        ``control`` (a context the reference then runs in, for a lower
        precision) also those of the control's outputs on the same frames,
        else None."""
        del self.forward, self.model
        free(self.device)
        model = ref.build(self.settings, self.device, self.widths)
        model.load_state_dict(self.state)
        low = None
        if self.dtype != torch.float32:
            low = ref.build(self.settings, self.device, self.widths).to(self.dtype)
            low.load_state_dict(self.state)
        geoms = geometry.for_mode(self.settings, "online_eval")
        want, same, got, ctl = [], [], [], []
        with torch.no_grad():
            for k, outs in self.sample:
                image, hist, mask = (t.to(self.device) for t in self.pool[k])
                args = (image.float(), hist.float(), mask, geoms)
                want.append([t.cpu() for t in model(*args)])
                got.append(outs)
                if low is not None:
                    same.append([t.cpu() for t in low(image, hist, mask, geoms)])
                if control is not None:
                    with control():
                        ctl.append([t.cpu() for t in model(*args)])
        return (frame_gaps(got, want, same),
                frame_gaps(ctl, want, same) if control is not None else None)


def frame_gaps(got, want, same) -> Dict[str, float]:
    """``pred``: the RMS error of the depth maps of all sampled frames over
    the same RMS error of the plain reference run in the cell's dtype
    (``same``; 1 where that is float32): the error in units of the error
    that the dtype alone makes on these frames and weights, which differs
    from seed to seed by a factor of four. The bin edges are not compared
    on their own: they come from a mean over the whole map, which averages
    rounding away (fp8's error on them is under twice bf16's), and every
    depth reads them through the bin centres."""
    err = _rms([g[1] for g in got], [w[1] for w in want])
    return dict(pred=err / (_rms([s[1] for s in same], [w[1] for w in want]) if same else 1.0))


def _rms(xs, ys) -> float:
    return float(torch.sqrt(sum(((x.double() - y.double()) ** 2).sum() for x, y in zip(xs, ys))
                            / sum(y.numel() for y in ys)))


class Train:
    def __init__(self, settings: Dict, traffic: Dict, seed: int, device="cuda",
                 widths: Dict = ref.B3):
        from cfpnet_torch.models.deltar import make_model, model_geometries
        from cfpnet_torch.train import steps

        self.settings, self.traffic, self.seed, self.device = settings, traffic, seed, device
        self.widths = widths
        self.phases = Phases()
        bs, n = traffic["batch"], traffic["pool"]
        data = inputs.make(settings, "train", n * bs, seed)
        self.host = {k: torch.from_numpy(v) for k, v in data.items()}
        dev = {k: v.to(device) for k, v in self.host.items()}
        self.batches = [{k: v[i * bs:(i + 1) * bs] for k, v in dev.items()} for i in range(n)]
        self.phases.mark("inputs")
        self.state = weights.init_state(settings, seed, device, widths)
        self.start = {k: v.cpu() for k, v in self.state.items()}
        self.phases.mark("weights")
        config = port_config(settings, mode="train", compute_dtype=traffic["dtype"], bs=bs,
                             tiny_model=widths is not ref.B3)
        self.model = make_model(config, device=device)
        self.model.load_state_dict(self.state)
        del self.state
        self.opt_state = steps.create_train_state(self.model, config, settings["total_steps"])
        self.step = steps.make_train_step(self.model, config, model_geometries(config, "train"))
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
            if i == 0:  # the first moment after one step, as the optimizer keeps it
                mu = {k: v for group in self.opt_state.tx.state_dict().values()
                      for k, v in group["mu"].items()}
                first = torch.stack(torch._foreach_norm([mu[k] for k, _ in named])).cpu()
        change = torch.stack(torch._foreach_norm(torch._foreach_sub(
            [p.detach() for _, p in named], start))).cpu()
        names = [name for name, _ in named]
        return dict(losses=[float(v) for v in losses],
                    mu=dict(zip(names, first.tolist())), change=dict(zip(names, change.tolist())))

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
        got = dict(self.readings)
        b1 = ref_train.first_moment_factor(self.settings)
        got["grads"] = {k: v / b1 for k, v in got.pop("mu").items()}
        worst = train_gaps(got, want)
        if control is None:
            return worst, None
        with control():
            return worst, train_gaps(self.reference(), want)

    def reference(self) -> Dict:
        """The reference's first steps from the same weights on the same
        batches and seeds: ``losses``, ``grads`` (first gradient norms) and
        ``change`` (change norms) by parameter name."""
        n, bs = self.traffic["check_steps"], self.traffic["batch"]
        model = ref.build(self.settings, self.device, self.widths)
        model.load_state_dict(self.start)
        batches = [{k: v[i * bs:(i + 1) * bs].to(self.device) for k, v in self.host.items()}
                   for i in range(n)]
        losses, grads, change = ref_train.train_steps(
            model, self.settings, geometry.for_mode(self.settings, "train"), batches,
            [step_seed(self.seed, i) for i in range(n)], self.settings["total_steps"])
        names = [name for name, _ in model.named_parameters()]
        return dict(losses=losses, grads=dict(zip(names, grads)), change=dict(zip(names, change)))


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
