"""Latency and work of the eval forward and of the train step.

    python -m cfpnet_torch.evaluate_time @configs/train_cfpnet_combine1.txt \\
        [--eager] [--profile_flops] [--device cpu] [--niters N] [--weight_path ref.pt]
    python -m cfpnet_torch.evaluate_time @configs/train_cfpnet_combine1.txt --train \\
        [--profile_flops] [--device cpu] [--niters N]

Port of the root ``evaluate_time.py`` (``timed_forward``,
``graph_flops_eval``, ``timed_train_step``, ``graph_flops_train`` and its
CLI) for the eval forward and the train step in f32:

- ``timed_forward(graphed=True)``: the forward captured once in a CUDA graph
  (``graphs.CapturedForward``), then K replays between two CUDA events
  (``graphed_latency_ms``, ``replay_latency_ms``),
  ``max(4, niters // K)`` times; the trimmed mean of the sorted repetitions
  ``[1:-1]`` over K. The counterpart of ``timed_forward(chained=True)``,
  which chains K forwards inside one jit.
- ``timed_forward(graphed=False)``: the per-call eager protocol
  (``eager_latency_ms``), CUDA events
  around each forward after a warmup, trimmed mean ``sorted[1:-2]``. On the
  CPU (``--device cpu``) the host clock times the same calls.
- ``forward_flops``: the operations of one forward, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` over the CPU forward through
  the plain versions, plus each depthwise conv's 2·k²·B·H·W·C, which the
  counter cannot see (the plain conv is a loop of elementwise
  multiply-adds). The count is the same in any dtype and needs no card.
- ``param_count``: the model's parameters (BatchNorm statistics are buffers
  here and ``batch_stats`` in flax, and count in neither).
- ``timed_train_step``: the production train step (``train_config``: bs 16
  at 416x544, as the root ``bench.py::train_config``) on one synthetic
  batch, eager: ``warmup`` steps, then K steps between two CUDA events,
  ``max(1, niters // K)`` times, the trimmed mean of the sorted repetitions
  ``[1:-1]`` over K (the mean where there are fewer than three). The
  counterpart of the root ``timed_train_step``, which chains K steps inside
  one jit. On the CPU the host clock times the same steps.
- ``flops_train``: the model's operations a train step, three times the
  training forward's and the loss's (``forward_flops``'s rule at bs=1,
  times the batch): the backward of every product and convolution costs
  twice its forward, the depthwise convs' included (input and weight
  gradient, each as many operations as the conv). Work the port does on
  top is not counted: the backward of the attention and fused LoFTR kernels
  recomputes their forward, and the optimizer's update is elementwise (the
  root figure is XLA's cost analysis of the step, which counts that
  elementwise work).

The inputs are one sample of the config's eval dataset collated
``batch_size`` times, as the root ``evaluate_time.py`` takes them; where
that dataset is not ported (NYUv2, ZJUL5: ROADMAP §A item 5) the synthetic
one stands in, as the root script falls back to it without the dataset on
disk. Weights: ``--weight_path`` (``weights.load_reference_checkpoint``),
else the golden tests' deterministic ones. ``--serving_artifact`` is not
ported (ROADMAP §A item 10). Runs on the card unless ``--device cpu``,
where only ``--eager`` can run: a CUDA graph needs a card.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import weights
from .config import parse_config
from .data.datasets import SyntheticDataset, collate, make_dataset
from .graphs import CapturedForward
from .models.convnext import LargeKernelDWConv
from .models.deltar import make_model, model_geometries
from .train import steps

Inputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def load_model(config, device="cuda", state_dict=None) -> torch.nn.Module:
    """The eval model on ``device`` carrying ``state_dict``, or the golden
    tests' deterministic weights."""
    model = make_model(config, device=device)
    if state_dict is None:
        state_dict = weights.deterministic_state_dict(config, tiny=config.tiny_model)
    model.load_state_dict(state_dict, strict=True)
    return model


def make_inputs(config, batch_size: int = 1, device="cuda") -> Inputs:
    """(image, hist, mask): one eval sample collated ``batch_size`` times."""
    try:
        sample = make_dataset(config, "online_eval")[0]
    except NotImplementedError:
        sample = SyntheticDataset(config, "online_eval")[0]
    batch = collate([sample] * batch_size)
    return tuple(torch.from_numpy(batch[k]).to(device) for k in ("image", "hist_data", "mask"))


def eager_latency_ms(model, inputs: Inputs, geoms, niters: int, warmup: int = 5) -> float:
    """Trimmed mean ``sorted[1:-2]`` of ``niters`` timed forwards after
    ``warmup``: CUDA events around each call on the card, the host clock
    on the CPU."""
    cuda = inputs[0].device.type == "cuda"
    times = []
    with torch.no_grad():
        for i in range(warmup + niters):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                model(*inputs, geoms)
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end)
            else:
                t0 = time.perf_counter()
                model(*inputs, geoms)
                ms = (time.perf_counter() - t0) * 1e3
            if i >= warmup:
                times.append(ms)
    times.sort()
    trimmed = times[1:-2] if len(times) > 3 else times
    return float(np.mean(trimmed))


def replay_latency_ms(captured: CapturedForward, niters: int = 500, K: int = 100) -> float:
    """Milliseconds a replay of ``captured`` on the inputs in its buffers:
    ``min(K, niters)`` replays between two CUDA events, ``max(4, niters //
    K)`` times, trimmed mean of the sorted repetitions ``[1:-1]``."""
    K = max(1, min(K, niters))
    captured.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(max(4, niters // K)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(K):
            captured.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / K)
    times.sort()
    return float(np.mean(times[1:-1]))


def graphed_latency_ms(model, inputs: Inputs, geoms, config, niters: int = 500,
                       K: int = 100) -> float:
    """Milliseconds of one forward on ``inputs``, captured in a CUDA graph
    at their batch size (``replay_latency_ms``); the graph and its memory
    are freed on return."""
    captured = CapturedForward(model, geoms, inputs[0].shape[0], config)
    captured(*inputs)
    return replay_latency_ms(captured, niters, K)


def timed_forward(config, batch_size: int = 1, niters: int = 500, K: int = 100,
                  graphed: bool = True, state_dict=None, device="cuda") -> float:
    """Milliseconds of one forward at ``batch_size``, graphed or eager
    (module docstring)."""
    model = load_model(config, device, state_dict)
    geoms = model_geometries(config, "online_eval")
    inputs = make_inputs(config, batch_size, device)
    if graphed:
        return graphed_latency_ms(model, inputs, geoms, config, niters, K)
    return eager_latency_ms(model, inputs, geoms, niters)


def forward_flops(config, batch_size: int = 1, tiny: bool = False) -> int:
    """Operations of one eval forward at (batch_size, native size)."""
    from torch.utils.flop_counter import FlopCounterMode

    model = make_model(config, tiny=tiny, device="cpu")
    geoms = model_geometries(config, "online_eval")
    zones = config.eval_zone_num ** 2
    image = torch.zeros(batch_size, config.native_height, config.native_width, 3)
    hist = torch.zeros(batch_size, zones, config.zone_sample_num)
    mask = torch.ones(batch_size, zones, dtype=torch.bool)
    dwconv = []

    def count(module, args, out):
        dwconv.append(2 * module.weight.shape[-1] ** 2 * out.numel())

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, LargeKernelDWConv)]
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(image, hist, mask, geoms)
    finally:
        for h in hooks:
            h.remove()
    return counter.get_total_flops() + sum(dwconv)


def train_config(config):
    """The production train step's shape (configs/train_cfpnet_combine1.txt):
    bs 16 at 416x544, 6x6 train zones of 64 px, the root
    ``bench.py::train_config`` without its environment overrides."""
    return config.replace(mode="train", bs=16, input_height=416, input_width=544,
                          train_zone_num=6, drop_hist=0.34, noise_mean=0.17, noise_sigma=0.20,
                          noise_prob=0.30, disable_clip_grad=True, hist_encoder_10x=True)


def make_train_batch(config, batch_size: int, device="cuda") -> Dict[str, torch.Tensor]:
    """``batch_size`` samples of the synthetic train set (the root
    ``timed_train_step``'s batch), collated, on ``device``."""
    ds = SyntheticDataset(config.replace(dataset="synthetic"), "train", length=batch_size)
    batch = collate([ds[i] for i in range(batch_size)])
    return {k: torch.from_numpy(batch[k]).to(device)
            for k in ("image", "depth", "hist_data", "mask")}


def timed_train_step(config, niters: int = 40, K: int = 10, warmup: int = 3,
                     state_dict=None, device="cuda", tiny: bool = False) -> float:
    """Milliseconds of one train step at the config's batch size and input
    size (module docstring). ``state_dict``: the starting weights, else the
    golden tests' deterministic ones."""
    cfg = config.replace(mode="train")
    model = make_model(cfg, tiny=tiny, device=device)
    model.load_state_dict(state_dict if state_dict is not None
                          else weights.deterministic_state_dict(cfg, tiny=tiny), strict=True)
    geoms = model_geometries(cfg, "train")
    state = steps.create_train_state(model, cfg, total_steps=max(1000, niters + warmup))
    train_step = steps.make_train_step(model, cfg, geoms)
    batch = make_train_batch(cfg, cfg.bs, device)
    seeds = iter(range(cfg.seed, cfg.seed + 10 ** 6))
    for _ in range(warmup):
        train_step(state, batch, next(seeds))
    return train_latency_ms(lambda: train_step(state, batch, next(seeds)), niters, K,
                            cuda=torch.device(device).type == "cuda")


def train_latency_ms(step, niters: int, K: int, cuda: bool = True) -> float:
    """Milliseconds a ``step()`` (a train step that returns its loss):
    ``min(K, niters)`` steps between two CUDA events (the host clock
    where not ``cuda``), ``max(1, niters // K)`` times, trimmed mean
    ``[1:-1]`` of the sorted repetitions (their mean where fewer than
    three). Raises if the last loss is not finite."""
    K = max(1, min(K, niters))
    times = []
    for _ in range(max(1, niters // K)):
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(K):
                loss = step()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / K)
        else:
            t0 = time.perf_counter()
            for _ in range(K):
                loss = step()
            times.append((time.perf_counter() - t0) * 1e3 / K)
    if not torch.isfinite(loss):
        raise FloatingPointError(f"train step loss {float(loss)}")
    times.sort()
    return float(np.mean(times[1:-1] if len(times) > 2 else times))


def flops_train(config, batch_size: Optional[int] = None, tiny: bool = False) -> int:
    """Operations of one train step at (batch_size, input size): three times
    those of the training forward and the loss, counted at bs=1 on the CPU
    by ``forward_flops``'s rule (module docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = config.replace(mode="train")
    model = make_model(cfg, tiny=tiny, device="cpu")
    geoms = model_geometries(cfg, "train")
    zones = cfg.train_zone_num ** 2
    h, w = cfg.input_height, cfg.input_width
    batch = dict(image=torch.zeros(1, h, w, 3), depth=torch.ones(1, h, w, 1),
                 hist_data=torch.ones(1, zones, cfg.zone_sample_num),
                 mask=torch.ones(1, zones, dtype=torch.bool))
    dwconv = []

    def count(module, args, out):
        dwconv.append(2 * module.weight.shape[-1] ** 2 * out.numel())

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, LargeKernelDWConv)]
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            steps.make_loss_fn(model, cfg, geoms)(batch, steps.step_generator(0))
    finally:
        for hook in hooks:
            hook.remove()
    return 3 * (counter.get_total_flops() + sum(dwconv)) * (batch_size or cfg.bs)


def param_count(config) -> int:
    """Parameters of the model (BatchNorm statistics are buffers)."""
    return sum(p.numel() for p in make_model(config, device="meta").parameters())


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eager", action="store_true")
    ap.add_argument("--profile_flops", action="store_true")
    ap.add_argument("--niters", type=int, default=500)
    ap.add_argument("--train", action="store_true")
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    config = parse_config(rest).replace(mode="online_eval")
    if config.serving_artifact:
        raise NotImplementedError("--serving_artifact: serving is not ported yet "
                                  "(ROADMAP.md §A item 10)")
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    sd = weights.load_reference_checkpoint(config.weight_path) if config.weight_path else None
    if args.train:
        return train_main(config, args, sd, device)
    ms = timed_forward(config, niters=args.niters, graphed=not args.eager, state_dict=sd,
                       device=device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu, host clock"
    out: Dict[str, object] = dict(latency_ms_bs1=ms, graphed=not args.eager, device=where,
                                  niters=args.niters)
    print(f"{ms:.3f} ms")
    print(f"{1000.0 / ms:.2f} frames/sec/chip" if device.type == "cuda"
          else f"{1000.0 / ms:.2f} frames/sec on the CPU")
    print(f"(bs=1, f32, {'eager' if args.eager else 'CUDA graph'}; {where})")
    if args.profile_flops:
        out["params"] = param_count(config)
        out["flops"] = forward_flops(config)
        print(f"params: {out['params'] / 1e6:.3f} M, flops/forward: {out['flops'] / 1e9:.2f} G")
    return out


def train_main(config, args, state_dict, device) -> Dict[str, object]:
    """``--train``: ms a train step at the config's batch size and input
    size (``timed_train_step``, ``--niters`` steps), images/s, and with
    ``--profile_flops`` the operations a step (``flops_train``)."""
    cfg = config.replace(mode="train")
    ms = timed_train_step(cfg, niters=args.niters, state_dict=state_dict, device=device,
                          tiny=cfg.tiny_model)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu, host clock"
    out: Dict[str, object] = {f"train_ms_bs{cfg.bs}": ms, "train_img_s": cfg.bs * 1000.0 / ms,
                              "device": where, "niters": args.niters}
    print(f"{ms:.3f} ms a train step")
    print(f"{cfg.bs * 1000.0 / ms:.2f} images/sec")
    print(f"(bs={cfg.bs} at {cfg.input_height}x{cfg.input_width}, f32, eager; {where})")
    if args.profile_flops:
        out["flops_train"] = flops_train(cfg, tiny=cfg.tiny_model)
        print(f"flops/train step: {out['flops_train'] / 1e9:.2f} G")
    return out


if __name__ == "__main__":
    main()
