"""CFPNet and the DELTAR baseline (``cfpnet_torch/models/deltar.py::Deltar``):
the port's model, its plain reference (``reference/model.py``), weights,
inputs and work counts, behind the interface the drivers call
(``families/__init__.py``).

The port is imported lazily, inside the functions that build it, so that
importing this module loads nothing of the system under test.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List

import torch
from torch import nn

from .. import inputs as generator
from .. import weights
from ..reference import counters, geometry
from ..reference import model as ref
from ..reference import train as ref_train

SERVED = ("image", "hist_data", "mask")  # the served inputs, in the forward's order
HOST_OUTPUTS = 2  # bin edges and depth map, the first two outputs of the forward
MODES = {"frames": "online_eval", "train": "train"}  # the port's mode of each driver


def widths(tiny: bool) -> Dict:
    return ref.TINY if tiny else ref.B3


def port_config(settings: Dict, **over):
    """The port's ``Config`` carrying a configuration's settings."""
    from cfpnet_torch.config import Config

    fields = {f.name for f in dataclasses.fields(Config)}
    return Config().replace(**{**{k: v for k, v in settings.items() if k in fields}, **over})


def inputs(settings: Dict, driver: str, n: int, seed: int):
    """``n`` frames of the driver's mode (``inputs.make``): ``image``,
    ``depth``, ``hist_data`` and ``mask`` by name."""
    return generator.make(settings, MODES[driver], n, seed)


# Weights. Every product and convolution weight is normal with standard
# deviation ``gain / sqrt(fan_in)``: LeCun's (gain 1), except the image
# encoder's convolutions that feed a SiLU, whose gain 1.3 slows the vanishing
# of the encoder's activations over its 31 blocks (a SiLU halves a small
# signal). The positional encodings are normal with 0.2 (the published
# model's ``0.2 * randn``), biases zero, normalization scales one, BatchNorm
# statistics mean 0 and variance 1.
#
# Why these: the output check compares a bf16 forward with the float32
# reference, and its control is the reference with fp8 products, so the
# network must neither amplify rounding chaotically nor lose its input.
# Measured on the card (the reference in bf16 and in fp8 against float32, two
# frames each of four seeds), the depth map's RMS error over its RMS:
#
# - gain 1.3: bf16 0.81-1.46%, fp8 7.6-17%; swapping the image under the same
#   histograms moves the depth map by 2.5-5.1% (the encoder's output std
#   0.005-0.009);
# - gain 1.0: bf16 0.77-1.19%, fp8 7.0-16.6%, but the image moves it by only
#   0.6-1.3% (encoder std 1.5e-4), under the bf16 noise;
# - gain 1.5 (six seeds through the port): bf16 1%-130%, chaotic on some
#   seeds; BatchNorm statistics calibrated to each layer's input: bf16 1.9-3.5%
#   against fp8 3.5-7.9%, chaotic everywhere.
SILU_GAIN = 1.3
# the stem, and each block's convolutions that a SiLU follows
SILU_INPUT = re.compile(r"^img_encoder\..*(conv0\.0|\.conv|conv_exp|conv_pw|conv_dw|"
                        r"se\.conv_reduce)\.weight$")


def init_state(settings: Dict, seed: int, device, tiny: bool = False) -> Dict[str, torch.Tensor]:
    """The state dict of a fresh model for ``settings`` on ``device``, under
    the reference's parameter names (the port's too)."""
    skeleton = ref.build(settings, "meta", widths(tiny))
    norms = {name for name, m in skeleton.named_modules()
             if isinstance(m, (ref.BatchNorm, nn.LayerNorm))}

    def rule(name, t):
        owner, leaf = name.rsplit(".", 1)
        if leaf == "running_var" or (owner in norms and leaf == "weight"):
            return "const", 1.0
        if leaf in ("running_mean", "bias"):
            return "const", 0.0
        gain = SILU_GAIN if SILU_INPUT.match(name) else 1.0
        return "normal", (0.2 if leaf.startswith("positional_encodings")
                          else gain * t[0].numel() ** -0.5)

    return weights.draw(skeleton.state_dict(), rule, seed, device)


# Frames: the port's eval forward in the cell's dtype, captured in a CUDA graph.

def frame_model(settings: Dict, state, dtype, device, tiny: bool = False):
    """The port's eval model with ``state`` loaded, cast to ``dtype``
    (``models/deltar.py::cast_to_compute_dtype``)."""
    from cfpnet_torch.models.deltar import cast_to_compute_dtype, make_model

    model = make_model(port_config(settings, mode="online_eval", tiny_model=tiny), device=device)
    model.load_state_dict(state)
    return cast_to_compute_dtype(model, dtype)


def capture_forward(model, geoms, batch: int, config):
    """The port's forward captured in a CUDA graph (the timed path)."""
    from cfpnet_torch.graphs import CapturedForward

    return CapturedForward(model, geoms, batch, config)


def capture_frames(model, settings: Dict, batch: int, tiny: bool = False):
    """``forward(image, hist_data, mask)`` of ``batch`` frames: the
    outputs ``(bin_edges, pred, prob, None)``."""
    from cfpnet_torch.models.deltar import model_geometries

    config = port_config(settings, mode="online_eval", tiny_model=tiny)
    return capture_forward(model, model_geometries(config, "online_eval"), batch, config)


def frame_reference(settings: Dict, state, dtype, device, tiny: bool = False):
    """The plain reference's eval forward in ``dtype`` (its depth tail in
    float32), ``forward(image, hist_data, mask) -> (bin_edges, pred)``."""
    model = ref.build(settings, device, widths(tiny)).to(dtype)
    model.load_state_dict(state)
    geoms = geometry.for_mode(settings, "online_eval")
    return lambda image, hist, mask: model(image, hist, mask, geoms)


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


# Train: the production train step (``train/steps.py::make_train_step`` on
# ``create_train_state``), eager, and the reference's first steps.

def train_program(settings: Dict, state, traffic: Dict, device, tiny: bool = False):
    """``(model, optimizer state, step)`` with ``state`` loaded;
    ``step(optimizer state, batch, seed) -> loss``."""
    from cfpnet_torch.models.deltar import make_model, model_geometries
    from cfpnet_torch.train import steps

    config = port_config(settings, mode="train", compute_dtype=traffic["dtype"],
                         bs=traffic["batch"], tiny_model=tiny)
    model = make_model(config, device=device)
    model.load_state_dict(state)
    opt_state = steps.create_train_state(model, config, settings["total_steps"])
    return model, opt_state, steps.make_train_step(model, config, model_geometries(config, "train"))


def first_gradient(opt_state, settings: Dict) -> Dict[str, float]:
    """The first gradient's norm by parameter name, after one step: AdamW's
    first moment's norm over 1 - b1."""
    mu = {k: v for group in opt_state.tx.state_dict().values() for k, v in group["mu"].items()}
    norms = torch.stack(torch._foreach_norm(list(mu.values()))).cpu().tolist()
    b1 = ref_train.first_moment_factor(settings)
    return {k: n / b1 for k, n in zip(mu, norms)}


def reference_steps(settings: Dict, state, batches: List[Dict], seeds: List[int], device,
                    tiny: bool = False) -> Dict:
    """The reference's steps from ``state`` on ``batches`` and ``seeds``:
    ``losses``, ``grads`` (first gradient norms) and ``change`` (change
    norms) by parameter name."""
    model = ref.build(settings, device, widths(tiny))
    model.load_state_dict(state)
    losses, grads, change = ref_train.train_steps(
        model, settings, geometry.for_mode(settings, "train"), batches, seeds,
        settings["total_steps"])
    names = [name for name, _ in model.named_parameters()]
    return dict(losses=losses, grads=dict(zip(names, grads)), change=dict(zip(names, change)))


def work(settings: Dict, traffic: Dict):
    """``(operations, kernel calls)`` of one traced item of the mix: an eval
    forward at its batch, or a train step (counted on the reference,
    ``reference/counters.py``)."""
    if traffic["driver"] == "train":
        return counters.train_step_flops(dict(settings, bs=traffic["batch"])), []
    return counters.count(settings, "online_eval", traffic["batch"])
