"""The test family ``toy``: a frames-only family of two convolutions. Its
program is ``torch.nn`` modules, its reference ``reference/toy.py``; on a
card its forward is captured in a CUDA graph (``graphs.CapturedCall``)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from .. import weights
from ..reference import toy as ref

SERVED = ("image",)
HOST_OUTPUTS = 1


def channels(settings: Dict, tiny: bool) -> int:
    return 4 if tiny else settings["channels"]


def inputs(settings: Dict, driver: str, n: int, seed: int):
    rng = np.random.default_rng([int(seed), 7])
    shape = (n, settings["height"], settings["width"], 3)
    return dict(image=rng.standard_normal(shape, dtype=np.float32))


def init_state(settings: Dict, seed: int, device, tiny: bool = False):
    def rule(name, t):
        if name.endswith("bias"):
            return "const", 0.0
        return "normal", t[0].numel() ** -0.5

    skeleton = ref.build(settings, "meta", channels(settings, tiny)).state_dict()
    return weights.draw(skeleton, rule, seed, device)


class Program(nn.Module):
    def __init__(self, channels: int, max_depth: float):
        super().__init__()
        self.max_depth = max_depth
        self.conv1 = nn.Conv2d(3, channels, 3, padding=1)
        self.conv2 = nn.Conv2d(channels, 1, 3, padding=1)

    def forward(self, image):
        x = self.conv2(torch.relu(self.conv1(image.permute(0, 3, 1, 2))))
        return ((torch.sigmoid(x) * self.max_depth).permute(0, 2, 3, 1),)


def frame_model(settings: Dict, state, dtype, device, tiny: bool = False):
    with torch.device(device):
        model = Program(channels(settings, tiny), settings["max_depth"])
    model.load_state_dict({k.replace("_", ".", 1): v for k, v in state.items()})
    return model.to(dtype).eval()


def capture_frames(model, settings: Dict, batch: int, tiny: bool = False):
    from cfpnet_torch.graphs import CapturedCall

    param = next(model.parameters())
    image = torch.zeros(batch, settings["height"], settings["width"], 3, device=param.device,
                        dtype=param.dtype)
    return CapturedCall(model, (image,), SERVED)


def frame_reference(settings: Dict, state, dtype, device, tiny: bool = False):
    model = ref.build(settings, device, channels(settings, tiny)).to(dtype)
    model.load_state_dict(state)
    return lambda image: (model(image),)


def frame_gaps(got, want, same) -> Dict[str, float]:
    def rms(xs, ys):
        return float(torch.sqrt(sum(((x[0].double() - y[0].double()) ** 2).sum()
                                    for x, y in zip(xs, ys)) / sum(y[0].numel() for y in ys)))

    return dict(pred=rms(got, want) / (rms(same, want) if same else 1.0))


def work(settings: Dict, traffic: Dict):
    from torch.utils.flop_counter import FlopCounterMode

    model = ref.build(settings, "meta", settings["channels"])
    image = torch.zeros(traffic["batch"], settings["height"], settings["width"], 3,
                        device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(image)
    return counter.get_total_flops(), []
