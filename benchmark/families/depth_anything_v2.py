"""Depth Anything V2, metric (``cfpnet_torch/models/depth_anything.py``): the
port's model, its plain reference (``reference/depth_anything_v2.py``),
weights, inputs and work counts, behind the frames interface of
``families/__init__.py``. The model reads the image alone and gives one
output, the depth map [B, H, W, 1].

The port is imported lazily, inside the functions that build it, so that
importing this module loads nothing of the system under test.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import inputs as generator
from .. import weights
from ..reference import depth_anything_v2 as ref
from .cfpnet import _rms, port_config

SERVED = ("image",)
HOST_OUTPUTS = 1  # the depth map


def sizes(settings: Dict, tiny: bool) -> Dict:
    return ref.TINY if tiny else ref.widths(settings)


def inputs(settings: Dict, driver: str, n: int, seed: int):
    """``n`` frames' ``image`` [n, H, W, 3]: the image ``inputs.make`` gives
    for the same seed (its synthetic scenes, drawn first from the same
    generator), ImageNet-normalized."""
    rng = np.random.default_rng([int(seed), 1])
    _, img = generator.scenes(rng, n, settings["native_height"], settings["native_width"],
                              settings["max_depth"])
    image = (img - generator.IMAGENET_MEAN) / generator.IMAGENET_STD
    return dict(image=image.astype(np.float32))


# Weights. Every product and convolution weight is normal with standard
# deviation 1 / sqrt(fan_in) (LeCun's; a transposed convolution's fan-in is its
# input channels, each output pixel taking one tap), biases zero, LayerNorm
# scales one, ``cls_token``, ``pos_embed`` and ``mask_token`` normal with 0.02
# (DINOv2's ``trunc_normal_(std=.02)``), and LayerScale ``gamma`` 0.1.
#
# Why these: the output check compares a bf16 forward with the float32
# reference, and its control is the reference with fp8 products, so the depth
# map must move with the image well above the bf16 noise, the sigmoid must
# not saturate (where it does, rounding is squashed along with the signal),
# and fp8 must stay well apart from bf16. Measured on the card (the reference
# in bf16 and in fp8 against float32, two frames each of three seeds; the
# image's move is the RMS change of the map between two frames over its RMS):
#
# - gamma 0.1: fp8's error 7.1-8.7 times bf16's; the image moves the map by
#   53-80 times bf16's error; pre-sigmoid logits mean 0.25-1.47, std 0.88-0.93,
#   at most 0.13% of pixels past |4|;
# - gamma 1.0 (DAv2's ``init_values``): the 24 branches swamp the patch
#   signal on some seeds: one of three saturates (mean logit 3.2, 10% of pixels
#   past |4|, depth 19.1 of 20 m) with fp8 only 4.3 times bf16 and the image
#   12 times; the others 6.0-8.5 and 21-26 times;
# - the last convolution's deviation times 0.3 (either gamma): no saturation,
#   but fp8 4.8-10 times bf16 and the image 17-57 times.
POSITION_STD = 0.02
LAYERSCALE = 0.1
NORMS = ("norm", "norm1", "norm2")
DECONVS = ("depth_head.resize_layers.0.weight", "depth_head.resize_layers.1.weight")


def init_state(settings: Dict, seed: int, device, tiny: bool = False) -> Dict[str, torch.Tensor]:
    """The state dict of a fresh model for ``settings`` on ``device``, under
    the published parameter names (the reference's and the port's)."""
    skeleton = ref.build(settings, "meta", sizes(settings, tiny)).state_dict()

    def rule(name, t):
        owner, leaf = name.rsplit(".", 1)
        if leaf == "bias":
            return "const", 0.0
        if leaf == "weight" and owner.rsplit(".", 1)[-1] in NORMS:
            return "const", 1.0
        if leaf == "gamma":
            return "const", LAYERSCALE
        if leaf in ("cls_token", "pos_embed", "mask_token"):
            return "normal", POSITION_STD
        if name in DECONVS:
            return "normal", t.shape[0] ** -0.5
        return "normal", t[0].numel() ** -0.5

    return weights.draw(skeleton, rule, seed, device)


def frame_model(settings: Dict, state, dtype, device, tiny: bool = False):
    """The port's model (``make_model`` for ``--model_name
    depth_anything_v2``) with ``state`` loaded, cast to ``dtype``
    (``cast_to_compute_dtype``)."""
    from cfpnet_torch.models.deltar import cast_to_compute_dtype, make_model

    model = make_model(port_config(settings, mode="online_eval", tiny_model=tiny), device=device)
    model.load_state_dict(state)
    return cast_to_compute_dtype(model, dtype)


def capture_frames(model, settings: Dict, batch: int, tiny: bool = False):
    """``forward(image)`` of ``batch`` frames through the port's CUDA graph
    (``graphs.CapturedForward``, whose one buffer is the image): ``(pred,)``."""
    from cfpnet_torch.graphs import CapturedForward

    return CapturedForward(model, None, batch,
                           port_config(settings, mode="online_eval", tiny_model=tiny))


def frame_reference(settings: Dict, state, dtype, device, tiny: bool = False):
    """The plain reference in ``dtype``, ``forward(image) -> (pred,)``."""
    model = ref.build(settings, device, sizes(settings, tiny)).to(dtype)
    model.load_state_dict(state)
    return lambda image: (model(image),)


def frame_gaps(got, want, same) -> Dict[str, float]:
    """``pred``: the RMS error of the depth maps of all sampled frames against
    the float32 reference, over the same RMS error of the reference run in
    the cell's dtype (``same``; 1 where that is float32), as for CFPNet
    (``families/cfpnet.py::frame_gaps``)."""
    err = _rms([g[0] for g in got], [w[0] for w in want])
    return dict(pred=err / (_rms([s[0] for s in same], [w[0] for w in want]) if same else 1.0))


def work(settings: Dict, traffic: Dict):
    """``(operations, kernel calls)`` of one frame of ``traffic["batch"]``
    images, counted on the reference: the encoder's products, the attention
    and the head (``reference/depth_anything_v2.py::count``), and one
    ``("softmax_attention", (B, H, N, D))`` a block."""
    parts, calls = ref.count(settings, traffic["batch"])
    return sum(parts.values()), calls
