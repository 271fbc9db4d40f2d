"""Work of the reference model: operations, and the calls of each kernel of
the system under test with their least time on the card.

The counts come from the plain reference (``model.py``) on PyTorch's
``meta`` device, so they cost no memory, and count the same work whatever a
later version of the system under test runs it with:

- operations: ``torch.utils.flop_counter.FlopCounterMode`` over the forward
  (its products and convolutions, two operations a multiply-add; the
  depthwise convs count 2 k^2 a output element as ``F.conv2d(groups=C)``);
  a train step is three times its forward and loss, the backward of every
  product costing twice its forward;
- kernel calls: each unmasked LoFTR encoder layer is one call of the fused
  LoFTR kernel, each large-kernel depthwise conv one call of the dwconv
  kernel and each cross-zone attention one call of the attention kernel,
  with the shapes they take here;
- least time of a call: the larger of its bytes over the card's memory rate
  and its operations over the arithmetic rate it runs at (``least_ms``),
  each input read once and each output written once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .. import peaks
from . import geometry
from .model import B3, DWConv, LoFTREncoderLayer, LoFTRNewCross9, build
from .train import silog, step_generator

Call = Tuple[str, Tuple[int, ...]]


def count(settings: Dict, mode: str, batch: int = 1, widths: Dict = B3):
    """``(operations, calls)`` of one forward at ``batch`` images (``mode``
    ``"train"``: the training forward and the loss on the train crop;
    otherwise the eval forward of a native frame). ``calls`` lists the kernel
    calls in order as ``(kernel, shape)``."""
    from torch.utils.flop_counter import FlopCounterMode

    model = build(settings, "meta", widths)
    calls: List[Call] = []

    def loftr(module, args, out):
        x, src = args
        calls.append(("fused_loftr", (x.shape[0], x.shape[1], src.shape[1], x.shape[2],
                                      module.nhead)))

    def dwconv(module, args, out):
        B, H, W, C = args[0].shape
        calls.append(("dwconv", (B, H, W, C, module.weight.shape[-1])))

    def cross(module, args, out):
        feat, rect, H, W = args
        zy0, zy1, zx0, zx1 = rect
        C = feat.shape[2]
        calls.append(("linear_attention", (feat.shape[0], feat.shape[1],
                                           (zy1 - zy0) * (zx1 - zx0), module.nhead,
                                           C // module.nhead)))

    hooks = {LoFTREncoderLayer: loftr, DWConv: dwconv, LoFTRNewCross9: cross}
    for m in model.modules():
        if type(m) in hooks:
            m.register_forward_hook(hooks[type(m)])
    s = settings
    geoms = geometry.for_mode(s, mode)
    if mode == "train":
        h, w, zones = s["input_height"], s["input_width"], s["train_zone_num"] ** 2
        model.train()
    else:
        h, w, zones = s["native_height"], s["native_width"], s["eval_zone_num_cfg"] ** 2
    with torch.device("meta"):
        image = torch.zeros(batch, h, w, 3)
        hist = torch.zeros(batch, zones, s["zone_sample_num"])
        mask = torch.ones(batch, zones, dtype=torch.bool)
        depth = torch.ones(batch, h, w, 1)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        _, pred = model(image, hist, mask, geoms, step_generator(0) if mode == "train" else None)
        if mode == "train":
            silog(pred, depth, s["min_depth"])
    return counter.get_total_flops(), calls


def train_step_flops(settings: Dict, widths: Dict = B3) -> int:
    """Operations of one train step at the configuration's batch size."""
    return 3 * count(settings, "train", 1, widths)[0] * settings["bs"]


def bytes_and_ops(kernel: str, shape: Tuple[int, ...], itemsize: int) -> Tuple[int, int]:
    """Bytes a call must move and operations it must do, from its shape."""
    if kernel == "dwconv":
        B, H, W, C, k = shape
        return itemsize * (2 * B * H * W * C + C * k * k + C), 2 * k * k * B * H * W * C
    if kernel == "linear_attention":
        N, L, S, H, D = shape
        return (itemsize * (2 * N * L * H * D + 2 * N * S * H * D),
                N * H * (2 * S * D * D + S * D + 2 * L * D * D + 2 * L * D))
    if kernel == "fused_loftr":
        N, L, S, C, H = shape
        D = C // H
        return (itemsize * (2 * N * L * C + N * S * C + 10 * C * C + 4 * C),
                2 * (N * L * 8 * C * C + N * S * 2 * C * C + N * H * (S + L) * D * D))
    raise KeyError(kernel)


# the arithmetic each kernel's operations run at, by the dtype of its inputs:
# the fused LoFTR layer's products on the tensor cores (bf16 products with f32
# sums; 3xTF32 in float32, three TF32 products each), the others on the
# CUDA cores in float32
KERNEL_RATE = {("fused_loftr", "bfloat16"): peaks.BF16, ("fused_loftr", "float32"): peaks.TF32 / 3}


def least_ms(kernel: str, shape: Tuple[int, ...], dtype: str) -> float:
    """The least time of one call on the card, in ms."""
    itemsize = {"bfloat16": 2, "float32": 4}[dtype]
    nbytes, ops = bytes_and_ops(kernel, shape, itemsize)
    return 1e3 * max(nbytes / peaks.BYTES, ops / KERNEL_RATE.get((kernel, dtype), peaks.F32))
