"""Static zone geometry of the ToF grid at each decoder scale.

A frozen copy of the zone arithmetic of the CFPNet reference loader
(``src/utils/dataloader.py:13-40, 93-102`` of denyingmxd/CFPNet) and the
reductions of its ``TransformerFusion.forward`` (``src/models/fusion.py:66-84``),
folded into Python ints: the zone grid is centred on the image, each zone a
square of ``patch_px`` pixels, and each scale divides by its conv patch size
(4, 8, 16) with truncation toward zero.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class Scale:
    """Zone region at one decoder scale, in feature-map cells."""

    zone_num: int
    p1: int  # zone height in cells
    p2: int  # zone width in cells
    sy_wo: int  # zone region before padding: top, left, bottom, right
    sx_wo: int
    ey_wo: int
    ex_wo: int
    pad_h: int  # symmetric pad of the map before the zone region is cut
    pad_w: int
    H: int  # map size
    W: int

    @property
    def sy(self):
        return self.sy_wo + self.pad_h

    @property
    def sx(self):
        return self.sx_wo + self.pad_w

    @property
    def ey(self):
        return self.ey_wo + self.pad_h

    @property
    def ex(self):
        return self.ex_wo + self.pad_w

    @property
    def interpolate(self) -> bool:
        return (self.ey - self.sy != self.p1 * self.zone_num
                or self.ex - self.sx != self.p2 * self.zone_num)

    @property
    def rect(self):
        """(zy0, zy1, zx0, zx1): the zone region clipped to the map."""
        return (min(max(self.sy_wo, 0), self.H), min(max(self.ey_wo, 0), self.H),
                min(max(self.sx_wo, 0), self.W), min(max(self.ex_wo, 0), self.W))


def scales(img_h: int, img_w: int, zone_num: int, patch_px: int,
           patch_sizes=(4, 8, 16)) -> Dict[int, Scale]:
    """The geometry of a centred ``zone_num`` x ``zone_num`` grid of
    ``patch_px`` pixel zones on an ``img_h`` x ``img_w`` image, per scale."""
    y0 = float(int((img_h - patch_px * zone_num) / 2))
    x0 = float(int((img_w - patch_px * zone_num) / 2))
    y1, x1 = y0 + patch_px * zone_num, x0 + patch_px * zone_num
    pad_h = max(abs(min(y0, 0.0)), max(y1 - img_h, 0.0))
    pad_w = max(abs(min(x0, 0.0)), max(x1 - img_w, 0.0))
    return {c: Scale(zone_num, math.ceil(patch_px / c), math.ceil(patch_px / c),
                     int(y0 / c), int(x0 / c), int(y1 / c), int(x1 / c),
                     math.ceil(pad_h / c), math.ceil(pad_w / c), img_h // c, img_w // c)
            for c in patch_sizes}


def for_mode(settings, mode: str) -> Dict[int, Scale]:
    """Train: ``train_zone_num`` zones of ``train_patch_px`` on the train
    crop; eval: ``eval_zone_num_cfg`` zones of ``eval_patch_px`` on the
    native frame."""
    s = settings
    if mode == "train":
        return scales(s["input_height"], s["input_width"], s["train_zone_num"],
                      s["train_patch_px"])
    return scales(s["native_height"], s["native_width"], s["eval_zone_num_cfg"],
                  s["eval_patch_px"])
