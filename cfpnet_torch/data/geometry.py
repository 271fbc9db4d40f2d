"""Static zone geometry.

Port (a copy) of ``cfpnet_tpu/data/geometry.py``: ``ScaleGeometry``,
``ZoneGeometry``, ``scales_from_rects``, ``zone_offset_for`` and
``geometry_for``.

The reference recomputes per-sample "patch_info" tensors inside the data
loader (reference src/utils/dataloader.py:13-40) and then reduces them back
to python ints inside the fusion module (reference src/models/fusion.py:
66-84). In practice the geometry is a pure function of (image size, zone
grid, zone pixel size, integer offset) and is *constant per mode*, so it is
folded into static Python ints: every slice and pad of the fusion path has a
fixed shape.

Semantics are matched op-for-op against ``patch_info_from_rect_data``:
- ``p1/p2``      = ceil(zone pixel size / conv patch size)
- ``sy_wo/..``   = trunc(min/max rect coords / conv patch size)   (torch
  ``.to(torch.int32)`` truncates toward zero)
- ``pad``        = ceil(max out-of-bounds pixel overhang / conv patch size)
- ``interpolate``= (ey-sy) != p1*zone_num or (ex-sx) != p2*zone_num
  (reference fusion.py:82-84)
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


def _trunc_div(a: float, b: int) -> int:
    """Match torch ``(a / b).to(torch.int32)``: float divide, trunc to zero."""
    return int(a / b)


@dataclass(frozen=True)
class ScaleGeometry:
    """Zone-region geometry at one decoder scale (one conv patch size)."""

    conv_patch_size: int
    zone_num: int
    # per-zone patch size in feature-map cells
    p1: int
    p2: int
    # zone region bounds in feature-map cells, before padding
    sy_wo: int
    sx_wo: int
    ey_wo: int
    ex_wo: int
    # symmetric pad (in cells) applied to the feature map before slicing
    pad_h: int
    pad_w: int
    # feature-map size at this scale
    H: int
    W: int

    @property
    def sy(self) -> int:
        return self.sy_wo + self.pad_h

    @property
    def sx(self) -> int:
        return self.sx_wo + self.pad_w

    @property
    def ey(self) -> int:
        return self.ey_wo + self.pad_h

    @property
    def ex(self) -> int:
        return self.ex_wo + self.pad_w

    @property
    def tzh(self) -> int:
        return self.ey - self.sy

    @property
    def tzw(self) -> int:
        return self.ex - self.sx

    @property
    def interpolate(self) -> bool:
        return (self.tzh != self.p1 * self.zone_num) or (self.tzw != self.p2 * self.zone_num)

    # clipped zone-rectangle bounds on the (unpadded) feature map — the
    # region the reference's ``zone_mask`` marks True (fusion.py:103-104).
    @property
    def zy0(self) -> int:
        return min(max(self.sy_wo, 0), self.H)

    @property
    def zy1(self) -> int:
        return min(max(self.ey_wo, 0), self.H)

    @property
    def zx0(self) -> int:
        return min(max(self.sx_wo, 0), self.W)

    @property
    def zx1(self) -> int:
        return min(max(self.ex_wo, 0), self.W)

    @property
    def num_inside(self) -> int:
        return (self.zy1 - self.zy0) * (self.zx1 - self.zx0)

    @property
    def num_outside(self) -> int:
        return self.H * self.W - self.num_inside


@dataclass(frozen=True)
class ZoneGeometry:
    """Full geometry for one (mode, resolution, zone grid) combination."""

    img_h: int
    img_w: int
    zone_num: int
    patch_px_h: int
    patch_px_w: int
    offset_y: int = 0
    offset_x: int = 0

    @property
    def sy_px(self) -> int:
        # reference src/utils/dataloader.py:101-102
        return int((self.img_h - self.patch_px_h * self.zone_num) / 2) + self.offset_y

    @property
    def sx_px(self) -> int:
        return int((self.img_w - self.patch_px_w * self.zone_num) / 2) + self.offset_x

    def zone_rects(self) -> np.ndarray:
        """(Z, 4) float32 [sy, sx, ey, ex] pixel rects, row-major zones.

        Matches the ``fr`` tensor (reference src/utils/dataloader.py:121-123).
        """
        zn = self.zone_num
        sy = np.array(
            [self.sy_px + i * self.patch_px_h for i in range(zn) for _ in range(zn)],
            dtype=np.float32,
        )
        sx = np.array(
            [self.sx_px + j * self.patch_px_w for _ in range(zn) for j in range(zn)],
            dtype=np.float32,
        )
        return np.stack([sy, sx, sy + self.patch_px_h, sx + self.patch_px_w], axis=1)

    def at_scale(self, conv_patch_size: int) -> ScaleGeometry:
        """Geometry at one decoder scale.

        Mirrors ``patch_info_from_rect_data`` (reference
        src/utils/dataloader.py:24-37) followed by the reductions in
        ``TransformerFusion.forward`` (reference fusion.py:71-84).
        """
        cps = conv_patch_size
        rect_y0 = float(self.sy_px)
        rect_x0 = float(self.sx_px)
        rect_y1 = float(self.sy_px + self.patch_px_h * self.zone_num)
        rect_x1 = float(self.sx_px + self.patch_px_w * self.zone_num)

        _pad_h = max(abs(min(rect_y0, 0.0)), max(rect_y1 - self.img_h, 0.0))
        _pad_w = max(abs(min(rect_x0, 0.0)), max(rect_x1 - self.img_w, 0.0))

        return ScaleGeometry(
            conv_patch_size=cps,
            zone_num=self.zone_num,
            p1=math.ceil(self.patch_px_h / cps),
            p2=math.ceil(self.patch_px_w / cps),
            sy_wo=_trunc_div(rect_y0, cps),
            sx_wo=_trunc_div(rect_x0, cps),
            ey_wo=_trunc_div(rect_y1, cps),
            ex_wo=_trunc_div(rect_x1, cps),
            pad_h=math.ceil(_pad_h / cps),
            pad_w=math.ceil(_pad_w / cps),
            H=self.img_h // cps,
            W=self.img_w // cps,
        )

    def scales(self, patch_sizes=(4, 8, 16)) -> Dict[int, ScaleGeometry]:
        return {cps: self.at_scale(cps) for cps in patch_sizes}


def scales_from_rects(
    fr: np.ndarray, img_h: int, img_w: int, patch_sizes=(4, 8, 16)
) -> Dict[int, ScaleGeometry]:
    """Per-scale geometry derived from measured zone rects (the ``fr``
    tensor a real VL53L5CX capture ships in its h5 file).

    Faithfully mirrors ``patch_info_from_rect_data`` (reference
    src/utils/dataloader.py:13-40) followed by the per-batch reductions in
    ``TransformerFusion.forward`` (reference fusion.py:71-84): min/max rect
    bounds, max patch extent, trunc-toward-zero index division, int-truncated
    pad magnitudes. The reference hardcodes the 480/640 clip bounds
    (dataloader.py:21-23); here the actual image size is used — identical for
    ZJUL5's 480x640 captures.
    """
    fr = np.asarray(fr, np.float64)
    zn = int(round(math.sqrt(fr.shape[0])))
    max_ph = int(np.max(fr[:, 2] - fr[:, 0]))  # .to(torch.int32) truncates
    max_pw = int(np.max(fr[:, 3] - fr[:, 1]))
    _pad_h = int(max(np.max(np.abs(np.clip(fr[:, 0], None, 0.0))),
                     np.max(np.clip(fr[:, 2], img_h, None) - img_h)))
    _pad_w = int(max(np.max(np.abs(np.clip(fr[:, 1], None, 0.0))),
                     np.max(np.clip(fr[:, 3], img_w, None) - img_w)))
    out = {}
    for cps in patch_sizes:
        out[cps] = ScaleGeometry(
            conv_patch_size=cps,
            zone_num=zn,
            p1=math.ceil(max_ph / cps),
            p2=math.ceil(max_pw / cps),
            sy_wo=_trunc_div(float(np.min(fr[:, 0])), cps),
            sx_wo=_trunc_div(float(np.min(fr[:, 1])), cps),
            ey_wo=_trunc_div(float(np.max(fr[:, 2])), cps),
            ex_wo=_trunc_div(float(np.max(fr[:, 3])), cps),
            pad_h=math.ceil(_pad_h / cps),
            pad_w=math.ceil(_pad_w / cps),
            H=img_h // cps,
            W=img_w // cps,
        )
    return out


def zone_offset_for(seed: int, epoch: int, step: int, max_offset: int) -> int:
    """Deterministic per-batch zone offset in ``[-max_offset, max_offset]``
    (both ends inclusive, matching the reference's ``random.randint`` —
    src/utils/dataloader.py:97-99).

    The reference draws a fresh offset per SAMPLE inside its dynamic-shape
    torch loader; here zone geometry is static per batch, so the offset
    cycles per BATCH instead: a pure function of (seed, epoch, step) that
    the data loader and the train loop evaluate independently and agree on
    with no plumbing between them."""
    if max_offset <= 0:
        return 0
    r = np.random.default_rng(
        (int(seed) * 1000003 + int(epoch)) * 1000003 + int(step))
    return int(r.integers(-max_offset, max_offset + 1))


def geometry_for(config, mode: str, offset: Tuple[int, int] = (0, 0)) -> ZoneGeometry:
    """Build the ZoneGeometry for a Config + mode.

    Train: ``train_zone_num`` zones of 64x64 px on the train crop.
    Eval:  8x8 zones of 56x56 px on the native resolution.
    (reference src/utils/dataloader.py:93-102)

    ``zone_type`` ablations select the central sub-grid, shrinking the zone
    grid AND shifting its origin — the reference recomputes patch_info from
    the subset rects (nyu.py:180, zjuL5.py:135), reproduced here.
    """
    h, w = config.image_size_for(mode)
    zn = config.zone_num_for(mode)
    ph, pw = config.zone_patch_px_for(mode)
    geom = ZoneGeometry(
        img_h=h, img_w=w, zone_num=zn, patch_px_h=ph, patch_px_w=pw,
        offset_y=offset[0], offset_x=offset[1],
    )
    zone_type = getattr(config, "zone_type", f"{zn}x{zn}")
    sub = int(zone_type.split("x")[0])
    if sub < zn:
        lo = (zn - sub) // 2
        # subset origin = full-grid origin + lo zones; express as an offset
        # relative to the sub-grid's natural centering
        sub_sy = geom.sy_px + lo * ph
        sub_sx = geom.sx_px + lo * pw
        natural_sy = int((h - ph * sub) / 2)
        natural_sx = int((w - pw * sub) / 2)
        geom = ZoneGeometry(
            img_h=h, img_w=w, zone_num=sub, patch_px_h=ph, patch_px_w=pw,
            offset_y=sub_sy - natural_sy, offset_x=sub_sx - natural_sx,
        )
    return geom
