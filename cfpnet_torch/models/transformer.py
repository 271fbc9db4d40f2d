"""Attention blocks: LoFTR encoder layer, Twins (LSA+GSA), cross-zone
propagation.

Port of ``cfpnet_tpu/models/transformer.py`` (``LoFTREncoderLayer``,
``LocallyGroupedAttn``, ``GlobalSubSampleAttn``, ``TwinsTransformer``,
``LoFTRNewCross9``, ``Combine1``, ``twins_window_size``). Tokens are
[B, H·W, C] as in the JAX package.

- An unmasked ``LoFTREncoderLayer`` (hist2image, and the LSA and GSA halves
  of ``TwinsTransformer``) goes through ``ops.dispatch.loftr_layer``: on the
  card the whole layer is one call of the fused LoFTR kernel, on the CPU its
  plain version ``ops/loftr.py::loftr_apply``. A masked one runs through its
  modules on any device, its attention by the plain twin. The JAX model never reaches its own fused kernel
  (``cfpnet_tpu/ops/pallas_loftr.py:26-28`` says its eval path does;
  ``tests/test_pallas_loftr.py:7-8`` and ``cfpnet_tpu/ops/dispatch.py`` say
  nothing does, which is what its code does).
- ``LoFTRNewCross9``'s attention goes through ``ops.dispatch.attention``: the
  attention kernel on the card.
- ``LoFTRNewCross9`` keeps the dense static-rectangle form: attention runs
  for every token against the inside-zone keys, and the message is zeroed
  on the inside rectangle afterwards. Linear attention is per-query, so this
  equals the reference's gather-attend-scatter.
- ``LocallyGroupedAttn`` partitions windows by a static pad + reshape.
- ``GlobalSubSampleAttn`` subsamples with a VALID k=ws, s=ws conv, then LN.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dispatch import attention, loftr_layer
from ..ops.loftr import LoFTRParams
from .convnext import Block14
from .layers import BatchNorm


def _nhwc_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW conv to an NHWC map."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class LoFTREncoderLayer(nn.Module):
    """Pre-proj q/k/v -> linear attention -> merge -> LN -> MLP(concat) -> LN
    -> residual (reference transformer.py:14-71)."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.mlp = nn.Sequential(
            nn.Linear(2 * d_model, 2 * d_model, bias=False),
            nn.ReLU(),
            nn.Linear(2 * d_model, d_model, bias=False),
        )
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, source, x_mask=None, source_mask=None):
        # x: [N, L, C]; source: [N, S, C]
        return loftr_layer(x, source, self, x_mask, source_mask)

    def loftr_params(self) -> LoFTRParams:
        """The layer's weights for ``ops/loftr.py``, without a copy: each
        matrix is its ``nn.Linear`` weight's ``.t()``, [in, out] as in flax."""
        return LoFTRParams(
            wq=self.q_proj.weight.t(), wk=self.k_proj.weight.t(), wv=self.v_proj.weight.t(),
            wm=self.merge.weight.t(), g1=self.norm1.weight, b1=self.norm1.bias,
            w0=self.mlp[0].weight.t(), w1=self.mlp[2].weight.t(),
            g2=self.norm2.weight, b2=self.norm2.bias)

    def modules_forward(self, x, source, x_mask=None, source_mask=None):
        """The layer through its modules, one op at a time (cuBLAS linears,
        ``dispatch.attention``, torch LayerNorm): the masked path on every
        device, and on the card the unfused yardstick of the fused kernel."""
        bs = x.shape[0]
        dim = self.d_model // self.nhead
        q = self.q_proj(x).reshape(bs, -1, self.nhead, dim)
        k = self.k_proj(source).reshape(bs, -1, self.nhead, dim)
        v = self.v_proj(source).reshape(bs, -1, self.nhead, dim)
        # the reference passes an all-ones q_mask when x_mask is set (:57-61)
        tmp_mask = torch.ones_like(x_mask) if x_mask is not None else None
        message = attention(q, k, v, q_mask=tmp_mask, kv_mask=source_mask)
        if x_mask is not None:
            message = message * x_mask[:, :, None, None].to(message.dtype)
        message = self.norm1(self.merge(message.reshape(bs, -1, self.d_model)))
        message = self.norm2(self.mlp(torch.cat([x, message], dim=2)))
        return message + x


class LocallyGroupedAttn(nn.Module):
    """LSA: self-attention within ws x ws windows (reference :75-116)."""

    def __init__(self, dim: int, ws: int, num_heads: int = 8):
        super().__init__()
        self.ws = ws
        self.encoder_layer = LoFTREncoderLayer(dim, num_heads)

    def forward(self, x, size: Tuple[int, int]):
        B, N, C = x.shape
        H, W = size
        ws = self.ws
        x = x.reshape(B, H, W, C)
        pad_r = (ws - W % ws) % ws
        pad_b = (ws - H % ws) % ws
        if pad_r or pad_b:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        _h, _w = Hp // ws, Wp // ws
        x = x.reshape(B, _h, ws, _w, ws, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B * _h * _w, ws * ws, C)
        x = self.encoder_layer(x, x)
        x = x.reshape(B, _h, _w, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, Hp, Wp, C)
        if pad_r or pad_b:
            # contiguous: where only rows were padded, the crop reshapes to a
            # view whose rows lie Hp*Wp apart, which the fused LoFTR kernel
            # of the GSA half that reads it refuses
            x = x[:, :H, :W, :].contiguous()
        return x.reshape(B, H * W, C)


class GlobalSubSampleAttn(nn.Module):
    """GSA: all tokens query a ws-strided conv-downsampled key map
    (reference :119-150)."""

    def __init__(self, dim: int, sr_ratio: int, num_heads: int = 8):
        super().__init__()
        self.sr_ratio = sr_ratio
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio, bias=True)
            self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.encoder_layer = LoFTREncoderLayer(dim, num_heads)

    def forward(self, x, size: Tuple[int, int]):
        B, N, C = x.shape
        H, W = size
        query = x
        if self.sr_ratio > 1:
            x = _nhwc_conv(self.sr, x.reshape(B, H, W, C))
            x = self.norm(x.reshape(B, -1, C))
        return self.encoder_layer(query, x)


class TwinsTransformer(nn.Module):
    """LSA then GSA (reference :154-165). The reference does not pass
    num_heads down: both sub-attentions use the default 8 heads."""

    def __init__(self, dim: int, ws: int):
        super().__init__()
        self.lga = LocallyGroupedAttn(dim, ws)
        self.gsa = GlobalSubSampleAttn(dim, ws)

    def forward(self, x, size: Tuple[int, int]):
        return self.gsa(self.lga(x, size), size)


class LoFTRNewCross9(nn.Module):
    """Cross-zone propagation: outside-zone queries attend to inside-zone
    keys/values; messages land on outside tokens; 2x conv3x3+BN refine;
    residual (reference transformer.py:204-248).

    ``rect`` = (zy0, zy1, zx0, zx1), the clipped zone-region bounds on the
    H x W feature map."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.conv1 = nn.Conv2d(2 * d_model, d_model, 3, padding=1, bias=False)
        self.bn1 = BatchNorm(d_model, 1e-5)
        self.conv2 = nn.Conv2d(d_model, d_model, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(d_model, 1e-5)

    def forward(self, feat0, rect: Tuple[int, int, int, int], H: int, W: int):
        B, N, C = feat0.shape
        zy0, zy1, zx0, zx1 = rect
        dim = self.d_model // self.nhead
        x2d = feat0.reshape(B, H, W, C)
        inside = x2d[:, zy0:zy1, zx0:zx1, :].reshape(B, -1, C)

        # q over ALL tokens (outside results used; inside zeroed below)
        q = self.q_proj(feat0).reshape(B, N, self.nhead, dim)
        k = self.k_proj(inside).reshape(B, -1, self.nhead, dim)
        v = self.v_proj(inside).reshape(B, -1, self.nhead, dim)
        msg2d = attention(q, k, v).reshape(B, H, W, C)
        msg2d[:, zy0:zy1, zx0:zx1, :] = 0  # tmp[~zone_area] = message

        y = torch.cat([x2d, msg2d], dim=-1).permute(0, 3, 1, 2)
        y = self.bn2(self.conv2(self.bn1(self.conv1(y))))
        return y.permute(0, 2, 3, 1).reshape(B, N, C) + feat0


class Combine1(nn.Module):
    """Cross-zone propagation + large-kernel conv path (reference :251-275)."""

    def __init__(self, d_model: int, nhead: int, large_kernel: int):
        super().__init__()
        self.transformer_path = LoFTRNewCross9(d_model, nhead)
        self.large_kernel_path = Block14(d_model, large_kernel)

    def forward(self, feat0, rect, H: int, W: int):
        B, N, C = feat0.shape
        feat0 = self.transformer_path(feat0, rect, H, W)
        return self.large_kernel_path(feat0.reshape(B, H, W, C)).reshape(B, N, C)


def twins_window_size(max_h: int, max_w: int) -> int:
    """ws = ceil((H*W)^(1/4)) (reference fusion.py:28)."""
    return math.ceil(math.sqrt(math.sqrt(max_h * max_w)))
