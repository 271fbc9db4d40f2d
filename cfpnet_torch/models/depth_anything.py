"""Depth Anything V2, metric (Yang et al., NeurIPS 2024, arXiv 2406.09414), on
the port's frame path: a DINOv2 ViT/14 encoder (arXiv 2304.07193) and the DPT
head, as ``metric_depth/depth_anything_v2/dpt.py`` and ``dinov2.py`` of
github.com/DepthAnything/Depth-Anything-V2 build them. The JAX package has no
counterpart; the benchmark's plain reference is
``benchmark/reference/depth_anything_v2.py``.

The parameter names are the published module tree's (``pretrained.*`` the
encoder, ``depth_head.*`` the head, ``mask_token`` and the head's unused
``refinenet4.resConfUnit1`` included), so that the published checkpoint loads
with one ``load_state_dict``. ``make_model`` (``models/deltar.py``) builds
this model for ``--model_name depth_anything_v2``, in eval mode.

The forward, ``model(rgb) -> (pred,)``: ``rgb`` [B, H, W, 3] of the native
frame, normalized with the ImageNet mean and std (DAv2's ``NormalizeImage``);
``pred`` [B, H, W, 1], metric depth in metres, the layout of ``Deltar``'s
``pred``. It reads no ToF input. Its equations, with C the width, h x w the
patch grid:

- Input: ``rgb`` resized to (ih, iw), DAv2's ``Resize(518,
  keep_aspect_ratio, ensure_multiple_of=14, lower_bound)`` of the native
  frame (480 x 640 -> 518 x 686, ``resized_size``). Bilinear with half-pixel
  centres on the device, where DAv2 resizes with cv2's cubic on the host:
  the one departure from the published pipeline.
- Tokens: a 14 x 14 stride-14 convolution from 3 to C channels (h x w =
  37 x 49 = 1,813 patches), the cls token prepended, ``pos_embed`` added:
  its square grid resized to h x w by bicubic interpolation with DINOv2's
  ``interpolate_offset`` 0.1 and no antialias (``interpolate_pos_embed``).
  The input size is fixed, so that is computed once, when the model is
  built and after each ``load_state_dict`` (``pos_embed_grid``), and not at
  every forward as DINOv2 does: the same numbers.
- Each block: ``x += ls1 * proj(softmax(q k^T / sqrt(64)) v)`` with q, k, v
  from ``qkv(LN1(x))`` (heads of 64, the attention through
  ``ops/dispatch.py::softmax_attention``), then ``x += ls2 *
  fc2(GELU(fc1(LN2(x))))``, GELU the erf form, LayerNorm eps 1e-6.
- Taps: the outputs of blocks ``taps`` through the final ``norm``, the cls
  token dropped (``use_clstoken`` false), laid out as C x h x w.
- Head: 1 x 1 ``projects`` to ``out_channels``; ``resize_layers``
  ConvTranspose k4 s4, ConvTranspose k2 s2, identity, Conv k3 s2 p1 (maps
  of 4h x 4w, 2h x 2w, h x w, ceil(h/2) x ceil(w/2)); 3 x 3
  ``layer{1..4}_rn`` to ``features`` without bias; ``refinenet4..1``
  FeatureFusionBlocks (``x + RCU1(skip)``, ``RCU2``, a bilinear
  align-corners resize to the next map's size or x2, a 1 x 1 ``out_conv``;
  RCU(x) = ``conv2(relu(conv1(relu(x)))) + x``); ``output_conv1`` 3 x 3 to
  features / 2, a bilinear align-corners resize to (ih, iw); ``output_conv2``
  3 x 3 to 32, ReLU, 1 x 1 to 1, sigmoid; times ``max_depth``; a bilinear
  align-corners resize to the native frame (DAv2's ``infer_image``).

Tracing (``tracing.py``): spans ``dav2.encoder`` (the resize, tokens, blocks
and taps) and ``dav2.head``, recorded in an eager forward while tracing is
live; a CUDA graph's replay (``graphs.py``) runs no Python and records
neither, its capture records them once. Each block's attention counts one
``kernel.softmax_attention.launches.<dtype>`` on the card, graph replays
included.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import tracing
from ..ops import dispatch

PATCH = 14
# ``vitl`` of DAv2's ``model_configs`` on DINOv2's ``vit_large``
VITL = dict(embed_dim=1024, depth=24, num_heads=16, mlp_ratio=4, taps=(4, 11, 17, 23),
            features=256, out_channels=(256, 512, 1024, 1024), input_size=518)
# the CPU tests' widths: every kind of layer, each block tapped
TINY = dict(embed_dim=64, depth=4, num_heads=4, mlp_ratio=4, taps=(0, 1, 2, 3), features=32,
            out_channels=(16, 32, 64, 64), input_size=56)
LN_EPS = 1e-6
INTERPOLATE_OFFSET = 0.1


def resized_size(height: int, width: int, size: int) -> Tuple[int, int]:
    """The size DAv2's ``Resize(size, size, keep_aspect_ratio=True,
    ensure_multiple_of=14, resize_method="lower_bound")`` gives a frame of
    ``height`` x ``width``: both sides scaled by the larger ratio, each
    rounded to a multiple of 14 (half to even, as ``np.round``) and raised
    to the next one where that falls under ``size``."""
    scale = max(size / height, size / width)

    def fit(x: float) -> int:
        y = round(x / PATCH) * PATCH
        return y if y >= size else math.ceil(x / PATCH) * PATCH

    return fit(scale * height), fit(scale * width)


def interpolate_pos_embed(pos_embed: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
    """DINOv2's ``interpolate_pos_encoding`` for a patch grid ``grid``:
    the square grid of ``pos_embed`` [1, 1 + g*g, C] resized bicubically,
    by the scale factors (grid + 0.1) / g, without antialias, in float32;
    the cls position kept. Returns [1, 1 + h*w, C] in ``pos_embed``'s dtype."""
    pos = pos_embed.float()
    g = math.isqrt(pos.shape[1] - 1)
    dim = pos.shape[-1]
    h, w = grid
    patch = F.interpolate(pos[:, 1:].reshape(1, g, g, dim).permute(0, 3, 1, 2),
                          scale_factor=((h + INTERPOLATE_OFFSET) / g,
                                        (w + INTERPOLATE_OFFSET) / g),
                          mode="bicubic", antialias=False)
    if patch.shape[-2:] != (h, w):
        raise ValueError(f"pos_embed of a {g}x{g} grid resized to {tuple(patch.shape[-2:])}, "
                         f"not {grid}")
    patch = patch.permute(0, 2, 3, 1).reshape(1, h * w, dim)
    return torch.cat((pos[:, :1], patch), dim=1).to(pos_embed.dtype)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH, PATCH)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        H = self.num_heads
        q, k, v = self.qkv(x).view(B, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        out = dispatch.softmax_attention(q, k, v, (C // H) ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, mlp_ratio * dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DinoVisionTransformer(nn.Module):
    """DINOv2's ViT/14 (no register tokens) for a fixed patch grid ``grid``,
    whose ``pos_embed`` is laid out for the square grid of ``input_size``."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int, mlp_ratio: int,
                 input_size: int, grid: Tuple[int, int]):
        super().__init__()
        self.grid = grid
        g = input_size // PATCH
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + g * g, embed_dim))
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))  # unused at inference
        self.patch_embed = PatchEmbed(embed_dim)
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.register_buffer("pos_embed_grid",
                             torch.zeros(1, 1 + grid[0] * grid[1], embed_dim), persistent=False)
        self.refresh_pos_embed()
        self.register_load_state_dict_post_hook(lambda module, _: module.refresh_pos_embed())

    @torch.no_grad()
    def refresh_pos_embed(self) -> None:
        """``pos_embed_grid`` from ``pos_embed``, in place (a captured graph
        keeps reading the same memory)."""
        self.pos_embed_grid.copy_(interpolate_pos_embed(self.pos_embed, self.grid))

    def taps(self, x: torch.Tensor, taps: Sequence[int]):
        """The normed patch tokens [B, h*w, C] after each block of ``taps``,
        of images ``x`` [B, 3, 14h, 14w]."""
        x = self.patch_embed(x)
        x = torch.cat((self.cls_token.expand(x.shape[0], -1, -1), x), dim=1) + self.pos_embed_grid
        out = []
        for i, block in enumerate(self.blocks[:max(taps) + 1]):
            x = block(x)
            if i in taps:
                out.append(self.norm(x)[:, 1:])
        return out


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.out_conv = nn.Conv2d(features, features, 1)
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)

    def forward(self, x, skip=None, size=None):
        """``out_conv(resize(RCU2(x + RCU1(skip))))``, resized to ``size``
        or by 2, bilinear with aligned corners."""
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        size = size or (2 * x.shape[-2], 2 * x.shape[-1])
        return self.out_conv(F.interpolate(x, size=size, mode="bilinear", align_corners=True))


class DPTHead(nn.Module):
    def __init__(self, in_channels: int, features: int, out_channels: Sequence[int]):
        super().__init__()
        c = out_channels
        self.projects = nn.ModuleList(nn.Conv2d(in_channels, o, 1) for o in c)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(c[0], c[0], 4, 4), nn.ConvTranspose2d(c[1], c[1], 2, 2),
            nn.Identity(), nn.Conv2d(c[3], c[3], 3, 2, 1)])
        s = self.scratch = nn.Module()
        for i, o in enumerate(c, 1):
            setattr(s, f"layer{i}_rn", nn.Conv2d(o, features, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(s, f"refinenet{i}", FeatureFusionBlock(features))
        s.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        s.output_conv2 = nn.Sequential(nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(),
                                       nn.Conv2d(32, 1, 1), nn.Sigmoid())

    def forward(self, taps, grid: Tuple[int, int], out_size: Tuple[int, int]):
        """The head's sigmoid map [B, 1, *out_size] of the taps [B, h*w, C]."""
        s = self.scratch
        layers = []
        for i, x in enumerate(taps):
            x = x.transpose(1, 2).reshape(x.shape[0], x.shape[-1], *grid)
            x = self.resize_layers[i](self.projects[i](x))
            layers.append(getattr(s, f"layer{i + 1}_rn")(x))
        l1, l2, l3, l4 = layers
        path = s.refinenet4(l4, size=l3.shape[-2:])
        path = s.refinenet3(path, l3, size=l2.shape[-2:])
        path = s.refinenet2(path, l2, size=l1.shape[-2:])
        path = s.refinenet1(path, l1)
        out = F.interpolate(s.output_conv1(path), size=out_size, mode="bilinear",
                            align_corners=True)
        return s.output_conv2(out)


class DepthAnythingV2(nn.Module):
    """The metric model for frames of ``native`` size; widths as ``VITL``."""

    def __init__(self, native: Tuple[int, int], max_depth: float, embed_dim: int, depth: int,
                 num_heads: int, mlp_ratio: int, taps: Sequence[int], features: int,
                 out_channels: Sequence[int], input_size: int):
        super().__init__()
        self.native, self.max_depth, self.taps = tuple(native), max_depth, tuple(taps)
        self.input_hw = resized_size(*native, input_size)
        self.grid = (self.input_hw[0] // PATCH, self.input_hw[1] // PATCH)
        self.pretrained = DinoVisionTransformer(embed_dim, depth, num_heads, mlp_ratio,
                                                input_size, self.grid)
        self.depth_head = DPTHead(embed_dim, features, out_channels)

    def forward(self, rgb):
        with tracing.span("dav2.encoder"):
            x = F.interpolate(rgb.permute(0, 3, 1, 2), size=self.input_hw, mode="bilinear",
                              align_corners=False)
            taps = self.pretrained.taps(x, self.taps)
        with tracing.span("dav2.head"):
            depth = self.depth_head(taps, self.grid, self.input_hw) * self.max_depth
            depth = F.interpolate(depth, size=self.native, mode="bilinear", align_corners=True)
        return (depth.permute(0, 2, 3, 1),)


def build(config, tiny: bool = False, device="cuda") -> DepthAnythingV2:
    """The model for ``config``'s native frame and ``max_depth``, at the
    published widths (``TINY`` with ``tiny``), in eval mode on ``device``.
    Weights are torch's default init; load real ones with
    ``load_state_dict``."""
    with torch.device(device):
        model = DepthAnythingV2((config.native_height, config.native_width), config.max_depth,
                                **(TINY if tiny else VITL))
    return model.eval()
