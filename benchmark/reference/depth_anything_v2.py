"""Depth Anything V2, metric, in plain PyTorch: the reference of the family
``depth_anything_v2`` (``families/depth_anything_v2.py``). It imports nothing
of the system under test.

Yang et al., NeurIPS 2024, arXiv 2406.09414; the code is
``metric_depth/depth_anything_v2/dpt.py`` and ``dinov2.py`` (with
``dinov2_layers/``) of github.com/DepthAnything/Depth-Anything-V2, the ``vitl``
entry of its ``model_configs`` on DINOv2's ``vit_large`` (arXiv 2304.07193):

- the frame [B, H, W, 3], normalized with the ImageNet mean and std, resized
  to DAv2's ``Resize(518, keep_aspect_ratio, ensure_multiple_of=14,
  lower_bound)`` size (480 x 640 -> 518 x 686);
- ``patch_embed``: a 14 x 14 stride-14 convolution, 3 -> 1024 channels; the
  cls token prepended; ``pos_embed`` added, its 37 x 37 grid resized to the
  patch grid as ``interpolate_pos_encoding`` does (bicubic by the scale
  factors (grid + 0.1) / 37, no antialias, in float32);
- 24 blocks: ``x = x + ls1 * attn(norm1(x))``, ``x = x + ls2 *
  mlp(norm2(x))``; attention ``proj(softmax(q @ k^T * 64^-0.5) @ v)`` over
  16 heads from ``qkv`` (with bias), the MLP ``fc2(gelu(fc1))`` (erf GELU,
  4096 wide), LayerNorm eps 1e-6;
- ``get_intermediate_layers([4, 11, 17, 23])``: those blocks' outputs through
  ``norm``, the cls token dropped;
- ``DPTHead`` (``features`` 256, ``out_channels`` [256, 512, 1024, 1024],
  no BatchNorm, no cls readout): ``projects``, ``resize_layers``,
  ``scratch.layer{1..4}_rn``, ``refinenet4..1`` (FeatureFusionBlocks of
  ResidualConvUnits, bilinear align-corners resizes), ``output_conv1``, a
  bilinear align-corners resize to 14 x the patch grid, ``output_conv2``
  ending in a sigmoid; times ``max_depth``; resized bilinear align-corners
  to the frame (``infer_image``).

Departures, each written where it is made:

- The resize of the input runs on the device, bilinear with half-pixel
  centres (``F.interpolate``, no antialias), where DAv2 resizes the uint8
  frame with cv2's cubic on the host before normalizing.
- The transposed convolutions of ``resize_layers`` (kernel = stride, so no
  two taps overlap) are written as the product they are (``einsum``), so
  that the fp8 control (``precision.py``) reaches them as it reaches every
  other product. The same sums.
- The system under test computes the ``pos_embed`` resize once, after its
  weights are loaded (the input size is fixed); this reference computes it
  at every forward, as DINOv2 does. The same numbers.

Attention is written as ``softmax(q @ k^T * scale) @ v``, two products and
a softmax, so that the fp8 control reaches its products too.

Beside the model: its work (``count``: the operations by part, products of
the encoder, attention and the head, and the attention calls with their
shapes) and the least time of an attention call on the card (``least_ms``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import peaks

PATCH = 14
WIDTHS = ("embed_dim", "depth", "num_heads", "mlp_ratio", "intermediate_layer_idx", "features",
          "out_channels", "input_size")  # the settings that size the model
# the CPU tests' widths: every kind of layer, each block tapped
TINY = dict(embed_dim=64, depth=4, num_heads=4, mlp_ratio=4, intermediate_layer_idx=[0, 1, 2, 3],
            features=32, out_channels=[16, 32, 64, 64], input_size=56)


def widths(settings: Dict) -> Dict:
    """The widths a configuration's settings give (``WIDTHS``)."""
    return {k: settings[k] for k in WIDTHS}


def _empty(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape))


class _Affine(nn.Module):
    """A module with ``weight`` (and ``bias``) of the given shapes."""

    def __init__(self, weight, bias=None):
        super().__init__()
        self.weight = _empty(*weight)
        if bias is not None:
            self.bias = _empty(*bias)


def linear(i, o):
    return _Affine((o, i), (o,))


def conv(i, o, k, bias=True):
    return _Affine((o, i, k, k), (o,) if bias else None)


def deconv(c, k):
    return _Affine((c, c, k, k), (c,))


def norm(c):
    return _Affine((c,), (c,))


class _Block(nn.Module):
    def __init__(self, dim, mlp):
        super().__init__()
        self.norm1, self.norm2 = norm(dim), norm(dim)
        self.attn = nn.Module()
        self.attn.qkv, self.attn.proj = linear(dim, 3 * dim), linear(dim, dim)
        self.ls1, self.ls2 = nn.Module(), nn.Module()
        self.ls1.gamma, self.ls2.gamma = _empty(dim), _empty(dim)
        self.mlp = nn.Module()
        self.mlp.fc1, self.mlp.fc2 = linear(dim, mlp), linear(mlp, dim)


def _rcu(f):
    m = nn.Module()
    m.conv1, m.conv2 = conv(f, f, 3), conv(f, f, 3)
    return m


def _fusion(f):
    m = nn.Module()
    m.out_conv = conv(f, f, 1)
    m.resConfUnit1, m.resConfUnit2 = _rcu(f), _rcu(f)
    return m


def lower_bound_size(height: int, width: int, size: int) -> Tuple[int, int]:
    """DAv2's ``Resize.get_size`` (``keep_aspect_ratio``, ``lower_bound``,
    ``ensure_multiple_of`` 14) for a frame of ``height`` x ``width``."""
    scale = max(size / height, size / width)
    out = []
    for x in (scale * height, scale * width):
        y = int(round(x / PATCH) * PATCH)  # np.round: half to even, as round
        if y < size:
            y = int(math.ceil(x / PATCH) * PATCH)
        out.append(y)
    return out[0], out[1]


class DepthAnythingV2(nn.Module):
    def __init__(self, settings: Dict, widths: Dict):
        super().__init__()
        w = widths
        C, g = w["embed_dim"], w["input_size"] // PATCH
        self.heads, self.taps = w["num_heads"], w["intermediate_layer_idx"]
        self.max_depth = settings["max_depth"]
        self.native = (settings["native_height"], settings["native_width"])
        self.size = lower_bound_size(*self.native, w["input_size"])
        p = self.pretrained = nn.Module()
        p.cls_token, p.pos_embed, p.mask_token = (_empty(1, 1, C), _empty(1, 1 + g * g, C),
                                                  _empty(1, C))
        p.patch_embed = nn.Module()
        p.patch_embed.proj = conv(3, C, PATCH)
        p.blocks = nn.ModuleList(_Block(C, w["mlp_ratio"] * C) for _ in range(w["depth"]))
        p.norm = norm(C)
        oc, f = w["out_channels"], w["features"]
        h = self.depth_head = nn.Module()
        h.projects = nn.ModuleList(conv(C, o, 1) for o in oc)
        h.resize_layers = nn.ModuleList([deconv(oc[0], 4), deconv(oc[1], 2), nn.Identity(),
                                         conv(oc[3], oc[3], 3)])
        s = h.scratch = nn.Module()
        for i, o in enumerate(oc, 1):
            setattr(s, f"layer{i}_rn", conv(o, f, 3, bias=False))
        for i in range(1, 5):
            setattr(s, f"refinenet{i}", _fusion(f))
        s.output_conv1 = conv(f, f // 2, 3)
        s.output_conv2 = nn.ModuleList([conv(f // 2, 32, 3), nn.Identity(), conv(32, 1, 1)])

    # the encoder

    def pos_grid(self, gh: int, gw: int) -> torch.Tensor:
        """``interpolate_pos_encoding`` of DINOv2 for a gh x gw patch grid."""
        pos = self.pretrained.pos_embed
        dtype, pos = pos.dtype, pos.float()
        n = pos.shape[1] - 1
        g = int(math.sqrt(n))
        grid = pos[:, 1:].reshape(1, g, g, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, scale_factor=((gh + 0.1) / math.sqrt(n),
                                                 (gw + 0.1) / math.sqrt(n)),
                             mode="bicubic", antialias=False)
        if grid.shape[-2:] != (gh, gw):
            raise ValueError(f"pos_embed resized to {tuple(grid.shape[-2:])}, not {(gh, gw)}")
        grid = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
        return torch.cat((pos[:, :1], grid), dim=1).to(dtype)

    def attention(self, q, k, v, scale):
        return torch.softmax(q @ k.transpose(-2, -1) * scale, dim=-1) @ v

    def block(self, b: _Block, x):
        B, N, C = x.shape
        H = self.heads
        y = F.layer_norm(x, (C,), b.norm1.weight, b.norm1.bias, 1e-6)
        qkv = F.linear(y, b.attn.qkv.weight, b.attn.qkv.bias)
        qkv = qkv.reshape(B, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        y = self.attention(qkv[0], qkv[1], qkv[2], (C // H) ** -0.5)
        y = F.linear(y.transpose(1, 2).reshape(B, N, C), b.attn.proj.weight, b.attn.proj.bias)
        x = x + y * b.ls1.gamma
        y = F.layer_norm(x, (C,), b.norm2.weight, b.norm2.bias, 1e-6)
        y = F.linear(F.gelu(F.linear(y, b.mlp.fc1.weight, b.mlp.fc1.bias)), b.mlp.fc2.weight,
                     b.mlp.fc2.bias)
        return x + y * b.ls2.gamma

    def encode(self, image):
        """The taps [B, gh*gw, C] of a frame ``image`` [B, H, W, 3]."""
        p = self.pretrained
        x = F.interpolate(image.permute(0, 3, 1, 2), size=self.size, mode="bilinear",
                          align_corners=False)
        gh, gw = x.shape[-2] // PATCH, x.shape[-1] // PATCH
        x = F.conv2d(x, p.patch_embed.proj.weight, p.patch_embed.proj.bias, stride=PATCH)
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat((p.cls_token.expand(x.shape[0], -1, -1), x), dim=1)
        x = x + self.pos_grid(gh, gw)
        taps = []
        for i, b in enumerate(p.blocks):
            x = self.block(b, x)
            if i in self.taps:
                taps.append(x)
        C = x.shape[-1]
        return [F.layer_norm(t, (C,), p.norm.weight, p.norm.bias, 1e-6)[:, 1:] for t in taps]

    # the head

    def rcu(self, m, x):
        y = F.conv2d(F.relu(x), m.conv1.weight, m.conv1.bias, padding=1)
        return F.conv2d(F.relu(y), m.conv2.weight, m.conv2.bias, padding=1) + x

    def fusion(self, m, x, skip=None, size=None):
        if skip is not None:
            x = x + self.rcu(m.resConfUnit1, skip)
        x = self.rcu(m.resConfUnit2, x)
        if size is None:  # scale_factor 2
            size = (2 * x.shape[-2], 2 * x.shape[-1])
        x = F.interpolate(x, size=size, mode="bilinear", align_corners=True)
        return F.conv2d(x, m.out_conv.weight, m.out_conv.bias)

    def decode(self, taps, gh: int, gw: int):
        """The metric depth map [B, 1, H, W] of the taps."""
        h, s = self.depth_head, self.depth_head.scratch
        layers = []
        for i, t in enumerate(taps):
            x = t.permute(0, 2, 1).reshape(t.shape[0], t.shape[-1], gh, gw)
            x = F.conv2d(x, h.projects[i].weight, h.projects[i].bias)
            r = h.resize_layers[i]
            if i in (0, 1):  # ConvTranspose2d with kernel = stride: one tap an output pixel
                k = r.weight.shape[-1]
                x = torch.einsum("bihw,iokl->bohkwl", x, r.weight)
                x = x.reshape(x.shape[0], x.shape[1], gh * k, gw * k) + r.bias[:, None, None]
            elif i == 3:
                x = F.conv2d(x, r.weight, r.bias, stride=2, padding=1)
            layers.append(F.conv2d(x, getattr(s, f"layer{i + 1}_rn").weight, padding=1))
        l1, l2, l3, l4 = layers
        path = self.fusion(s.refinenet4, l4, size=l3.shape[-2:])
        path = self.fusion(s.refinenet3, path, l3, size=l2.shape[-2:])
        path = self.fusion(s.refinenet2, path, l2, size=l1.shape[-2:])
        path = self.fusion(s.refinenet1, path, l1)
        out = F.conv2d(path, s.output_conv1.weight, s.output_conv1.bias, padding=1)
        out = F.interpolate(out, size=(gh * PATCH, gw * PATCH), mode="bilinear",
                            align_corners=True)
        c1, _, c2 = s.output_conv2
        out = F.relu(F.conv2d(out, c1.weight, c1.bias, padding=1))
        depth = torch.sigmoid(F.conv2d(out, c2.weight, c2.bias)) * self.max_depth
        return F.interpolate(depth, size=self.native, mode="bilinear", align_corners=True)

    def forward(self, image):
        """``image`` [B, H, W, 3] -> metric depth [B, H, W, 1]."""
        gh, gw = self.size[0] // PATCH, self.size[1] // PATCH
        return self.decode(self.encode(image), gh, gw).permute(0, 2, 3, 1)


def build(settings: Dict, device, sizes: Optional[Dict] = None) -> DepthAnythingV2:
    """The reference in float32 on ``device``, parameters uninitialized (load
    a state dict), at the settings' widths or at ``sizes``."""
    with torch.device(device):
        return DepthAnythingV2(settings, sizes or widths(settings)).eval()


# Work of a forward.

def attention_flops(shape: Tuple[int, ...]) -> int:
    """Operations of one attention call [B, H, N, D]: q k^T and p v, two
    operations a multiply-add."""
    B, H, N, D = shape
    return 4 * B * H * N * N * D


def count(settings: Dict, batch: int = 1, sizes: Optional[Dict] = None):
    """``(parts, calls)`` of one forward of ``batch`` frames: the operations
    by part, ``products`` (the encoder's patch embedding, projections and
    MLPs), ``attention`` (its two products a call) and ``head`` (the DPT
    head's convolutions), as ``torch.utils.flop_counter`` counts them on the
    ``meta`` device; ``calls`` one ``("softmax_attention", (B, H, N, D))`` a
    block."""
    from torch.utils.flop_counter import FlopCounterMode

    model = build(settings, "meta", sizes)
    calls: List[Tuple[str, Tuple[int, ...]]] = []
    attention = model.attention

    def record(q, k, v, scale):
        calls.append(("softmax_attention", tuple(q.shape)))
        return attention(q, k, v, scale)

    model.attention = record
    image = torch.zeros(batch, *model.native, 3, device="meta")
    with torch.no_grad():
        with FlopCounterMode(display=False) as counter:
            taps = model.encode(image)
        encoder = counter.get_total_flops()
        with FlopCounterMode(display=False) as counter:
            model.decode(taps, model.size[0] // PATCH, model.size[1] // PATCH)
        head = counter.get_total_flops()
    att = sum(attention_flops(shape) for _, shape in calls)
    return dict(products=encoder - att, attention=att, head=head), calls


def least_ms(shape: Tuple[int, ...], itemsize: int = 2) -> float:
    """The least time of one attention call [B, H, N, D] on the card, in ms:
    the larger of its bytes (q, k, v read once, the output written once)
    over the memory rate and its operations over the bf16 peak."""
    B, H, N, D = shape
    nbytes = 4 * B * H * N * D * itemsize
    return 1e3 * max(nbytes / peaks.BYTES, attention_flops(shape) / peaks.BF16)
