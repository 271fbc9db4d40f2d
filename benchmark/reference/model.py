"""CFPNet (and the DELTAR baseline) in plain PyTorch: the benchmark's reference.

A frozen, plain copy of the model that CFPNet publishes (arXiv 2411.04480,
github.com/denyingmxd/CFPNet ``src/models/``): an EfficientNetV2-B3
encoder (``tf_efficientnetv2_b3`` widths, TF "SAME" padding), a PointNet
histogram encoder, a UNet decoder with a ``TransformerFusion`` at 1/16, 1/8
and 1/4 of the frame, and an AdaBins depth head. Every operation is a plain
torch one (``F.conv2d``, ``F.linear``, ``einsum``, ``F.layer_norm``); the
large-kernel depthwise convs are ``F.conv2d(groups=C)``. Run it in float32
with TF32 off.

Departures from the published code, each one the system under test makes
too: in a lower precision the depth tail (softmax, bin edges and centres,
expected depth) runs in float32; BatchNorm keeps flax's conventions (the running statistics move as
``0.9 * old + 0.1 * batch`` with the biased batch variance); ``combine1``'s
cross-zone attention runs densely for every token against the inside-zone
keys and zeroes the inside afterwards, which equals the published
gather-attend-scatter because linear attention is per query; the
positional-encoding crop of training draws its two offsets a fusion scale
from a CPU ``torch.Generator`` seeded once a step, in the order 1/16, 1/8,
1/4; bilinear align-corners resizes are products with interpolation
matrices.

Parameter and buffer names are those of the published torch graph, so one
state dict loads into this model and into the system under test.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import geometry

# tf_efficientnetv2_b3 stages: (block, repeats, out channels, stride, expansion, se ratio)
B3 = dict(stem=40, stages=(("cn", 2, 16, 1, 1.0, 0.0), ("er", 3, 40, 2, 4.0, 0.0),
                           ("er", 3, 56, 2, 4.0, 0.0), ("ir", 5, 112, 2, 4.0, 0.25),
                           ("ir", 7, 136, 1, 6.0, 0.25), ("ir", 12, 232, 2, 6.0, 0.25)),
          encoder_channels=(232, 136, 56, 40, 16), decoder_channels=(256, 256, 128, 64, 32),
          num_classes=128)
# a model of the same topology at test size (CPU tests only)
TINY = dict(stem=8, stages=(("cn", 1, 8, 1, 1.0, 0.0), ("er", 1, 8, 2, 2.0, 0.0),
                            ("er", 1, 8, 2, 2.0, 0.0), ("ir", 1, 16, 2, 2.0, 0.25),
                            ("ir", 1, 16, 1, 2.0, 0.25), ("ir", 1, 16, 2, 2.0, 0.25)),
            encoder_channels=(16, 16, 8, 8, 8), decoder_channels=(64, 64, 32, 16, 8),
            num_classes=32)
BN_MOMENTUM = 0.9  # the weight of the old running value


class BatchNorm(nn.Module):
    """BatchNorm along ``channel_dim``: batch statistics (biased variance) in
    training, which also move the running ones; running ones in eval."""

    def __init__(self, n: int, eps: float, channel_dim: int = 1):
        super().__init__()
        self.eps, self.channel_dim, self.momentum = eps, channel_dim, BN_MOMENTUM
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        shape = [1] * x.dim()
        shape[self.channel_dim] = -1
        if self.training:
            axes = [d for d in range(x.dim()) if d != self.channel_dim % x.dim()]
            mean = x.mean(axes)
            var = ((x - mean.view(shape)) ** 2).mean(axes)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        scale = self.weight / torch.sqrt(var + self.eps)
        return (x - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)


def resize(x, out_h: int, out_w: int):
    """Bilinear align-corners resize of the (-3, -2) axes of an NHWC map."""
    h, w = x.shape[-3], x.shape[-2]
    if h != out_h:
        x = torch.einsum("oh,...hwc->...owc", interp_matrix(h, out_h, x), x)
    if w != out_w:
        x = torch.einsum("pw,...hwc->...hpc", interp_matrix(w, out_w, x), x)
    return x


def interp_matrix(n_in: int, n_out: int, like):
    """(n_out, n_in) align-corners linear interpolation weights, in the dtype
    and on the device of ``like``."""
    m = interp_weights(n_in, n_out)
    if like.device.type == "meta":
        return torch.empty(m.shape, dtype=like.dtype, device="meta")
    return torch.tensor(m, dtype=like.dtype, device=like.device)


@functools.lru_cache(maxsize=None)
def interp_weights(n_in: int, n_out: int) -> np.ndarray:
    m = np.zeros((n_out, n_in))
    if n_in == 1 or n_out == 1:
        m[:, 0] = 1.0
    else:
        c = np.arange(n_out) * ((n_in - 1) / (n_out - 1))
        i0 = np.clip(np.floor(c).astype(np.int64), 0, n_in - 1)
        i1 = np.minimum(i0 + 1, n_in - 1)
        np.add.at(m, (np.arange(n_out), i0), 1.0 - (c - i0))
        np.add.at(m, (np.arange(n_out), i1), c - i0)
    m.flags.writeable = False
    return m


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def nchw(x):
    return x.permute(0, 3, 1, 2)


# ---------------------------------------------------------------- encoder

def same_pad(i: int, k: int, s: int):
    total = max((math.ceil(i / s) - 1) * s + k - i, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Conv2d):
    def __init__(self, cin, cout, k, stride=1, groups=1, bias=False):
        super().__init__(cin, cout, k, stride=stride, padding=0, groups=groups, bias=bias)

    def forward(self, x):
        pt, pb = same_pad(x.shape[-2], self.kernel_size[0], self.stride[0])
        pl, pr = same_pad(x.shape[-1], self.kernel_size[1], self.stride[1])
        return super().forward(F.pad(x, (pl, pr, pt, pb)))


def divisible(v: float, d: int = 8) -> int:
    n = max(d, int(v + d / 2) // d * d)
    return n + d if n < 0.9 * v else n


class SqueezeExcite(nn.Module):
    def __init__(self, chs, rd):
        super().__init__()
        self.conv_reduce = nn.Conv2d(chs, rd, 1)
        self.conv_expand = nn.Conv2d(rd, chs, 1)

    def forward(self, x):
        se = x.mean((2, 3), keepdim=True)
        return x * torch.sigmoid(self.conv_expand(F.silu(self.conv_reduce(se))))


class ConvBnAct(nn.Module):
    def __init__(self, cin, cout, stride, exp, se):
        super().__init__()
        self.conv = Conv2dSame(cin, cout, 3, stride)
        self.bn1 = BatchNorm(cout, 1e-3)
        self.res = stride == 1 and cin == cout

    def forward(self, x):
        y = F.silu(self.bn1(self.conv(x)))
        return y + x if self.res else y


class EdgeResidual(nn.Module):
    def __init__(self, cin, cout, stride, exp, se):
        super().__init__()
        mid = divisible(cin * exp)
        self.conv_exp = Conv2dSame(cin, mid, 3, stride)
        self.bn1 = BatchNorm(mid, 1e-3)
        self.conv_pwl = nn.Conv2d(mid, cout, 1, bias=False)
        self.bn2 = BatchNorm(cout, 1e-3)
        self.res = stride == 1 and cin == cout

    def forward(self, x):
        y = self.bn2(self.conv_pwl(F.silu(self.bn1(self.conv_exp(x)))))
        return y + x if self.res else y


class InvertedResidual(nn.Module):
    def __init__(self, cin, cout, stride, exp, se):
        super().__init__()
        mid = divisible(cin * exp)
        self.conv_pw = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = BatchNorm(mid, 1e-3)
        self.conv_dw = Conv2dSame(mid, mid, 3, stride, groups=mid)
        self.bn2 = BatchNorm(mid, 1e-3)
        self.se = SqueezeExcite(mid, max(1, round(cin * se)))
        self.conv_pwl = nn.Conv2d(mid, cout, 1, bias=False)
        self.bn3 = BatchNorm(cout, 1e-3)
        self.res = stride == 1 and cin == cout

    def forward(self, x):
        y = F.silu(self.bn1(self.conv_pw(x)))
        y = F.silu(self.bn2(self.conv_dw(y)))
        y = self.bn3(self.conv_pwl(self.se(y)))
        return y + x if self.res else y


BLOCKS = {"cn": ConvBnAct, "er": EdgeResidual, "ir": InvertedResidual}


class ImageEncoder(nn.Module):
    def __init__(self, stem: int, stages):
        super().__init__()
        s, cin = [], stem
        for kind, reps, cout, stride, exp, se in stages:
            s.append(nn.Sequential(*[BLOCKS[kind](cin if i == 0 else cout, cout,
                                                  stride if i == 0 else 1, exp, se)
                                     for i in range(reps)]))
            cin = cout
        self.conv0 = nn.ModuleList([Conv2dSame(3, stem, 3, 2), BatchNorm(stem, 1e-3), s[0]])
        self.conv1, self.conv2 = s[1], s[2]
        self.conv3 = nn.ModuleList([s[3], s[4]])
        self.conv4 = s[5]

    def forward(self, x):
        stem, bn, stage0 = self.conv0
        x0 = stage0(F.silu(bn(stem(x))))
        x1 = self.conv1(x0)
        x2 = self.conv2(x1)
        x3 = self.conv3[1](self.conv3[0](x2))
        return [x0, x1, x2, x3, self.conv4(x3)]


class PointNetEncoder(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        for i in (1, 2, 3):
            setattr(self, f"conv{i}", nn.Conv1d(cin if i == 1 else cout, cout, 1))
            setattr(self, f"bn{i}", BatchNorm(cout, 1e-5, channel_dim=-1))

    def forward(self, x):  # [B', N, D], a shared MLP over the points
        for i in (1, 2, 3):
            conv = getattr(self, f"conv{i}")
            x = F.relu(getattr(self, f"bn{i}")(F.linear(x, conv.weight[:, :, 0], conv.bias)))
        return x


class HistExtractor(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.cout = cout
        self.pointnet_encoder = PointNetEncoder(cin, cout)

    def forward(self, h):
        B, Z, N, D = h.shape
        return self.pointnet_encoder(h.reshape(B * Z, N, D)).reshape(B, Z, N, self.cout)


class HistogramEncoder(nn.Module):
    def __init__(self, channels):
        super().__init__()
        for i, (cin, cout) in enumerate(zip((1,) + tuple(channels[:-1]), channels), start=1):
            setattr(self, f"hist_extractor{i}", HistExtractor(cin, cout))
        self.n = len(channels)

    def forward(self, h):
        feats = []
        for i in range(1, self.n + 1):
            h = getattr(self, f"hist_extractor{i}")(h)
            feats.append(h)
        return feats


# ---------------------------------------------------------------- attention

def linear_attention(q, k, v, eps: float = 1e-6):
    """elu+1 linear attention; q [N, L, H, D], k and v [N, S, H, D]."""
    Q, K = F.elu(q) + 1.0, F.elu(k) + 1.0
    S = v.shape[1]
    KV = torch.einsum("nshd,nshv->nhdv", K, v / S)
    Z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + eps)
    return torch.einsum("nlhd,nhdv->nlhv", Q, KV) * Z[..., None] * S


class LoFTREncoderLayer(nn.Module):
    """q/k/v projections, linear attention, merge, LayerNorm, MLP over the
    concatenation, LayerNorm, residual."""

    def __init__(self, d: int, nhead: int):
        super().__init__()
        self.d, self.nhead = d, nhead
        self.q_proj = nn.Linear(d, d, bias=False)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d, bias=False)
        self.merge = nn.Linear(d, d, bias=False)
        self.mlp = nn.Sequential(nn.Linear(2 * d, 2 * d, bias=False), nn.ReLU(),
                                 nn.Linear(2 * d, d, bias=False))
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, x, source):
        N, L, C = x.shape
        D = C // self.nhead
        q = (x @ self.q_proj.weight.t()).reshape(N, L, self.nhead, D)
        k = (source @ self.k_proj.weight.t()).reshape(N, -1, self.nhead, D)
        v = (source @ self.v_proj.weight.t()).reshape(N, -1, self.nhead, D)
        msg = linear_attention(q, k, v).reshape(N, L, C)
        msg = self.norm1(msg @ self.merge.weight.t())
        h = torch.relu(torch.cat([x, msg], dim=-1) @ self.mlp[0].weight.t())
        return self.norm2(h @ self.mlp[2].weight.t()) + x


class TwinsTransformer(nn.Module):
    """Locally grouped self-attention in ws x ws windows, then global
    sub-sampled attention (both with 8 heads, as published)."""

    def __init__(self, dim: int, ws: int):
        super().__init__()
        self.ws = ws
        self.lga = nn.Module()
        self.lga.encoder_layer = LoFTREncoderLayer(dim, 8)
        self.gsa = nn.Module()
        self.gsa.sr = nn.Conv2d(dim, dim, ws, stride=ws)
        self.gsa.norm = nn.LayerNorm(dim, eps=1e-5)
        self.gsa.encoder_layer = LoFTREncoderLayer(dim, 8)

    def forward(self, x, H: int, W: int):
        B, N, C = x.shape
        ws = self.ws
        pad_r, pad_b = (ws - W % ws) % ws, (ws - H % ws) % ws
        t = F.pad(x.reshape(B, H, W, C), (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        t = (t.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
             .reshape(-1, ws * ws, C))
        t = self.lga.encoder_layer(t, t)
        t = (t.reshape(B, Hp // ws, Wp // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
             .reshape(B, Hp, Wp, C)[:, :H, :W, :].reshape(B, H * W, C))
        kv = nhwc(self.gsa.sr(nchw(t.reshape(B, H, W, C))))
        kv = self.gsa.norm(kv.reshape(B, -1, C))
        return self.gsa.encoder_layer(t, kv)


class LoFTRNewCross9(nn.Module):
    """Cross-zone propagation: tokens outside the zone region attend to those
    inside; two conv3x3 + BN refine; residual."""

    def __init__(self, d: int, nhead: int):
        super().__init__()
        self.d, self.nhead = d, nhead
        self.q_proj = nn.Linear(d, d, bias=False)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d, bias=False)
        self.conv1 = nn.Conv2d(2 * d, d, 3, padding=1, bias=False)
        self.bn1 = BatchNorm(d, 1e-5)
        self.conv2 = nn.Conv2d(d, d, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(d, 1e-5)

    def forward(self, feat, rect, H: int, W: int):
        B, N, C = feat.shape
        zy0, zy1, zx0, zx1 = rect
        D = C // self.nhead
        x2d = feat.reshape(B, H, W, C)
        inside = x2d[:, zy0:zy1, zx0:zx1, :].reshape(B, -1, C)
        q = self.q_proj(feat).reshape(B, N, self.nhead, D)
        k = self.k_proj(inside).reshape(B, -1, self.nhead, D)
        v = self.v_proj(inside).reshape(B, -1, self.nhead, D)
        msg = linear_attention(q, k, v).reshape(B, H, W, C)
        keep = torch.ones(H, W, 1, dtype=msg.dtype, device=msg.device)
        keep[zy0:zy1, zx0:zx1] = 0
        y = nchw(torch.cat([x2d, msg * keep], dim=-1))
        y = self.bn2(self.conv2(self.bn1(self.conv1(y))))
        return nhwc(y).reshape(B, N, C) + feat


class DWConv(nn.Module):
    """The large-kernel depthwise conv (weight [C, 1, k, k], bias [C]) on an
    NHWC map, SAME-padded."""

    def __init__(self, dim: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dim, 1, k, k))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        k = self.weight.shape[-1]
        return nhwc(F.conv2d(nchw(x), self.weight, self.bias, padding=k // 2,
                             groups=x.shape[-1]))


class Block14(nn.Module):
    """Large-kernel ConvNeXt block: depthwise conv, BN, ReLU, LayerNorm,
    4x MLP with exact GELU, residual."""

    def __init__(self, dim: int, k: int):
        super().__init__()
        self.dwconv2 = DWConv(dim, k)
        self.bn1 = BatchNorm(dim, 1e-5, channel_dim=-1)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        y = F.relu(self.bn1(self.dwconv2(x)))
        return x + self.pwconv2(F.gelu(self.pwconv1(self.norm(y))))


class Combine1(nn.Module):
    def __init__(self, d: int, nhead: int, k: int):
        super().__init__()
        self.transformer_path = LoFTRNewCross9(d, nhead)
        self.large_kernel_path = Block14(d, k)

    def forward(self, feat, rect, H: int, W: int):
        B, N, C = feat.shape
        feat = self.transformer_path(feat, rect, H, W)
        return self.large_kernel_path(feat.reshape(B, H, W, C)).reshape(B, N, C)


class TransformerFusion(nn.Module):
    def __init__(self, dim: int, max_hw, names: Sequence[str], kernel: int, n_samples: int,
                 change_embedding: bool, no_skip_inside: bool):
        super().__init__()
        self.max_hw, self.names = tuple(max_hw), tuple(names)
        self.change_embedding, self.no_skip_inside = change_embedding, no_skip_inside
        maxH, maxW = self.max_hw
        self.positional_encodings = nn.Parameter(torch.zeros(maxH * maxW, dim))
        self.positional_encodings2 = nn.Parameter(torch.zeros(n_samples, dim))
        ws = math.ceil(math.sqrt(math.sqrt(maxH * maxW)))
        build = {"image": lambda: TwinsTransformer(dim, ws),
                 "hist2image": lambda: LoFTREncoderLayer(dim, 4),
                 "combine1": lambda: Combine1(dim, 4, kernel)}
        unknown = set(names) - set(build)
        if unknown:
            raise NotImplementedError(f"fusion layers {sorted(unknown)} are not in the reference")
        self.layers = nn.ModuleList(build[n]() for n in names)

    def forward(self, x, feat1, mask, g: geometry.Scale, generator=None):
        B, H, W, C = x.shape
        maxH, maxW = self.max_hw
        zn, p1, p2 = g.zone_num, g.p1, g.p2
        Z = zn * zn
        pos = self.positional_encodings.reshape(maxH, maxW, C)
        if H < maxH or W < maxW:
            if generator is None:
                oy, ox = (maxH - H) // 2, (maxW - W) // 2
            else:
                oy = int(torch.randint(0, maxH - H + 1, (), generator=generator))
                ox = int(torch.randint(0, maxW - W + 1, (), generator=generator))
            pos = pos[oy:oy + H, ox:ox + W]
        emb = x + pos[None]
        feat0 = emb.reshape(B, H * W, C)
        hist = (feat1 + self.positional_encodings2[None, None]).reshape(B * Z, -1, C)
        valid = mask.reshape(B * Z, 1, 1).to(x.dtype)
        zy0, zy1, zx0, zx1 = g.rect
        for name, layer in zip(self.names, self.layers):
            if name == "image":
                feat0 = layer(feat0, H, W)
            elif name == "combine1":
                feat0 = layer(feat0, g.rect, H, W)
            else:  # hist2image: each zone's pixels attend to its histogram samples
                src = feat0.reshape(B, H, W, C) if self.change_embedding else emb
                zone = F.pad(src, (0, 0, g.pad_w, g.pad_w, g.pad_h, g.pad_h))[
                    :, g.sy:g.ey, g.sx:g.ex, :]
                if g.interpolate:
                    zone = resize(zone, zn * p1, zn * p2)
                tok = (zone.reshape(B, zn, p1, zn, p2, C).permute(0, 1, 3, 2, 4, 5)
                       .reshape(B * Z, p1 * p2, C))
                tok = layer(tok, hist) * valid
                out = (tok.reshape(B, zn, zn, p1, p2, C).permute(0, 1, 3, 2, 4, 5)
                       .reshape(B, zn * p1, zn * p2, C))
                if g.interpolate:
                    out = resize(out, g.ey - g.sy, g.ex - g.sx)
                oy0, ox0 = max(0, -g.sy_wo), max(0, -g.sx_wo)
                block = out[:, oy0:oy0 + zy1 - zy0, ox0:ox0 + zx1 - zx0, :]
                f2d = feat0.reshape(B, H, W, C)
                region = f2d[:, zy0:zy1, zx0:zx1, :]
                new = block if self.no_skip_inside else region + block
                f2d = torch.cat([f2d[:, :zy0], torch.cat(
                    [f2d[:, zy0:zy1, :zx0], new, f2d[:, zy0:zy1, zx1:]], dim=2),
                    f2d[:, zy1:]], dim=1)
                feat0 = f2d.reshape(B, H * W, C)
        return feat0.reshape(B, H, W, C)


# ---------------------------------------------------------------- decoder, head

class UpSampleBN(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self._net = nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1), BatchNorm(cout, 1e-5),
                                  nn.LeakyReLU(0.01), nn.Conv2d(cout, cout, 3, padding=1),
                                  BatchNorm(cout, 1e-5), nn.LeakyReLU(0.01))

    def forward(self, x, skip):
        up = nchw(resize(nhwc(x), skip.shape[2], skip.shape[3]))
        return self._net(torch.cat([up, skip], dim=1))


class Decoder(nn.Module):
    def __init__(self, num_classes, ec, dc, native_hw, names, n_samples, change_embedding,
                 no_skip_inside):
        super().__init__()
        half = [c // 2 for c in dc]
        nh, nw = native_hw

        def fusion(dim, scale, k):
            return TransformerFusion(dim, (nh // scale, nw // scale), names, k, n_samples,
                                     change_embedding, no_skip_inside)

        self.conv4 = nn.Conv2d(ec[0], dc[0], 1)
        self.up1 = UpSampleBN(dc[0] + ec[1], dc[1])
        self.conv3 = nn.Conv2d(dc[1], half[1], 1)
        self.cross_atten3 = fusion(half[1], 16, 7)
        self.up2 = UpSampleBN(2 * half[1] + ec[2], dc[2])
        self.conv2 = nn.Conv2d(dc[2], half[2], 1)
        self.cross_atten2 = fusion(half[2], 8, 15)
        self.up3 = UpSampleBN(2 * half[2] + ec[3], dc[3])
        self.conv1 = nn.Conv2d(dc[3], half[3], 1)
        self.cross_atten1 = fusion(half[3], 4, 31)
        self.up4 = UpSampleBN(2 * half[3] + ec[4], dc[4])
        self.conv0 = nn.Conv2d(dc[4], num_classes, 3, padding=1)

    def forward(self, img, hist, mask, geoms, generator=None):
        x0, x1, x2, x3, x4 = img
        h1, h2, h3 = hist

        def fuse(x, fusion, h, scale):
            return torch.cat([x, nchw(fusion(nhwc(x), h, mask, geoms[scale], generator))], 1)

        d3 = fuse(self.conv3(self.up1(self.conv4(x4), x3)), self.cross_atten3, h3, 16)
        d2 = fuse(self.conv2(self.up2(d3, x2)), self.cross_atten2, h2, 8)
        d1 = fuse(self.conv1(self.up3(d2, x1)), self.cross_atten1, h1, 4)
        return self.conv0(self.up4(d1, x0))


class DepthRegression(nn.Module):
    def __init__(self, cin: int, n_bins: int, emb: int, norm: str):
        super().__init__()
        if norm != "linear":
            raise NotImplementedError(f"--norm {norm} is not in the reference")
        self.conv3x3 = nn.Conv2d(cin, emb, 3, padding=1)
        self.conv1x1 = nn.Conv2d(cin, emb, 1, bias=False)
        self.regressor = nn.Sequential(nn.Linear(emb, 256), nn.LeakyReLU(0.01),
                                       nn.Linear(256, 256), nn.LeakyReLU(0.01),
                                       nn.Linear(256, n_bins))

    def forward(self, x):
        y = F.relu(self.regressor(self.conv1x1(x).mean(dim=(2, 3)))) + 0.1
        return y / y.sum(dim=1, keepdim=True), self.conv3x3(x)


class CFPNet(nn.Module):
    """The whole model: ``forward(rgb [B,H,W,3], hist [B,Z,n], mask [B,Z],
    geoms, generator)`` -> ``(bin_edges [B, n_bins+1], pred [B,h,w,1])``,
    both float32 or wider."""

    def __init__(self, settings: Dict, widths: Dict = B3):
        super().__init__()
        s, w = settings, widths
        self.min_val, self.max_val = s["min_depth"], s["max_depth"]
        dc = w["decoder_channels"]
        self.img_encoder = ImageEncoder(w["stem"], w["stages"])
        self.hist_encoder = HistogramEncoder((dc[3] // 2, dc[2] // 2, dc[1] // 2))
        self.decoder = Decoder(w["num_classes"], w["encoder_channels"], dc,
                               (s["native_height"], s["native_width"]), s["attention_layer"],
                               s["zone_sample_num"], s.get("change_embedding", False),
                               s.get("no_skip_inside", False))
        self.depth_head = DepthRegression(w["num_classes"], s["n_bins"], w["num_classes"],
                                          s["norm"])
        self.conv_out = nn.Sequential(nn.Conv2d(w["num_classes"], s["n_bins"], 1))

    def forward(self, rgb, hist, mask, geoms, generator: Optional[torch.Generator] = None):
        img = self.img_encoder(nchw(rgb))
        feats = self.hist_encoder(hist[..., None])
        widths, maps = self.depth_head(self.decoder(img, feats, mask, geoms, generator))
        # the depth tail in float32 (or wider) whatever the model's dtype
        tail = torch.promote_types(maps.dtype, torch.float32)
        prob = torch.softmax(self.conv_out(maps).to(tail), dim=1)
        edges = torch.cumsum(F.pad((self.max_val - self.min_val) * widths.to(tail), (1, 0),
                                   value=self.min_val), dim=1)
        centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
        pred = torch.sum(prob * centers[:, :, None, None], dim=1, keepdim=True)
        return edges, nhwc(pred)


def build(settings: Dict, device="cpu", widths: Dict = B3) -> CFPNet:
    """The reference model for a configuration's settings, on ``device``, in
    eval mode."""
    with torch.device(device):
        return CFPNet(settings, widths).eval()
