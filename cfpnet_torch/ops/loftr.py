"""The LoFTR encoder layer as one function, plain PyTorch.

Port of ``cfpnet_tpu/ops/pallas_loftr.py`` (``LoFTRParams``,
``layernorm_f32``, ``loftr_apply_xla``). This is the CPU path of
``kernels/fused_loftr.py``, the plain version its CUDA kernel is held
against, and the function its backward differentiates.

Layouts are the JAX package's: x [N, L, C], source [N, S, C], and the
weights of ``LoFTRParams`` are [in, out] as flax ``nn.Dense`` stores them.
A port module hands its ``nn.Linear`` weights over as ``weight.t()``
(``LoFTREncoderLayer.loftr_params``): an [in, out] view of the [out, in]
storage, which is the memory the CUDA kernel reads.

In bfloat16 ``loftr_apply`` computes as the Pallas kernel's body does in
bf16 (``cfpnet_tpu/ops/pallas_loftr.py::_kernel``, ``:108-142``, with the
weights cast to bf16 as ``_fused_loftr_impl`` casts them, ``:168-171``):
the q, k, v products and the attention in f32, the message rounded to bf16
before the merge, LN1's output and the ReLU output rounded, LN2 and the
residual in f32, the output rounded once. That is the kernel's bf16
variant, not ``loftr_apply_xla``'s bf16 (which rounds every product).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .attention import linear_attention


class LoFTRParams(NamedTuple):
    """Weights of one LoFTR encoder layer; matrices are [in, out]."""

    wq: torch.Tensor  # [C, C]
    wk: torch.Tensor  # [C, C]
    wv: torch.Tensor  # [C, C]
    wm: torch.Tensor  # [C, C]  merge
    g1: torch.Tensor  # [C]     norm1 scale
    b1: torch.Tensor  # [C]     norm1 bias
    w0: torch.Tensor  # [2C, 2C] mlp_0 (input = concat[x, message])
    w1: torch.Tensor  # [2C, C]  mlp_1
    g2: torch.Tensor  # [C]     norm2 scale
    b2: torch.Tensor  # [C]     norm2 bias


def layernorm_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """flax ``nn.LayerNorm`` with its fast variance, var = max(0, E[x^2] -
    E[x]^2). Statistics are taken in float32, or in the input's type where
    that is wider: float64 stays float64, as in flax. (The JAX clone casts
    even float64 to float32, so under x64 its result carries float32
    rounding; see ROADMAP C.) Returns the statistics' dtype."""
    dt = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(dt)
    mean = xf.mean(-1, keepdim=True)
    mean2 = (xf * xf).mean(-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * scale.to(dt)
    return (xf - mean) * mul + bias.to(dt)


def loftr_apply(x: torch.Tensor, source: torch.Tensor, p: LoFTRParams, nhead: int,
                eps: float = 1e-6) -> torch.Tensor:
    """One unmasked ``LoFTREncoderLayer``: q/k/v projections, elu+1 linear
    attention, merge, LayerNorm, concat-MLP with ReLU, LayerNorm, residual.
    x: [N, L, C]; source: [N, S, C]. Returns [N, L, C]."""
    if x.dtype == torch.bfloat16:
        return _loftr_apply_bf16(x, source, p, nhead, eps)
    N, L, C = x.shape
    S = source.shape[1]
    D = C // nhead
    dt = x.dtype
    q = (x @ p.wq.to(dt)).reshape(N, L, nhead, D)
    k = (source @ p.wk.to(dt)).reshape(N, S, nhead, D)
    v = (source @ p.wv.to(dt)).reshape(N, S, nhead, D)
    msg = linear_attention(q, k, v, eps=eps).reshape(N, L, C)
    msg = layernorm_f32(msg @ p.wm.to(dt), p.g1, p.b1).to(dt)
    h = torch.relu(torch.cat([x, msg], dim=-1) @ p.w0.to(dt))
    h = layernorm_f32(h @ p.w1.to(dt), p.g2, p.b2).to(dt)
    return h + x


def _loftr_apply_bf16(x, source, p: LoFTRParams, nhead: int, eps: float) -> torch.Tensor:
    """``loftr_apply`` on bfloat16 inputs with the Pallas kernel's rounding
    points; returns bfloat16."""
    N, L, C = x.shape
    S = source.shape[1]
    D = C // nhead
    bf16 = torch.bfloat16

    def w(t):  # the weight's bf16 values, as the kernel casts them
        return t.to(bf16).float()

    X, src = x.float(), source.float()
    q = (X @ w(p.wq)).reshape(N, L, nhead, D)
    k = (src @ w(p.wk)).reshape(N, S, nhead, D)
    v = (src @ w(p.wv)).reshape(N, S, nhead, D)
    msg = linear_attention(q, k, v, eps=eps).reshape(N, L, C).to(bf16).float()
    msg = layernorm_f32(msg @ w(p.wm), p.g1, p.b1).to(bf16).float()
    w0 = w(p.w0)
    h = torch.relu(X @ w0[:C] + msg @ w0[C:]).to(bf16).float()
    h = layernorm_f32(h @ w(p.w1), p.g2, p.b2)
    return (h + X).to(bf16)
