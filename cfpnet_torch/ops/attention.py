"""Kernelized (elu+1) linear attention, plain PyTorch.

Port of ``cfpnet_tpu/ops/attention.py::linear_attention``: O(N·d²)
attention with the elu+1 feature map, the ``values / v_length``
overflow guard and the 1e-6 normalizer epsilon, in the same contraction
order (K·V summary first, then Q·(KV)). This is the CPU path and the plain
version the CUDA kernel (``kernels/linear_attention.py``) is held against.

In bfloat16 it computes as the Pallas kernel does in bf16
(``cfpnet_tpu/ops/pallas_attention.py:71-88``): elu(q)+1, elu(k)+1, v / S
and the key sum are rounded to bf16, the K·V summary, the denominator and
the numerator are f32 sums of those values, and the output is rounded once.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def elu_feature_map(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x) + 1.0


def linear_attention(
    queries: torch.Tensor,
    keys: torch.Tensor,
    values: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Multi-head linear attention.

    queries: [N, L, H, D]; keys/values: [N, S, H, D];
    q_mask: [N, L]; kv_mask: [N, S]. Returns [N, L, H, D].
    """
    if queries.dtype == torch.bfloat16:
        return _linear_attention_bf16(queries, keys, values, q_mask, kv_mask, eps)
    Q = elu_feature_map(queries)
    K = elu_feature_map(keys)

    if q_mask is not None:
        Q = Q * q_mask[:, :, None, None].to(Q.dtype)
    if kv_mask is not None:
        m = kv_mask[:, :, None, None].to(K.dtype)
        K = K * m
        values = values * m

    v_length = values.shape[1]
    values = values / v_length  # fp16/bf16 overflow guard (reference :42)
    KV = torch.einsum("nshd,nshv->nhdv", K, values)
    Z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + eps)
    return torch.einsum("nlhd,nhdv->nlhv", Q, KV) * Z[..., None] * v_length


def _bf16_values(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, as float32."""
    return x.to(torch.bfloat16).float()


def _linear_attention_bf16(queries, keys, values, q_mask, kv_mask, eps):
    """``linear_attention`` on bfloat16 inputs with the Pallas kernel's
    rounding points; returns bfloat16."""
    Q = _bf16_values(elu_feature_map(queries.float()))
    K = _bf16_values(elu_feature_map(keys.float()))
    values = values.float()
    if q_mask is not None:
        Q = Q * q_mask[:, :, None, None].float()
    if kv_mask is not None:
        m = kv_mask[:, :, None, None].float()
        K = K * m
        values = values * m
    v_length = values.shape[1]
    KV = torch.einsum("nshd,nshv->nhdv", K, _bf16_values(values / v_length))
    Z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, _bf16_values(K.sum(dim=1))) + eps)
    out = torch.einsum("nlhd,nhdv->nlhv", Q, KV) * Z[..., None] * v_length
    return out.to(torch.bfloat16)


def softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """Multi-head softmax attention, plain: ``softmax(q k^T * scale) v`` as
    two products and a softmax over the keys. q: [B, H, L, D]; k, v:
    [B, H, S, D] (the layout of ``F.scaled_dot_product_attention``). Returns
    [B, H, L, D] in q's dtype; the scores, the softmax and the sum over keys
    in float32 or wider (a bf16 call rounds once, at the output).

    The CPU path of ``ops/dispatch.py::softmax_attention`` and the twin its
    card route is held against. The JAX package has no softmax attention;
    this follows DINOv2's ``Attention.forward`` (``dinov2.py``)."""
    wide = torch.promote_types(q.dtype, torch.float32)
    scores = torch.matmul(q.to(wide), k.to(wide).transpose(-2, -1)) * scale
    return torch.matmul(torch.softmax(scores, dim=-1), v.to(wide)).to(q.dtype)
