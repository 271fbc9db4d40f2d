"""Kernelized (elu+1) linear attention, plain PyTorch.

Port of ``cfpnet_tpu/ops/attention.py::linear_attention``: O(N·d²)
attention with the elu+1 feature map, the ``values / v_length``
overflow guard and the 1e-6 normalizer epsilon, in the same contraction
order (K·V summary first, then Q·(KV)). This is the CPU path and the plain
version the CUDA kernel (``kernels/linear_attention.py``) is held against.
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
