"""Op dispatch between the plain PyTorch ops and the CUDA kernels.

Port of ``cfpnet_tpu/ops/dispatch.py`` (``attention``, ``dwconv2d``). The
switch is the tensor's device, not a flag: a CPU tensor takes the plain
version, a CUDA tensor always takes the kernel. Nothing falls back: a CUDA
call the kernels cannot take (masked attention, a tensor that needs a
gradient, another dtype) raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import dwconv as dwconv_kernel
from ..kernels import linear_attention as attention_kernel
from .attention import linear_attention


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_mask: Optional[torch.Tensor] = None,
              kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N,L,H,D] linear attention."""
    if q_mask is None and kv_mask is None:
        return attention_kernel.linear_attention(q, k, v)
    if q.device.type != "cpu":
        raise NotImplementedError("masked linear attention has no CUDA kernel yet")
    return linear_attention(q, k, v, q_mask=q_mask, kv_mask=kv_mask)


def dwconv2d(x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME-padded stride-1 depthwise conv plus bias; x NHWC, weight [C,1,k,k]."""
    return dwconv_kernel.depthwise_conv2d(x, weight, bias)
