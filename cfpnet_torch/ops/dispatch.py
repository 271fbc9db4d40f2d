"""Op dispatch between the plain PyTorch ops and the CUDA kernels.

Port of ``cfpnet_tpu/ops/dispatch.py`` (``attention``, ``dwconv2d``), plus
``loftr_layer``, which the JAX package has no switch for.

- An unmasked call goes by the tensor's device, not a flag: a CPU tensor
  takes the plain version, a CUDA tensor always takes the kernel. Nothing
  falls back: an unmasked CUDA call the kernels cannot take (another dtype)
  raises, and so does a tensor on any other device (meta, outside a trace).
- A masked call (a mask given) takes the plain route on every device, in
  the tensor's dtype, chosen before anything launches: masked attention the
  plain twin ``ops/attention.py::linear_attention``, a masked LoFTR layer
  its module path (``LoFTREncoderLayer.modules_forward``). No kernel takes a
  mask, as no Pallas kernel does: the JAX package sends a masked call to its
  XLA ``linear_attention`` (``cfpnet_tpu/ops/dispatch.py:60-66``) on its
  chip too. No call of the main path is masked.

On the card every unmasked ``LoFTREncoderLayer`` (the 18 hist2image, LSA and
GSA layers of the eval forward) runs as one call of the fused LoFTR kernel,
and only ``LoFTRNewCross9`` calls the attention kernel. The JAX model never
dispatches to its fused kernel; its own docstrings disagree on that
(``cfpnet_tpu/ops/pallas_loftr.py:26-28`` says the eval path does,
``tests/test_pallas_loftr.py:7-8`` that nothing does).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import dwconv as dwconv_kernel
from ..kernels import fused_loftr as loftr_kernel
from ..kernels import linear_attention as attention_kernel
from .attention import linear_attention


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_mask: Optional[torch.Tensor] = None,
              kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N,L,H,D] linear attention: unmasked, the kernel (its plain version
    on the CPU); masked, the plain version on the tensors' device."""
    if q_mask is None and kv_mask is None:
        return attention_kernel.linear_attention(q, k, v)
    return linear_attention(q, k, v, q_mask=q_mask, kv_mask=kv_mask)


def dwconv2d(x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME-padded stride-1 depthwise conv plus bias; x NHWC, weight [C,1,k,k]."""
    return dwconv_kernel.depthwise_conv2d(x, weight, bias)


def loftr_layer(x: torch.Tensor, source: torch.Tensor, layer,
                x_mask: Optional[torch.Tensor] = None,
                source_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One ``models.transformer.LoFTREncoderLayer`` on x [N, L, C] against
    source [N, S, C]: unmasked, the fused kernel (its plain version on the
    CPU); masked, the layer's module path on the tensors' device."""
    if x_mask is None and source_mask is None:
        return loftr_kernel.fused_loftr(x, source, layer.loftr_params(), layer.nhead)
    return layer.modules_forward(x, source, x_mask, source_mask)
