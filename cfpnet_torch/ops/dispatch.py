"""Op dispatch between the plain PyTorch ops and the CUDA kernels.

Port of ``cfpnet_tpu/ops/dispatch.py`` (``attention``, ``dwconv2d``), plus
``loftr_layer``, ``batch_norm`` and ``softmax_attention``, which the JAX
package has no switch for.

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
- BatchNorm (``batch_norm``, called by ``models/layers.py::BatchNorm``)
  routes by training mode and by the need for a gradient, chosen before
  anything launches: an eval-mode call on a CUDA tensor that needs no
  gradient (grad mode off, or nothing that requires one) goes to the
  kernel ``kernels/bn_act.py`` with its activation and shortcut, and raises
  there on what the kernel does not take (a layout it does not read, mixed
  element types), as the unmasked calls above do. Training mode (the train
  step, ``--remat``'s recompute, the self-supervised step) and a call that
  needs a gradient take BatchNorm's formula written out in PyTorch
  (``bn_act_plain``), a different computation and not a fallback: the
  kernel has no gradient and no batch statistics, as the JAX package has
  no kernel there (XLA fuses the formula). So does every call off the
  card.

Softmax attention (``softmax_attention``, Depth Anything V2's blocks,
``models/depth_anything.py``) goes by the device as the unmasked calls do: a
CPU tensor the plain twin ``ops/attention.py::softmax_attention``, a CUDA
tensor one fused attention kernel, PyTorch's ``scaled_dot_product_attention``
with its backend pinned (``SOFTMAX_ATTENTION_BACKEND``) under
``torch.nn.attention.sdpa_kernel``. Where the pinned backend cannot take a
call (float32, a head size it lacks) ``scaled_dot_product_attention`` raises;
it never drops to another backend or to the math one. Each call on the card
counts one ``kernel.softmax_attention.launches.<dtype>``. The JAX package
has no softmax attention, so no TPU kernel is ported here; a hand-written
Hopper kernel is to take the pinned backend's place.

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
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..kernels import bn_act as bn_act_kernel
from ..kernels import dwconv as dwconv_kernel
from ..kernels import fused_loftr as loftr_kernel
from ..kernels import linear_attention as attention_kernel
from ..kernels.dtypes import count_launch
from .attention import linear_attention
from .attention import softmax_attention as softmax_attention_plain

# The fused attention backend of the card route: cuDNN's, whose Hopper kernel
# (wgmma) took 45.0-46.1 us a call at the Depth Anything V2 cell's shape (q, k,
# v [1, 16, 1814, 64] bf16, views of one qkv product) against 57.0-58.1 us for
# the flash backend (FlashAttention-2's sm80 kernel) and 124-127 us for the
# memory-efficient one, on an H100 at 700 W (PERF.md, PR 25).
SOFTMAX_ATTENTION_BACKEND = SDPBackend.CUDNN_ATTENTION


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


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
               var: torch.Tensor, eps: float, act: str = "identity", channel_dim: int = 1,
               residual: Optional[torch.Tensor] = None, training: bool = False) -> torch.Tensor:
    """``act(BatchNorm(x)) + residual`` with the statistics given: in eval
    mode on the card with no gradient needed, the kernel; otherwise the
    formula written out (module docstring)."""
    args = (x, weight, bias, mean, var, eps, act, channel_dim, residual)
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, weight, bias, mean, var, residual))
    if x.device.type == "cuda" and not training and not needs_grad:
        return bn_act_kernel.bn_act(*args)
    return bn_act_kernel.bn_act_plain(*args)


def softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """[B,H,L,D] softmax attention, ``softmax(q k^T * scale) v``: the plain
    twin on the CPU, the pinned fused kernel on the card (module
    docstring); raises on any other device."""
    if q.device.type == "cpu":
        return softmax_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"softmax_attention takes CPU or CUDA tensors, got {q.device}")
    with sdpa_kernel(SOFTMAX_ATTENTION_BACKEND):
        out = F.scaled_dot_product_attention(q, k, v, scale=scale)
    count_launch("softmax_attention", q.dtype)
    return out
