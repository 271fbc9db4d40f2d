"""What the wrappers share: the element types the kernels take (the C entry
suffix of each, the check that a call's tensors share one of them), the
launch counters (``kernel.<name>.launches.<dtype>`` in
``cfpnet_torch.tracing``, graph replays included: read them with
``tracing.counters`` and reset them with ``tracing.reset_counters``), the
output of an op under a trace, and the operations of an op as
``torch.utils.flop_counter`` counts them."""

from __future__ import annotations

import torch

from .. import tracing

DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}  # element type -> C entry suffix


def check_dtypes(kernel: str, tensors) -> None:
    """Raises unless the (name, tensor) pairs are all float32 or all
    bfloat16: a kernel takes one element type a call and casts nothing."""
    dtype = tensors[0][1].dtype
    for name, t in tensors:
        if t.dtype not in DTYPES:
            raise TypeError(f"{kernel}: {name} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} is {t.dtype} and {tensors[0][0]} {dtype}; the "
                            "kernel takes one element type")


def dtype_name(dtype: torch.dtype) -> str:
    """The name of a torch dtype ("float32", "bfloat16"), as
    ``--compute_dtype`` and numpy spell it."""
    return str(dtype).replace("torch.", "")


def count_launch(kernel: str, dtype: torch.dtype) -> None:
    """Counts one launch of ``kernel`` on ``dtype`` ("float32", "bfloat16")."""
    tracing.count(f"kernel.{kernel}.launches.{dtype_name(dtype)}")


def traced_output(kernel: str, like: torch.Tensor,
                  memory_format=torch.contiguous_format) -> torch.Tensor:
    """The fake implementation of a kernel's op: under a trace
    (``torch.export``, whose tensors are fake), an empty tensor like
    ``like``, the output's shape and dtype, in the layout the kernel gives
    (contiguous, as the kernels that take only contiguous inputs write it,
    whatever strides the trace's fake input has; ``bn_act`` keeps its
    input's). A meta tensor outside a trace raises as the kernel's checks do
    for any tensor off a CUDA device: an op computes on the card or, for a
    CPU tensor, by its plain version, and on nothing else."""
    from torch._subclasses.fake_tensor import is_fake

    if not is_fake(like):
        raise ValueError(f"{kernel}: the kernel takes tensors on a CUDA device, got {like.device}")
    return torch.empty_like(like, memory_format=memory_format)


def meta(shape) -> torch.Tensor:
    """An f32 tensor of ``shape`` on the meta device: a shape to compute on."""
    return torch.empty(shape, device="meta")


def plain_flops(fn, *args) -> int:
    """The operations ``torch.utils.flop_counter`` counts in ``fn(*args)``:
    an op's flop formula, from its plain version on meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()
