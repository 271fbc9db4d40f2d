"""The element types the kernels take, shared by the three wrappers: the C
entry suffix of each, the check that a call's tensors share one of them,
and the launch count by element type."""

from __future__ import annotations

from typing import Dict

import torch

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


def count_launch(by_dtype: Dict[str, int], dtype: torch.dtype) -> None:
    """Adds one launch on ``dtype`` ("float32", "bfloat16") to ``by_dtype``."""
    key = dtype_name(dtype)
    by_dtype[key] = by_dtype.get(key, 0) + 1
