"""Hand-written CUDA kernels (sources in ``cfpnet_torch/csrc``).

One module per kernel: its wrapper, its launch count and its plain twin.
Nothing is built or loaded when this package is imported.
"""

from . import dwconv, linear_attention

KERNELS = (linear_attention, dwconv)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.reset_launches()
