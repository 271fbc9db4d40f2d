"""Hand-written CUDA kernels (sources in ``cfpnet_torch/csrc``).

One module per kernel: its wrapper, which counts its launches in the
counters of ``cfpnet_torch.tracing`` (``kernel.<name>.launches.<dtype>``),
and its plain twin. Importing this package registers the kernels'
``torch.library`` ops; nothing is built or loaded.
"""

from . import bn_act, dwconv, fused_loftr, linear_attention  # noqa: F401
