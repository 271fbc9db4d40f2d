"""Visualization helpers of the epoch sweep's image dumps.

The port's own copy of ``cfpnet_tpu/utils/vis.py`` (``unnormalize``,
``colorize``; reference src/utils/utils.py:44-64, nyu.py:249-264). matplotlib
is imported inside ``colorize``, as the JAX package does, so the module
imports without it; only ``--save_pred`` and ``--save_error_map`` need it.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def unnormalize(image: np.ndarray) -> np.ndarray:
    """Invert the ImageNet normalization: [H,W,3] normalized -> 0..1.

    (Reference ``UnNormalize``, nyu.py:249-264, channels-first; ours NHWC.)
    """
    return np.asarray(image) * IMAGENET_STD + IMAGENET_MEAN


def colorize(value: np.ndarray, vmin=10, vmax=1000, cmap: str = "magma_r") -> np.ndarray:
    """Depth map -> RGB uint8 via a matplotlib colormap.

    value: [H, W] (or [1, H, W]); -1 marks invalid (rendered white).
    """
    value = np.asarray(value)
    if value.ndim == 3:
        value = value[0]
    invalid = value == -1
    vmin = value.min() if vmin is None else vmin
    vmax = value.max() if vmax is None else vmax
    if vmin != vmax:
        value = (value - vmin) / (vmax - vmin)
    else:
        value = value * 0.0
    import matplotlib

    cmapper = matplotlib.colormaps.get_cmap(cmap)
    img = cmapper(value, bytes=True)
    img[invalid] = 255
    return img[:, :, :3]
