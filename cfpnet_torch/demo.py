"""Single-frame demo: RGB 480x640 + 8x8 ToF zone histograms -> dense depth.

    python -m cfpnet_torch.demo [--rgb img.jpg --depth depth.png]
        [--weights weights/<name>/best] [--out demo_depth.png] [--tiny]
        [--device cuda|cpu]

Port of ``scripts/demo.py``: the production model's bs=1 eval forward on
one frame (a real one if ``--rgb``/``--depth`` are given, its histograms
simulated from the depth; else the synthetic set's first frame), the
prediction resized to the image, its statistics printed and a colorized
PNG written (``utils/vis.py::colorize``, matplotlib and Pillow).

- ``--weights``: a weights file as training writes it, or a reference
  ``.pt`` (``weights.load_reference_checkpoint``).
- Without it the JAX demo draws flax's random init from key 0, which
  PyTorch cannot reproduce: the port uses the golden tests' deterministic
  weights (``weights.deterministic_state_dict``) and says so.
- ``--device`` (default the card): where the forward runs.

``predict`` is the forward alone (no PIL or matplotlib), which
``chip_smoke.py`` calls on the card.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from . import weights
from .config import Config
from .data import tof_sim
from .data.datasets import SyntheticDataset, normalize_image, sample_image_f32
from .data.geometry import geometry_for
from .models.deltar import make_model, model_geometries
from .ops.interp import resize_bilinear_align_corners


def demo_config() -> Config:
    """The JAX demo's configuration: the production model's topology with
    every other setting at its default."""
    return Config(n_bins=256, attention_layer=["hist2image", "combine1", "image",
                                               "hist2image", "combine1", "image"],
                  change_embedding=True, sample_uniform=True)


def load_frame(config, rgb: Optional[str] = None, depth: Optional[str] = None) -> dict:
    """The demo's sample: an RGB image and its depth map (meters = PNG value
    / 1000) with the histograms simulated from the depth, or, without
    ``rgb``, the synthetic eval set's first frame."""
    if not rgb:
        return SyntheticDataset(config, "online_eval")[0]
    from PIL import Image

    img = np.asarray(Image.open(rgb), np.float32) / 255.0
    dep = np.asarray(Image.open(depth), np.float32) / 1000.0
    fh, _, mask = tof_sim.get_hist(dep, geometry_for(config, "online_eval"),
                                   config.simu_max_distance)
    pts = tof_sim.sample_points(fh, mask, config.zone_sample_num, True)
    return dict(image=normalize_image(img).astype(np.float32), depth=dep[..., None],
                hist_data=pts, mask=mask)


def predict(config, sample: dict, state_dict=None, tiny: bool = False,
            device="cuda") -> np.ndarray:
    """Depth [H, W] of ``sample`` at its image's size: the bs=1 eval forward
    on ``device`` with ``state_dict`` (default: the deterministic weights),
    its prediction resized with align-corners bilinear as the JAX demo does."""
    model = make_model(config, tiny=tiny, device=device)
    if state_dict is None:
        state_dict = weights.deterministic_state_dict(config, tiny)
    model.load_state_dict(state_dict, strict=True)
    image = torch.from_numpy(sample_image_f32(sample)[None]).to(device)
    hist = torch.from_numpy(np.asarray(sample["hist_data"], np.float32)[None]).to(device)
    mask = torch.from_numpy(np.asarray(sample["mask"])[None]).to(device)
    with torch.no_grad():
        pred = model(image, hist, mask, model_geometries(config, "online_eval"))[1]
        pred = resize_bilinear_align_corners(pred, image.shape[1], image.shape[2])
    return pred[0, :, :, 0].cpu().numpy()


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    """Writes the PNG; returns the prediction."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rgb")
    ap.add_argument("--depth")
    ap.add_argument("--weights")
    ap.add_argument("--out", default="demo_depth.png")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    config = demo_config()
    sample = load_frame(config, args.rgb, args.depth)
    state_dict = None
    if args.weights:
        state_dict = weights.load_reference_checkpoint(args.weights)
    else:
        print("note: deterministic weights (weights.deterministic_state_dict; flax's random "
              "init cannot be drawn here), pass --weights for a trained model")
    pred = predict(config, sample, state_dict, args.tiny, args.device)
    print(f"pred depth: shape {pred.shape}, range [{pred.min():.3f}, "
          f"{pred.max():.3f}] m, mean {pred.mean():.3f} m")

    from PIL import Image

    from .utils.vis import colorize

    Image.fromarray(colorize(pred, vmin=float(pred.min()), vmax=float(pred.max()))).save(args.out)
    print(f"wrote {args.out}")
    return pred


if __name__ == "__main__":
    main()
