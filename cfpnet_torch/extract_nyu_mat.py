"""Extract the official NYU-Depth-v2 train/test images from
nyu_depth_v2_labeled.mat + splits.mat.

    python -m cfpnet_torch.extract_nyu_mat nyu_depth_v2_labeled.mat splits.mat out_dir

The port's own copy of ``tools/extract_nyu_mat.py`` (the reference's
``extract_official_train_test_set_from_mat.py``), with its conversion:

- depth comes from ``rawDepths`` (not the inpainted ``depths``),
  transposed to [H, W], scaled by 1000 and cast to uint16 millimeters,
  saved as a 16-bit PNG with no border masking (``convert_depth_mm``);
- RGB is composited onto a black 480x640 canvas keeping rows 7:474 and
  cols 7:632 (``convert_rgb_black_border``), saved as JPEG at quality 95;
- split membership uses the 1-based ``trainNdxs``/``testNdxs``, and a frame
  in neither split fails the reference's assertion;
- layout ``out/{train,test}/<sceneType>/rgb_XXXXX.jpg`` and
  ``sync_depth_XXXXX.png`` (0-based, zero-padded ids): the
  ``official_splits`` tree that ``data/datasets.py``'s NYU loader reads.

Needs h5py, scipy and Pillow, imported when it runs. JPEG bytes depend on
the encoder's build; the arrays handed to it, and the lossless depth
PNGs' pixels, are those of the JAX package's tool.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

import numpy as np


def convert_depth_mm(depth_raw_m: np.ndarray) -> np.ndarray:
    """[H, W] raw depth in meters -> uint16 millimeters, no border zeroing."""
    return (depth_raw_m * 1000.0).astype(np.uint16)


def convert_rgb_black_border(image_hwc: np.ndarray) -> np.ndarray:
    """[480, 640, 3] uint8 RGB -> the same, composited onto black zeros
    keeping rows 7:474 and cols 7:632. (The reference flips to BGR for
    cv2.imwrite, which flips back on write: the saved pixels are RGB.)"""
    out = np.zeros((480, 640, 3), dtype=np.uint8)
    out[7:474, 7:632, :] = image_hwc[7:474, 7:632, :]
    return out


def convert_image(idx: int, scene_dir: str, depth_raw_m: np.ndarray,
                  img: np.ndarray, out_folder: str) -> None:
    from PIL import Image

    os.makedirs(os.path.join(out_folder, scene_dir), exist_ok=True)
    Image.fromarray(convert_rgb_black_border(img)).save(
        os.path.join(out_folder, scene_dir, f"rgb_{idx:05d}.jpg"), quality=95)
    Image.fromarray(convert_depth_mm(depth_raw_m), mode="I;16").save(
        os.path.join(out_folder, scene_dir, f"sync_depth_{idx:05d}.png"))


def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        print(__doc__)
        sys.exit(1)
    mat_path, splits_path, out_dir = argv

    import h5py
    import scipy.io

    splits = scipy.io.loadmat(splits_path)
    test_1b = set(int(x) for x in splits["testNdxs"].reshape(-1))
    train_1b = set(int(x) for x in splits["trainNdxs"].reshape(-1))

    with h5py.File(mat_path, "r") as f:
        images = f["images"]  # [N, 3, W, H]: h5py reverses MATLAB's axes
        depths = f["rawDepths"]  # [N, W, H], raw, not inpainted
        names_ref = f["sceneTypes"][0]
        n = images.shape[0]
        for i in range(n):
            if (i + 1) in train_1b:
                sub = "train"
            else:
                assert (i + 1) in test_1b, f"index {i + 1} neither in training nor in test set"
                sub = "test"
            scene = "".join(chr(int(c)) for c in f[names_ref[i]][:].reshape(-1))
            img = np.transpose(np.asarray(images[i]), (2, 1, 0))  # -> H, W, 3
            dep = np.transpose(np.asarray(depths[i]), (1, 0))  # -> H, W
            convert_image(i, os.path.join(sub, scene), dep, img, out_dir)
            if i % 100 == 0:
                print(f"{i}/{n}")
    print(f"done -> {out_dir}")


if __name__ == "__main__":
    main()
