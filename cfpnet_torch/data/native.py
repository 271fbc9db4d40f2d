"""ctypes binding of the host ToF kernel (``csrc/host/tofsim.cpp``).

Port of ``cfpnet_tpu/data/native.py`` (``get_lib``, ``native_get_hist``,
``native_sample_uniform``) with its own copy of the C++ source. The library
is built with ``g++`` at first use into ``cfpnet_torch/_build/``, named by a
digest of the source and the flags, so a changed source is rebuilt. Callers
fall back to the vectorized numpy path of ``tof_sim.py`` when the library
cannot be built or ``CFPNET_NATIVE_TOFSIM=0``; ``active()`` says which path
runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "host" / "tofsim.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_LIB = None
_TRIED = False


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libtofsim_{digest[:16]}.so"


def _build() -> Optional[Path]:
    """The library, built if missing (into a temporary name, then renamed, so
    that processes building at once never load a partial file); None when
    ``g++`` is missing or fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def get_lib():
    """The loaded library, or None (numpy path)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("CFPNET_NATIVE_TOFSIM", "1") == "0":
        return None
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.tof_get_hist.restype = ctypes.c_int
    lib.tof_get_hist.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        f32p, u8p,
    ]
    lib.tof_sample_uniform.restype = None
    lib.tof_sample_uniform.argtypes = [f32p, u8p, ctypes.c_int, ctypes.c_int, f32p]
    _LIB = lib
    return _LIB


def active() -> str:
    """'native' when ``tof_sim.get_hist`` runs the C++ kernel, else 'numpy'."""
    return "native" if get_lib() is not None else "numpy"


def native_get_hist(depth: np.ndarray, geom, max_distance: float, bin_width: float,
                    noise_floor: float) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(fh, mask) via the C++ kernel, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    depth = np.ascontiguousarray(depth, np.float32)
    Z = geom.zone_num * geom.zone_num
    fh = np.empty((Z, 2), np.float32)
    mask = np.empty((Z,), np.uint8)
    rc = lib.tof_get_hist(
        depth, depth.shape[0], depth.shape[1],
        geom.sy_px, geom.sx_px, geom.zone_num, geom.patch_px_h, geom.patch_px_w,
        np.float32(max_distance), np.float32(bin_width), np.float32(noise_floor),
        fh, mask,
    )
    if rc != 0:
        return None
    return fh, mask.astype(bool)


def native_sample_uniform(fh: np.ndarray, mask: np.ndarray, nsamples: int):
    """Uniform mu±3sigma samples of each valid zone via the C++ kernel, or None."""
    lib = get_lib()
    if lib is None:
        return None
    fh = np.ascontiguousarray(fh, np.float32)
    m = np.ascontiguousarray(mask.astype(np.uint8))
    out = np.empty((fh.shape[0], nsamples), np.float32)
    lib.tof_sample_uniform(fh, m, fh.shape[0], nsamples, out)
    return out
