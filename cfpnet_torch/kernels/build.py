"""Build and load the CUDA kernels of ``cfpnet_torch/csrc``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). Libraries go into ``cfpnet_torch/_build/`` at first
use, named by a digest of the source, the headers of ``csrc/`` it includes
(``#include "..."``, followed through headers that include others) and the
flags, so a changed source or header is rebuilt and a stale library is
never loaded. ``build()`` starts one ``nvcc``
per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("linear_attention", "dwconv", "fused_loftr", "fused_loftr_bf16", "bn_act")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas resource report (registers, shared memory, spills) of each build
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME)")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: Dict[Path, bytes]) -> None:
    """``path`` and the files of ``csrc/`` it includes, depth first, once each."""
    if path in seen:
        return
    text = seen[path] = path.read_bytes()
    for name in _LOCAL_INCLUDE.findall(text):
        header = path.parent / name.decode()
        if header.is_file():
            _sources(header.resolve(), seen)


def nvcc_flags(name: str) -> Tuple[str, ...]:
    """The flags ``csrc/<name>.cu`` is built with: NVCC_FLAGS, and for the
    depthwise conv the tiling of ``kernels/dwconv.py::TILING``."""
    if name == "dwconv":
        from .dwconv import nvcc_defines

        return NVCC_FLAGS + nvcc_defines()
    return NVCC_FLAGS


def library_path(name: str) -> Path:
    seen: Dict[Path, bytes] = {}
    _sources((CSRC_DIR / f"{name}.cu").resolve(), seen)
    h = hashlib.sha256(" ".join(nvcc_flags(name)).encode())
    for text in seen.values():
        h.update(text)
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every library of ``names`` that is not built yet, one ``nvcc``
    process per source, all started together. Returns the seconds each build
    took (0.0 when it was already built). Raises with the compiler's output
    if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *nvcc_flags(name), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
