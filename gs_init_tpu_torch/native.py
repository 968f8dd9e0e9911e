"""ctypes binding of the native KD-split merge subsampler
(``native/subsampling.cpp``, a plain C interface) — the port's own.

At first use the source is compiled with ``g++ -O3 -std=c++17 -fPIC
-shared -pthread`` into ``gs_init_tpu_torch/_build/`` (git-ignored), named
by a hash of the source and flags, and loaded. A failed build raises with
the compiler's output: there is no fallback to another merge.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "subsampling.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_LIB = None
_LOCK = threading.Lock()


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmdi_native-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path."""
    out = lib_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build native/subsampling.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(
        [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True, text=True
    )
    if res.returncode != 0:
        raise RuntimeError(f"building native/subsampling.cpp failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders each write their own tmp
    return out


def _load():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            lib.mdi_subsample_pointcloud.restype = ctypes.c_int64
            lib.mdi_subsample_pointcloud.argtypes = [
                f32p, f32p, f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_float, f32p, f32p,
            ]
            _LIB = lib
        return _LIB


def subsample_pointcloud(
    positions: np.ndarray,
    rgbs: np.ndarray,
    min_extents: np.ndarray,
    max_aspect_ratio: float = 1.1,
    extent_multiplier: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """KD-split merge with spatial-median splits (the reference's default):
    leaves whose tight box is small against the points' minimal extents
    merge to their centroid (positions and colours)."""
    lib = _load()
    positions = np.ascontiguousarray(positions, np.float32)
    rgbs = np.ascontiguousarray(rgbs, np.float32)
    ext = np.ascontiguousarray(min_extents, np.float32)
    if positions.ndim != 2 or positions.shape[1] != 3:
        raise ValueError(f"positions must be [N, 3], got {positions.shape}")
    if rgbs.shape != positions.shape or ext.shape != (len(positions),):
        raise ValueError("rgbs must match positions, and min_extents have one value per point")
    n = len(positions)
    out_p = np.empty((n, 3), np.float32)
    out_c = np.empty((n, 3), np.float32)
    m = lib.mdi_subsample_pointcloud(
        positions, rgbs, ext, n, float(max_aspect_ratio), float(extent_multiplier), out_p, out_c
    )
    return out_p[:m].copy(), out_c[:m].copy()
