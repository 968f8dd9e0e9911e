"""ctypes bindings of the native KD-split merge subsampler and the
minimal-extents pass (``native/subsampling.cpp``, a plain C interface) —
the port's own copy of ``gs_init_tpu/native/subsampling.py``.

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
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.mdi_subsample_pointcloud_ex.restype = ctypes.c_int64
            lib.mdi_subsample_pointcloud_ex.argtypes = [
                f32p, f32p, f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_int, f32p, f32p,
            ]
            lib.mdi_compute_min_extents.restype = None
            lib.mdi_compute_min_extents.argtypes = [
                f32p, ctypes.c_int64, f32p, f32p, i32p, i32p, ctypes.c_int64, f32p,
            ]
            _LIB = lib
        return _LIB


# The codes of mdi_subsample_pointcloud_ex's split_strategy (native/subsampling.cpp).
SPLIT_STRATEGIES = {"spatial_median": 0, "equal_num_pts": 1, "max_gap": 2}


def compute_min_extents(
    positions: np.ndarray,  # [N, 3]
    viewmats: np.ndarray,  # [C, 4, 4] world -> camera
    Ks: np.ndarray,  # [C, 3, 3]
    widths,
    heights,
) -> np.ndarray:
    """Each point's minimal world-space extent, 2 z / min(fx, fy) over the
    cameras that see it (in front, inside the image); -1 where none does."""
    lib = _load()
    positions = np.ascontiguousarray(positions, np.float32)
    if positions.ndim != 2 or positions.shape[1] != 3:
        raise ValueError(f"positions must be [N, 3], got {positions.shape}")
    vm = np.ascontiguousarray(viewmats, np.float32).reshape(-1, 16)
    ks = np.ascontiguousarray(Ks, np.float32).reshape(-1, 9)
    w = np.ascontiguousarray(widths, np.int32).reshape(-1)
    h = np.ascontiguousarray(heights, np.int32).reshape(-1)
    if not len(vm) == len(ks) == len(w) == len(h):
        raise ValueError("viewmats, Ks, widths and heights must have one entry per camera")
    out = np.empty(len(positions), np.float32)
    lib.mdi_compute_min_extents(positions, len(positions), vm, ks, w, h, len(vm), out)
    return out


def subsample_pointcloud(
    positions: np.ndarray,
    rgbs: np.ndarray,
    min_extents: np.ndarray,
    max_aspect_ratio: float = 1.1,
    extent_multiplier: float = 1.0,
    split_strategy: str = "spatial_median",
) -> Tuple[np.ndarray, np.ndarray]:
    """KD-split merge: leaves whose tight box is small against the points'
    minimal extents merge to their centroid (positions and colours). Nodes
    split at the spatial median (the reference's default), at the median
    point (``equal_num_pts``) or at the widest gap between points
    (``max_gap``, spatial median where no gap stands out)."""
    if split_strategy not in SPLIT_STRATEGIES:
        raise ValueError(f"split_strategy must be one of {sorted(SPLIT_STRATEGIES)}, got {split_strategy!r}")
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
    m = lib.mdi_subsample_pointcloud_ex(
        positions, rgbs, ext, n, float(max_aspect_ratio), float(extent_multiplier),
        SPLIT_STRATEGIES[split_strategy], out_p, out_c,
    )
    return out_p[:m].copy(), out_c[:m].copy()
