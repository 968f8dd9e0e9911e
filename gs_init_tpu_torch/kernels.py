"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, compiled by ``nvcc`` for ``sm_90a`` at first use on a CUDA device
and loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
All sources compile in parallel, one ``nvcc`` process each. Libraries go to
``gs_init_tpu_torch/_build/`` (git-ignored), named by a hash of the sources
and flags, so an edited source never loads a stale library.

Every C entry point takes device pointers and the CUDA stream as
``c_void_p`` (the stream last) and returns ``cudaGetLastError()`` after its
launch. ``launch`` is the one way the wrappers start a kernel: it passes the
current stream, raises on a non-zero code (``check``) and counts the launch
in ``LAUNCHES``, so a run can show that its path went through the kernels.
With the tracer on (``trace.py``) ``build`` is the span ``kernels.build``.

Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from . import trace

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> (source file, argtypes of the C entry point of the same name)
KERNELS = {
    "composite_fwd": (
        "composite_fwd.cu",
        # table, gid_sorted, tile_starts, order, out,
        # num_tiles, ntx, nty, tile, chunk, stream
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "composite_bwd": (
        "composite_bwd.cu",
        # table, gid_sorted, tile_starts, order, fwd_out, g_out, dtable,
        # absgrad, num_tiles, ntx, nty, tile, chunk, want_absgrad, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    ),
    "scan_probe": (
        "scan_probe.cu",
        # x, m, sum, prod, n, p, stream
        [_P, _P, _P, _P, _I, _I, _P],
    ),
    "project_pack_fwd": (
        "project_pack_fwd.cu",
        # means, quats, scales, opacities, colors, sh_mask, alive, viewmats,
        # Ks, table, radii, extents, n, c, width, height, camera,
        # antialiased, bases, coefs, color_stride, near, far, eps2d,
        # radius_clip, stream
        [_P] * 12 + [_I] * 9 + [_F] * 4 + [_P],
    ),
    "project_pack_bwd": (
        "project_pack_bwd.cu",
        # means, quats, scales, opacities, colors, sh_mask, viewmats, Ks,
        # dtable, dmeans, dquats, dscales, dopacities, dcolors, dviewmats,
        # n, c, width, height, camera, antialiased, bases, coefs,
        # color_stride, near, eps2d, stream
        [_P] * 15 + [_I] * 9 + [_F] * 2 + [_P],
    ),
    "ssim_fwd": (
        "ssim_fwd.cu",
        # img0, img1, strides (host), window (host), maps, sums, out, nsums,
        # b, h, w, c, c1, c2, stream
        [_P] * 7 + [_I] * 5 + [_F] * 2 + [_P],
    ),
    "ssim_bwd": (
        "ssim_bwd.cu",
        # img0, img1, strides (host), window (host, reversed), maps, grad, dx,
        # b, h, w, c, inv_count, c1, c2, stream
        [_P] * 7 + [_I] * 4 + [_F] * 3 + [_P],
    ),
}
# Flags of one library beyond NVCC_FLAGS. K4's radii and extents feed the
# binning, so its arithmetic rounds as the plain ops do: no contraction of
# a multiply and an add into one FMA (explicit fmaf calls stay); K5
# recomputes K4's intermediates, so it rounds them the same way. K6 / K7
# round each product and sum of the blur, the formula and its backward on
# its own, as the plain twins' torch ops do, so their maps and gradient
# equal the twins'.
EXTRA_FLAGS = {
    name: ("-fmad=false",)
    for name in ("project_pack_fwd", "project_pack_bwd", "ssim_fwd", "ssim_bwd")
}

LAUNCHES = {name: 0 for name in KERNELS}
# name -> ptxas/nvcc output of its build (registers, shared memory, spills)
BUILD_LOG: dict = {}

_LIBS: dict = {}
_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of gs_init_tpu_torch are built from csrc/ at first use"
        )
    return path


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _lib_path(name: str) -> Path:
    src, _ = KERNELS[name]
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / src]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


@trace.spanned("kernels.build", device=False)
def build(names=None) -> dict:
    """Compile the named kernels (all by default) that have no library yet,
    one ``nvcc`` each, all started together. Returns seconds per build."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not _lib_path(n).exists()]
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(n), "-o", str(tmp), str(CSRC / KERNELS[n][0])]
        procs[n] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
        )
    seconds = {}
    errors = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        BUILD_LOG[n] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {KERNELS[n][0]}:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def function(name: str):
    """The ctypes entry point ``name`` of its built library."""
    with _LOCK:
        if name not in _LIBS:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            fn = getattr(lib, name)
            fn.argtypes = KERNELS[name][1]
            fn.restype = ctypes.c_int
            err = lib.gs_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _LIBS[name] = (lib, fn, err)
        return _LIBS[name][1]


def check(name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = _LIBS[name][2](code).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({code})")


def launch(name: str, stream_of: torch.Tensor, *args) -> None:
    """Launch kernel ``name`` with ``args`` on the current stream of
    ``stream_of``'s device; raise if the launch failed, else count it."""
    code = function(name)(*args, torch.cuda.current_stream(stream_of.device).cuda_stream)
    check(name, code)
    LAUNCHES[name] += 1
