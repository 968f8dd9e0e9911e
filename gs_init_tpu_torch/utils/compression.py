"""Compressed splat storage (numpy) — the port's own copy of
``gs_init_tpu/utils/compression.py``, with the same npz layout, so either
package reads the other's files.

Live gaussians are Morton-ordered; means are stored as float16, rotation,
scale, opacity and sh0 as uint8 over per-channel ranges, shN as uint8 over
one global range, all in one compressed npz.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def morton_order(pts: np.ndarray, bits: int = 10) -> np.ndarray:
    """The permutation that puts 3-D points in Z order, each axis quantised
    to 2^bits over its range."""
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    q = ((pts - lo) / np.maximum(hi - lo, 1e-12) * (2**bits - 1)).astype(
        np.uint64
    )

    def spread(x):
        x &= np.uint64(0x3FF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x30000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x300F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x30C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x9249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2)
    )
    return np.argsort(code)


def _quantize(x: np.ndarray, bits: int = 8):
    lo = x.min(axis=0, keepdims=True)
    hi = x.max(axis=0, keepdims=True)
    scale = np.maximum(hi - lo, 1e-12)
    q = np.round((x - lo) / scale * (2**bits - 1))
    dtype = np.uint8 if bits <= 8 else np.uint16
    return q.astype(dtype), lo.astype(np.float32), scale.astype(np.float32)


def _dequantize(q, lo, scale, bits=8):
    return q.astype(np.float32) / (2**bits - 1) * scale + lo


def compress_splats(
    path: str,
    means: np.ndarray,  # [N, 3]
    scales: np.ndarray,  # [N, 3] log
    quats: np.ndarray,  # [N, 4]
    opacities: np.ndarray,  # [N] logit
    sh0: np.ndarray,  # [N, 1, 3]
    shN: np.ndarray,  # [N, K-1, 3]
) -> str:
    order = morton_order(np.asarray(means, np.float32))
    means = np.asarray(means, np.float32)[order]
    quats = np.asarray(quats, np.float32)[order]
    quats /= np.maximum(np.linalg.norm(quats, axis=1, keepdims=True), 1e-12)
    data = {"means": means.astype(np.float16)}
    for name, x, bits in [
        ("scales", np.asarray(scales)[order], 8),
        ("quats", quats, 8),
        ("opacities", np.asarray(opacities)[order][:, None], 8),
        ("sh0", np.asarray(sh0)[order].reshape(len(order), 3), 8),
    ]:
        q, lo, sc = _quantize(x, bits)
        data[name], data[f"{name}_lo"], data[f"{name}_scale"] = q, lo, sc
    n, k1, _ = shN.shape
    flatN = np.asarray(shN)[order].reshape(n, -1)
    # Global range for the high-order SH (small magnitudes).
    glo, ghi = float(flatN.min()), float(flatN.max())
    qn = np.round(
        (flatN - glo) / max(ghi - glo, 1e-12) * 255
    ).astype(np.uint8)
    data["shN"] = qn
    data["shN_range"] = np.array([glo, ghi, k1], np.float32)
    with open(path, "wb") as f:
        np.savez_compressed(f, **data)
    return path


def decompress_splats(path: str) -> Tuple[np.ndarray, ...]:
    z = np.load(path)
    means = z["means"].astype(np.float32)
    out = {}
    for name in ["scales", "quats", "opacities", "sh0"]:
        out[name] = _dequantize(z[name], z[f"{name}_lo"], z[f"{name}_scale"])
    glo, ghi, k1 = z["shN_range"]
    shN = (
        z["shN"].astype(np.float32) / 255.0 * max(ghi - glo, 1e-12) + glo
    ).reshape(len(means), int(k1), 3)
    return (
        means,
        out["scales"],
        out["quats"],
        out["opacities"][:, 0],
        out["sh0"].reshape(len(means), 1, 3),
        shN,
    )
