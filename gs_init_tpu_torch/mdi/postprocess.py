"""Point-cloud postprocessing: LOF outlier removal and merge subsampling —
port of ``gs_init_tpu/mdi/postprocess.py``.

The merge has two implementations:
- "native": the exact KD-split merge in C++ (``native/subsampling.cpp``
  through the port's own binding, ``gs_init_tpu_torch/native.py``). If it
  cannot be built, it raises: it does not fall back to the voxel merge.
- "voxel": points merged to voxel centroids, the voxel sized by the mean
  minimal gaussian extent (numpy on the host).
LOF and the minimal extents run on ``device``.
"""
from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from .. import trace
from ..ops.lof import lof_inlier_mask

# Points per block of compute_minimal_gaussian_extents: [C, 65536, 3] float32
# is 127 MB at 162 cameras.
EXTENT_BLOCK = 1 << 16


def lof_outlier_removal(
    pts: np.ndarray, rgbs: np.ndarray, k: int = 40, threshold: float = 1.5, device=None
) -> Tuple[np.ndarray, np.ndarray]:
    mask = lof_inlier_mask(torch.as_tensor(pts, device=device), k=k, threshold=threshold)
    mask = mask.cpu().numpy()
    return pts[mask], rgbs[mask]


def compute_minimal_gaussian_extents(
    pts: np.ndarray,  # [N, 3]
    viewmats: np.ndarray,  # [C, 4, 4]
    Ks: np.ndarray,  # [C, 3, 3]
    widths,
    heights,
    device=None,
) -> np.ndarray:
    """World-space sampling interval per point: the minimum over the
    cameras that see it of 2 depth / min(fx, fy); -1 where none does.
    EXTENT_BLOCK points at a time, so the [C, block, 3] temporaries bound
    the peak whatever N (the JAX function holds [C, N, 3]: 3.3 GB each at
    162 cameras and 1.68M points); each point's result is the same."""
    T = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    vm, K = T(viewmats), T(Ks)
    f = torch.minimum(K[:, 0, 0], K[:, 1, 1])[:, None]
    w, h = T(widths)[:, None], T(heights)[:, None]
    out = []
    for s in range(0, len(pts), EXTENT_BLOCK):
        p = T(pts[s : s + EXTENT_BLOCK])
        cam = torch.einsum("cij,nj->cni", vm[:, :3, :3], p) + vm[:, None, :3, 3]
        z = cam[..., 2]
        uv = cam[..., :2] / torch.clamp(z[..., None], min=1e-8)
        pix = torch.einsum("cni,cij->cnj", uv, K[:, :2, :2].transpose(1, 2)) + K[:, None, :2, 2]
        seen = (z > 0) & (pix[..., 0] >= 0) & (pix[..., 0] < w) & (pix[..., 1] >= 0) & (pix[..., 1] < h)
        best = torch.where(seen, 2.0 * z / f, torch.full_like(z, float("inf"))).amin(0)
        out.append(torch.where(torch.isfinite(best), best, torch.full_like(best, -1.0)))
    if not out:
        return np.zeros(0, np.float32)
    return torch.cat(out).cpu().numpy()


def voxel_merge_subsample(
    pts: np.ndarray, rgbs: np.ndarray, extents: np.ndarray, extent_multiplier: float = 1.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge points into voxel centroids; the voxel side is the mean minimal
    extent of the observed points times ``extent_multiplier``."""
    observed = extents > 0
    if not observed.any():
        return pts, rgbs
    vox = float(np.mean(extents[observed])) * extent_multiplier
    if vox <= 0:
        return pts, rgbs
    keys = np.floor(pts / vox).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    n = len(uniq)
    sums = np.zeros((n, 3), np.float64)
    np.add.at(sums, inv, pts)
    csums = np.zeros((n, 3), np.float64)
    np.add.at(csums, inv, rgbs)
    counts = np.bincount(inv, minlength=n)[:, None]
    return (sums / counts).astype(np.float32), (csums / counts).astype(np.float32)


def native_merge_subsample(
    pts: np.ndarray,
    rgbs: np.ndarray,
    extents: np.ndarray,
    max_aspect_ratio: float = 1.1,
    extent_multiplier: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """The exact KD-split merge (raises if the library cannot be built)."""
    from .. import native

    return native.subsample_pointcloud(pts, rgbs, extents, max_aspect_ratio, extent_multiplier)


@trace.spanned("init.postprocess")
def postprocess_point_cloud(cfg, pts, rgbs, viewmats, Ks, widths, heights, device=None, timings=None):
    """LOF removal, then the merge, as configured. ``timings``, when given,
    receives each stage's seconds and point count after it (``lof``,
    ``extents``, ``merge``): every stage ends on the host, so the clock
    reads what the device took."""
    pp = cfg.mdi.postprocess
    now = time.perf_counter
    if pp.lof_outlier_removal:
        t0 = now()
        pts, rgbs = lof_outlier_removal(pts, rgbs, k=pp.lof_neighbors, device=device)
        if timings is not None:
            timings["lof"] = (now() - t0, len(pts))
    if pp.merge_subsample:
        t0, n_in = now(), len(pts)
        extents = compute_minimal_gaussian_extents(pts, viewmats, Ks, widths, heights, device)
        t1 = now()
        if pp.merge_impl == "native":
            pts, rgbs = native_merge_subsample(
                pts, rgbs, extents, pp.merge_max_aspect_ratio, pp.merge_extent_multiplier
            )
        else:
            pts, rgbs = voxel_merge_subsample(pts, rgbs, extents, pp.merge_extent_multiplier)
        if timings is not None:
            timings["extents"] = (t1 - t0, n_in)
            timings["merge"] = (now() - t1, len(pts))
    return pts, rgbs
