"""Interpolated (spatially varying scale) depth alignment — port of
``gs_init_tpu/mdi/alignment/interp.py``.

Pre-align globally (RANSAC, MSAC or least squares), take the per-SfM-point
scale factors gt / prealigned, drop scale outliers (kNN median and LOF),
interpolate a dense scale map (Delaunay with scipy on the host, or a
thin-plate RBF on the device) on a coarse grid, upsample it bilinearly and
multiply. When interpolation fails the median factor is the scale.
Host numpy in and out; the RANSAC, the neighbour searches, LOF and TPS run
on ``device``.

Two repairs keep an image with 10^4-10^5 correspondences within bounds,
with the JAX function's results: the pixel neighbours of the scale-outlier
test come from the bounded search ``ops/knn.knn_self`` where the JAX
package sorts an [M, M] distance matrix on the host (12.8 GB at M =
40,000), and the TPS is fitted on the ``max_rbf_points`` kept centres
alone where the JAX package solves an [M, M] system whose other rows are
identity rows with zero weight.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ...ops.knn import knn_self
from ...ops.lof import lof_scores
from ...ops.rbf import tps_interpolate_grid, upsample_bilinear
from .lstsqrs import weighted_scale_shift
from .ransac import ransac_scale_shift

_LOGGER = logging.getLogger(__name__)


def _scale_outliers(
    pix: np.ndarray,  # [M, 2]
    factors: np.ndarray,  # [M]
    valid: np.ndarray,
    knn_k: int = 8,
    knn_threshold: float = 2.0,
    lof_k: int = 20,
    lof_threshold: float = 1.5,
    device=None,
) -> np.ndarray:
    """Inlier mask for per-point scale factors (kNN median, then LOF)."""
    idx = np.where(valid)[0]
    if len(idx) < max(knn_k, lof_k) + 2:
        return valid
    p = pix[idx]
    f = factors[idx]
    # The knn_k nearest other pixels, in float64 about the centroid: only
    # pixels whose distances tie in the JAX package's float32 [M, M] matrix
    # may come in another order than its sort.
    q64 = p.astype(np.float64)
    q = torch.as_tensor(q64 - q64.mean(0), device=device)
    nn = knn_self(q, knn_k + 1)[1][:, 1:].cpu().numpy()
    med = np.median(f[nn], axis=1)
    mad = np.median(np.abs(f[nn] - med[:, None]), axis=1) + 1e-6
    keep = np.abs(f - med) <= knn_threshold * 3.0 * mad
    # LOF over (x, y, factor) with normalised coordinates.
    feats = np.concatenate(
        [p / max(p.max(), 1.0), f[:, None] / max(np.median(np.abs(f)), 1e-6)], axis=1
    ).astype(np.float32)
    scores = lof_scores(torch.as_tensor(feats, device=device), k=min(lof_k, len(idx) - 2))
    keep &= scores.cpu().numpy() <= lof_threshold
    out = valid.copy()
    out[idx] = keep
    return out


def _delaunay_scale_map(
    pix: np.ndarray, factors: np.ndarray, h: int, w: int, grid_width: int
) -> np.ndarray:
    """Piecewise-linear scale map over the Delaunay triangulation of the
    inliers, with the image corners at the median factor so the hull covers
    the frame; evaluated on a coarse grid, then bilinearly upsampled."""
    from scipy.interpolate import LinearNDInterpolator

    med = float(np.median(factors))
    corners = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]], np.float32)
    pts = np.concatenate([pix, corners])
    vals = np.concatenate([factors, np.full(4, med, np.float32)])
    interp = LinearNDInterpolator(pts, vals, fill_value=med)
    gw = min(grid_width, w)
    gh = max(int(round(h * gw / w)), 1)
    xs = (np.arange(gw) + 0.5) * (w / gw)
    ys = (np.arange(gh) + 0.5) * (h / gh)
    gx, gy = np.meshgrid(xs, ys)
    coarse = interp(np.stack([gx.ravel(), gy.ravel()], -1)).reshape(gh, gw)
    return upsample_bilinear(torch.as_tensor(coarse, dtype=torch.float32), h, w).numpy()


def align_interpolate(
    pred_depth: np.ndarray,  # [H, W]
    pred_at: np.ndarray,  # [M] predicted depth at the correspondences
    gt: np.ndarray,  # [M]
    pix: np.ndarray,  # [M, 2]
    valid: np.ndarray,  # [M]
    cfg,  # DepthAlignmentConfig
    *,
    generator: Optional[torch.Generator] = None,  # RANSAC pre-alignment draws
    idx: Optional[torch.Tensor] = None,  # or its sample indices
    rbf_seed: int = 0,  # seeds the max_rbf_points subset
    device=None,
) -> np.ndarray:
    """Returns the aligned depth [H, W]."""
    h, w = pred_depth.shape
    icfg = cfg.interp
    T = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x), dtype=dt, device=device)
    if icfg.prealign == "lstsqrs":
        s, t = weighted_scale_shift(T(pred_at), T(gt), T(valid))
    else:
        s, t, _ = ransac_scale_shift(
            T(pred_at), T(gt), T(valid, torch.bool), idx=idx, generator=generator,
            inlier_threshold=cfg.ransac.inlier_threshold,
            num_hyp=cfg.ransac.max_iterations, sample_size=cfg.ransac.sample_size,
            msac=(icfg.prealign == "msac"),
        )
    s, t = float(s), float(t)

    prealigned_at = s * pred_at + t
    factors = np.where(
        valid & (np.abs(prealigned_at) > 1e-8), gt / np.maximum(prealigned_at, 1e-8), 1.0
    )
    if icfg.scale_outlier_removal:
        keep = _scale_outliers(
            pix, factors, valid & (prealigned_at > 0),
            knn_k=icfg.knn_median_neighbors, knn_threshold=icfg.knn_median_threshold,
            lof_k=icfg.lof_neighbors, lof_threshold=icfg.lof_threshold, device=device,
        )
    else:
        keep = valid & (prealigned_at > 0)
    try:
        if keep.sum() < 8:
            raise ValueError(f"too few scale inliers ({int(keep.sum())})")
        if icfg.method == "delaunay":
            scale_map = _delaunay_scale_map(pix[keep], factors[keep], h, w, icfg.rbf_grid_width)
        else:
            if icfg.kernel != "thin_plate_spline":
                raise NotImplementedError(
                    f"RBF kernel {icfg.kernel!r} not implemented (ops/rbf.py is thin_plate_spline only)"
                )
            if 0 < icfg.max_rbf_points < int(keep.sum()):
                # Cap the dense O(M^3) solve: a uniform random subset.
                sel = np.where(keep)[0]
                drop = np.random.default_rng(rbf_seed).choice(
                    sel, size=len(sel) - icfg.max_rbf_points, replace=False
                )
                keep = keep.copy()
                keep[drop] = False
            scale_map = tps_interpolate_grid(
                T(pix), T(factors), T(keep, torch.bool), h, w,
                grid_width=icfg.rbf_grid_width, smoothing=icfg.smoothing,
            ).cpu().numpy()
        if not np.isfinite(scale_map).all():
            raise ValueError("non-finite scale map")
        # Guard against wild extrapolation far from the correspondences.
        lo, hi = np.percentile(factors[keep], [1, 99])
        scale_map = np.clip(scale_map, min(lo, 0.5), max(hi, 2.0))
    except (ValueError, RuntimeError) as e:  # scipy's QhullError and a failed solve too
        _LOGGER.warning("scale-map interpolation failed (%s); median fallback", e)
        med = float(np.median(factors[keep])) if keep.any() else 1.0
        scale_map = np.full((h, w), med, np.float32)
    return (s * pred_depth + t) * scale_map
