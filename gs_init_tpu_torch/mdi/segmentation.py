"""Depth-map segmentation for region-wise alignment — the port's own copy
of ``gs_init_tpu/mdi/segmentation.py`` (numpy and scipy, on the host):

- SLIC superpixels over the normalised depth map (n_segments 40,
  compactness 0.01);
- region merging: regions with weak border depth gradients or too few
  interior SfM points dissolve into their best-connected neighbour
  (thresholds 5e-4 and 5 points);
- a margin mask around region borders by the box-blur trick.

Segmentation runs once per image at init time. (SAM segmentation needs its
weights and comes with the depth networks.)
"""
from __future__ import annotations

import numpy as np


def slic_depth(
    depth: np.ndarray,  # [H, W]
    mask: np.ndarray,  # [H, W] validity
    n_segments: int = 40,
    compactness: float = 0.01,
    n_iters: int = 10,
) -> np.ndarray:
    """SLIC superpixels on the normalized depth map. Returns labels [H, W]
    (0..K-1; invalid pixels get the nearest region label)."""
    h, w = depth.shape
    d = depth.astype(np.float64).copy()
    dmin, dmax = d[mask].min() if mask.any() else 0.0, d[mask].max() if mask.any() else 1.0
    d = (d - dmin) / max(dmax - dmin, 1e-12)
    d[~mask] = 0.5

    s = int(np.sqrt(h * w / n_segments)) or 1
    cy = np.arange(s // 2, h, s)
    cx = np.arange(s // 2, w, s)
    centers = np.array([(y, x, d[y, x]) for y in cy for x in cx], np.float64)
    k = len(centers)

    ys, xs = np.arange(h), np.arange(w)
    labels = np.zeros((h, w), np.int32)
    dists = np.full((h, w), np.inf)
    flat_y, flat_x, flat_d = np.repeat(ys, w), np.tile(xs, h), d.ravel()
    # Spatial normalization: ds/s; feature weight 1/compactness as in skimage
    # (compactness trades color-vs-space; small => follow depth).
    for _ in range(n_iters):
        dists.fill(np.inf)
        for i, (yc, xc, fc) in enumerate(centers):
            y0, y1 = max(int(yc) - s, 0), min(int(yc) + s + 1, h)
            x0, x1 = max(int(xc) - s, 0), min(int(xc) + s + 1, w)
            # Each pixel's terms as the JAX package forms them, the spatial
            # ones per row and column.
            dy = (ys[y0:y1] - yc) / s
            dx = (xs[x0:x1] - xc) / s
            df = (d[y0:y1, x0:x1] - fc) / max(compactness, 1e-12)
            dist = df * df + (dy * dy)[:, None] + (dx * dx)[None, :]
            better = dist < dists[y0:y1, x0:x1]
            np.copyto(dists[y0:y1, x0:x1], dist, where=better)
            np.copyto(labels[y0:y1, x0:x1], i, where=better)
        # Each region's mean over its pixels in row-major order, as the
        # boolean selection of the JAX package takes them (a stable sort
        # keeps that order, so the float means are the same).
        by_label = np.argsort(labels.ravel().astype(np.int16 if k < 1 << 15 else np.int32), kind="stable")
        bounds = np.searchsorted(labels.ravel()[by_label], np.arange(k + 1))
        for i in range(k):
            sel = by_label[bounds[i] : bounds[i + 1]]
            if len(sel):
                centers[i] = (flat_y[sel].mean(), flat_x[sel].mean(), flat_d[sel].mean())
    # Compact label ids.
    uniq, labels = np.unique(labels, return_inverse=True)
    return labels.reshape(h, w).astype(np.int32)


def merge_regions(
    labels: np.ndarray,  # [H, W]
    depth: np.ndarray,  # [H, W] normalized depth
    sfm_xy: np.ndarray,  # [M, 2] pixel coords of SfM points
    gradient_threshold: float = 5e-4,
    min_sfm_points: int = 5,
    max_iters: int = 200,
) -> np.ndarray:
    """Dissolve weakly-separated or SfM-poor regions into neighbors.

    Merge criterion per the reference: a region merges when its lowest
    mean-border depth gradient is below threshold OR it contains fewer than
    min_sfm_points; it merges into the neighbor with the smallest shared-
    border gradient.

    The per-pixel sums are numpy reductions; the JAX package's copy loops
    over every border pixel and SfM point in Python. Both sum each border
    in the same pixel order and visit the borders in the order of their
    first pixel, so the labels are the same (NaN depths included, whose
    comparisons depend on that order)."""
    h, w = labels.shape
    labels = labels.copy()
    d = depth.astype(np.float64)
    ys = np.clip(sfm_xy[:, 1].astype(int), 0, h - 1)
    xs = np.clip(sfm_xy[:, 0].astype(int), 0, w - 1)

    # |depth difference| of every horizontal and every vertical pixel pair.
    gh, gv = np.abs(d[:, :-1] - d[:, 1:]), np.abs(d[:-1, :] - d[1:, :])

    def stats():
        # mean |depth difference| across each region boundary; the
        # horizontal pairs first, each set in row-major order
        hs, vs = labels[:, :-1] != labels[:, 1:], labels[:-1, :] != labels[1:, :]
        la = np.concatenate([labels[:, :-1][hs], labels[:-1, :][vs]]).astype(np.int64)
        lb = np.concatenate([labels[:, 1:][hs], labels[1:, :][vs]]).astype(np.int64)
        g = np.concatenate([gh[hs], gv[vs]])
        lo, hi = np.minimum(la, lb), np.maximum(la, lb)
        keys, first, inv = np.unique(lo * (int(hi.max(initial=0)) + 1) + hi, return_index=True,
                                     return_inverse=True)
        sums = np.bincount(inv, weights=g, minlength=len(keys))  # in pixel order, per border
        counts = np.bincount(inv, minlength=len(keys))
        return {(lo[j], hi[j]): sums[u] / counts[u]
                for u, j in sorted(enumerate(first), key=lambda uj: uj[1])}

    for _ in range(max_iters):
        border = stats()
        if not border:
            break
        counts = np.bincount(labels[ys, xs], minlength=labels.max() + 1)
        regions = np.flatnonzero(np.bincount(labels.ravel()))
        if len(regions) <= 1:
            break
        # Candidate: region whose best border gradient is lowest, or with
        # too few SfM points.
        best_region, best_grad, best_nbr = None, np.inf, None
        for r in regions:
            nbrs = [
                (g, (k[0] if k[1] == r else k[1]))
                for k, g in border.items()
                if r in k
            ]
            if not nbrs:
                continue
            g, nbr = min(nbrs)
            few_pts = counts[r] < min_sfm_points
            if (g < gradient_threshold or few_pts) and g < best_grad:
                best_region, best_grad, best_nbr = r, g, nbr
        if best_region is None:
            break
        labels[labels == best_region] = best_nbr
    uniq, labels = np.unique(labels, return_inverse=True)
    return labels.reshape(h, w).astype(np.int32)


def region_margin_mask(labels: np.ndarray, margin: float) -> np.ndarray:
    """True away from region boundaries. Box-blur trick: blur the label map;
    pixels whose blurred value differs from their label are near a boundary.
    Margin is scaled by max(H, W)/1297 as in the reference."""
    if margin <= 0:
        return np.ones_like(labels, bool)
    h, w = labels.shape
    size = max(int(round(margin * max(h, w) / 1297.0)), 1) * 2 + 1
    lab = labels.astype(np.float64)
    k = np.ones(size) / size
    from scipy.ndimage import convolve1d

    blurred = convolve1d(convolve1d(lab, k, axis=0, mode="nearest"), k, axis=1, mode="nearest")
    return np.abs(blurred - lab) < 1e-9
