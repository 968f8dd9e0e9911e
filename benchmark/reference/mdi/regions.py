"""Region-wise alignment, as the port's pipeline runs it with a segmenter
(frozen copies of ``gs_init_tpu_torch/mdi/segmentation.py``'s
``merge_regions`` and ``region_margin_mask`` and of
``gs_init_tpu_torch/mdi/alignment/pipeline.py``'s region loop, RANSAC and
MSAC only): weakly separated or SfM-poor regions merge into a neighbour,
SfM points in a margin around the borders stay out of the fits, and each
region with enough points gets its own scale and shift; the others stay at
the invalid sentinel and are masked out.
"""
from __future__ import annotations

import numpy as np
import torch

from .alignment.ransac import ransac_scale_shift

INVALID_DEPTH = -42.0


def merge_regions(labels, depth, sfm_xy, gradient_threshold=5e-4, min_sfm_points=5, max_iters=200):
    h, w = labels.shape
    labels = labels.copy()
    d = depth.astype(np.float64)
    ys = np.clip(sfm_xy[:, 1].astype(int), 0, h - 1)
    xs = np.clip(sfm_xy[:, 0].astype(int), 0, w - 1)
    gh, gv = np.abs(d[:, :-1] - d[:, 1:]), np.abs(d[:-1, :] - d[1:, :])

    def stats():
        # The mean |depth difference| across each border between two
        # regions: horizontal pairs first, each set in row-major order; the
        # borders in the order of their first pixel.
        hs, vs = labels[:, :-1] != labels[:, 1:], labels[:-1, :] != labels[1:, :]
        la = np.concatenate([labels[:, :-1][hs], labels[:-1, :][vs]]).astype(np.int64)
        lb = np.concatenate([labels[:, 1:][hs], labels[1:, :][vs]]).astype(np.int64)
        g = np.concatenate([gh[hs], gv[vs]])
        lo, hi = np.minimum(la, lb), np.maximum(la, lb)
        keys, first, inv = np.unique(lo * (int(hi.max(initial=0)) + 1) + hi, return_index=True,
                                     return_inverse=True)
        sums = np.bincount(inv, weights=g, minlength=len(keys))
        counts = np.bincount(inv, minlength=len(keys))
        return {(lo[j], hi[j]): sums[u] / counts[u] for u, j in sorted(enumerate(first), key=lambda uj: uj[1])}

    for _ in range(max_iters):
        border = stats()
        if not border:
            break
        counts = np.bincount(labels[ys, xs], minlength=labels.max() + 1)
        present = np.flatnonzero(np.bincount(labels.ravel()))
        if len(present) <= 1:
            break
        best_region, best_grad, best_nbr = None, np.inf, None
        for r in present:
            nbrs = [(g, (k[0] if k[1] == r else k[1])) for k, g in border.items() if r in k]
            if not nbrs:
                continue
            g, nbr = min(nbrs)
            if (g < gradient_threshold or counts[r] < min_sfm_points) and g < best_grad:
                best_region, best_grad, best_nbr = r, g, nbr
        if best_region is None:
            break
        labels[labels == best_region] = best_nbr
    _, labels = np.unique(labels, return_inverse=True)
    return labels.reshape(h, w).astype(np.int32)


def region_margin_mask(labels: np.ndarray, margin: float) -> np.ndarray:
    """True away from region borders: where the label map box-blurred over
    2 r + 1 pixels (r = margin scaled by max(H, W) / 1297) equals the label."""
    if margin <= 0:
        return np.ones_like(labels, bool)
    from scipy.ndimage import convolve1d

    h, w = labels.shape
    size = max(int(round(margin * max(h, w) / 1297.0)), 1) * 2 + 1
    lab = labels.astype(np.float64)
    k = np.ones(size) / size
    blurred = convolve1d(convolve1d(lab, k, axis=0, mode="nearest"), k, axis=1, mode="nearest")
    return np.abs(blurred - lab) < 1e-9


def align_regions(pred_depth, pred_mask, labels, sfm_pix, sfm_depth, sfm_valid, st: dict, generator, dev):
    """(merged labels, aligned depth [H, W], mask [H, W], regions fitted) of
    the segmenter's ``labels`` on the host arrays given; RANSAC draws from
    ``generator``, region after region."""
    h, w = pred_depth.shape
    xs = np.clip(sfm_pix[:, 0].astype(int), 0, w - 1)
    ys = np.clip(sfm_pix[:, 1].astype(int), 0, h - 1)
    pred_at = pred_depth[ys, xs]
    valid = np.asarray(sfm_valid) & np.asarray(pred_mask)[ys, xs]
    seg = "mdi.alignment.segmentation."
    labels = merge_regions(labels, pred_depth, sfm_pix[valid], st[seg + "merge_gradient_threshold"],
                           st[seg + "merge_min_sfm_points"])
    margin = st[seg + "region_margin"]
    deadzone = region_margin_mask(labels, margin) if margin > 0 else np.ones((h, w), bool)
    fit_valid = valid & deadzone[ys, xs]
    aligned = np.full((h, w), INVALID_DEPTH, np.float32)
    mask = np.zeros((h, w), bool)
    pt_labels = labels[ys, xs]
    size = st["mdi.alignment.ransac.sample_size"]
    T = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x), dtype=dt, device=dev)
    fitted = 0
    for r in np.unique(labels):
        region_valid = fit_valid & (pt_labels == r)
        if region_valid.sum() < max(size + 1, 4):
            continue
        s, t, _ = ransac_scale_shift(
            T(pred_at), T(sfm_depth), T(region_valid, torch.bool), generator=generator,
            inlier_threshold=st["mdi.alignment.ransac.inlier_threshold"],
            num_hyp=st["mdi.alignment.ransac.max_iterations"], sample_size=size,
            msac=st["mdi.alignment.method"] == "msac",
        )
        sel = labels == r
        aligned[sel] = (np.asarray(pred_depth) * float(s) + float(t))[sel]
        mask[sel] = True
        fitted += 1
    if st[seg + "propagate_mask"]:
        mask &= deadzone
    return labels, aligned, mask & np.asarray(pred_mask), fitted
