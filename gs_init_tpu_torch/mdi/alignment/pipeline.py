"""Depth alignment pipeline: optional segmentation, then per-region
alignment — port of ``gs_init_tpu/mdi/alignment/pipeline.py``.

With no segmenter the whole image is one region. With SLIC or SAM
(``mdi/segmentation_sam.py``, on the colour-mapped depth and, with
``sam_use_normals``, the normal map), regions are merged (weak borders, few SfM points), SfM points in a margin around the
borders are left out of the fits, and each region is aligned on its own.
The output starts at the INVALID sentinel (-42) and is written per region;
a region with too few points stays invalid and is masked out downstream.
Host orchestration, once per image at init; the fits run on ``device``.
"""
from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from ..segmentation import merge_regions, region_margin_mask, slic_depth
from .interp import align_interpolate
from .lstsqrs import weighted_scale_shift
from .ransac import ransac_scale_shift

_LOGGER = logging.getLogger(__name__)

INVALID_DEPTH = -42.0


def _align_region(pred_depth, pred_at, gt, pix, valid, method, acfg, generator, rbf_seed, device):
    """Align one region; returns the aligned depth over the whole map."""
    T = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x), dtype=dt, device=device)
    if method == "lstsqrs":
        s, t = weighted_scale_shift(T(pred_at), T(gt), T(valid))
        return np.asarray(pred_depth) * float(s) + float(t)
    if method in ("ransac", "msac"):
        s, t, _ = ransac_scale_shift(
            T(pred_at), T(gt), T(valid, torch.bool), generator=generator,
            inlier_threshold=acfg.ransac.inlier_threshold,
            num_hyp=acfg.ransac.max_iterations, sample_size=acfg.ransac.sample_size,
            msac=(method == "msac"),
        )
        return np.asarray(pred_depth) * float(s) + float(t)
    if method == "interpolate":
        return align_interpolate(
            np.asarray(pred_depth), np.asarray(pred_at), np.asarray(gt), np.asarray(pix),
            np.asarray(valid), acfg, generator=generator, rbf_seed=rbf_seed, device=device,
        )
    raise ValueError(f"unknown alignment method {method!r}")


def align_depth(
    pred_depth: np.ndarray,  # [H, W]
    pred_mask: np.ndarray,  # [H, W]
    sfm_pix: np.ndarray,  # [M, 2]
    sfm_depth: np.ndarray,  # [M]
    sfm_valid: np.ndarray,  # [M]
    acfg,  # DepthAlignmentConfig
    *,
    generator: Optional[torch.Generator] = None,  # RANSAC draws, region after region
    rbf_seed: int = 0,  # seeds the max_rbf_points subsets
    device=None,
    normals: Optional[np.ndarray] = None,  # [H, W, 3], for SAM's sam_use_normals
    timings: Optional[dict] = None,
):
    """Returns (aligned depth [H, W], mask [H, W]) as numpy. ``timings``,
    when given and a segmenter is set, receives the seconds of the
    segmentation (``segment``) and of the region merge (``merge``)."""
    h, w = pred_depth.shape
    xs = np.clip(sfm_pix[:, 0].astype(int), 0, w - 1)
    ys = np.clip(sfm_pix[:, 1].astype(int), 0, h - 1)
    pred_at = pred_depth[ys, xs]
    valid = np.asarray(sfm_valid) & np.asarray(pred_mask)[ys, xs]
    region = dict(acfg=acfg, generator=generator, rbf_seed=rbf_seed, device=device)

    seg = acfg.segmentation
    if seg.method is None:
        aligned = _align_region(
            pred_depth, pred_at, sfm_depth, sfm_pix, valid, acfg.method, **region
        )
        return aligned, np.asarray(pred_mask).copy()
    t0 = time.perf_counter()
    if seg.method == "slic":
        labels = slic_depth(
            pred_depth, np.asarray(pred_mask),
            n_segments=seg.slic_n_segments, compactness=seg.slic_compactness,
        )
    elif seg.method == "sam":
        from ..segmentation_sam import segment_depth_sam

        labels = segment_depth_sam(
            pred_depth, np.asarray(pred_mask), normals, seg,
            allow_random_weights=seg.sam_allow_random_weights, device=device,
        )
    else:
        raise NotImplementedError(f"unknown segmenter {seg.method!r}")
    t1 = time.perf_counter()
    labels = merge_regions(
        labels, pred_depth, sfm_pix[valid],
        gradient_threshold=seg.merge_gradient_threshold, min_sfm_points=seg.merge_min_sfm_points,
    )
    if timings is not None:
        timings.update(segment=t1 - t0, merge=time.perf_counter() - t1)
    aligned = np.full((h, w), INVALID_DEPTH, np.float32)
    mask = np.zeros((h, w), bool)
    pt_labels = labels[ys, xs]
    # SfM points in the margin around region borders never enter a fit; the
    # output mask loses the margin only under propagate_mask.
    deadzone = (
        region_margin_mask(labels, seg.region_margin)
        if seg.region_margin > 0
        else np.ones((h, w), bool)
    )
    fit_valid = valid & deadzone[ys, xs]
    min_pts = max(acfg.ransac.sample_size + 1, 4)
    for r in np.unique(labels):
        region_valid = fit_valid & (pt_labels == r)
        sel = labels == r
        if region_valid.sum() < min_pts:
            _LOGGER.debug("region %d dropped (%d pts)", r, region_valid.sum())
            continue
        a = _align_region(
            pred_depth, pred_at, sfm_depth, sfm_pix, region_valid, acfg.method, **region
        )
        aligned[sel] = a[sel]
        mask[sel] = True
    if seg.propagate_mask:
        mask &= deadzone
    mask &= np.asarray(pred_mask)
    return aligned, mask
