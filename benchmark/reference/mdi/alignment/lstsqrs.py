"""Closed-form scale and shift depth alignment (MiDaS eq. 2-5, arXiv
1907.01341) with per-point weights — port of
``gs_init_tpu/mdi/alignment/lstsqrs.py``.

The normal equations are summed and solved in float64. In float32 (as
the JAX package sums them) the determinant cancels on correspondences of
narrow depth range: a SLIC region on one surface patch, 2.5 m +- 5 cm,
comes out with its scale up to 8% off, +- 5 mm with it 2.8x off, and two
devices' summation orders disagree by as much."""
from __future__ import annotations

import torch


def weighted_scale_shift(pred: torch.Tensor, gt: torch.Tensor, w: torch.Tensor):
    """Solve min sum w (s pred + t - gt)^2 over the last axis. Returns
    (s, t) over the leading axes, in the inputs' dtype; a degenerate
    system gives (1, 0)."""
    dtype = pred.dtype
    pred, gt, w = pred.double(), gt.double(), w.double()
    a00 = (w * pred * pred).sum(-1)
    a01 = (w * pred).sum(-1)
    a11 = w.sum(-1)
    b0 = (w * pred * gt).sum(-1)
    b1 = (w * gt).sum(-1)
    det = a00 * a11 - a01 * a01
    ok = det.abs() > 1e-12
    det_safe = torch.where(ok, det, torch.ones_like(det))
    s = (a11 * b0 - a01 * b1) / det_safe
    t = (a00 * b1 - a01 * b0) / det_safe
    s = torch.where(ok, s, torch.ones_like(s))
    t = torch.where(ok, t, torch.zeros_like(t))
    return s.to(dtype), t.to(dtype)


def align_lstsqrs(depth_map: torch.Tensor, pred: torch.Tensor, gt: torch.Tensor, w: torch.Tensor):
    """Align a whole depth map from sparse correspondences."""
    s, t = weighted_scale_shift(pred, gt, w)
    return depth_map * s + t, (s, t)
