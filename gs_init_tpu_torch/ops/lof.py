"""Local Outlier Factor — port of ``gs_init_tpu/ops/lof.py``:

  k-dist(o)     = distance to o's k-th neighbour
  reach_k(p, o) = max(k-dist(o), d(p, o))
  lrd(p)        = 1 / mean_o reach_k(p, o)
  LOF(p)        = mean_o lrd(o) / lrd(p)

Scores near 1 are inliers; an explicit threshold marks outliers. The
neighbours come from the bounded block search ``ops/knn.knn_self``, the
brute force's neighbours without its [N, N] work (the JAX package scans
every pair).
"""
from __future__ import annotations

import torch

from .knn import knn_self


def lof_scores(points: torch.Tensor, k: int = 40, chunk: int = 2048) -> torch.Tensor:
    """LOF score per point, [N]."""
    d, idx = knn_self(points, k + 1, chunk=chunk)
    d, idx = d[:, 1:], idx[:, 1:]  # strict neighbours: column 0 is the point itself
    kdist = d[:, -1]
    reach = torch.maximum(kdist[idx], d)
    lrd = 1.0 / torch.clamp(reach.mean(1), min=1e-12)
    return lrd[idx].mean(1) / lrd


def lof_inlier_mask(
    points: torch.Tensor, k: int = 40, threshold: float = 1.5, chunk: int = 2048
) -> torch.Tensor:
    return lof_scores(points, k=k, chunk=chunk) <= threshold
