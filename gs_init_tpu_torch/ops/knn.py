"""Brute-force k-nearest-neighbour distances, chunked over queries.

Port of ``gs_init_tpu/ops/knn.py::mean_knn_dist`` (the reference's kNN
scale initialisation). Squared distances as |x|^2 + |y|^2 - 2 x.y in full
f32 (``torch.matmul`` in f32 does not use TF32 unless enabled globally),
then ``topk`` per query chunk; peak memory is [chunk, N].
"""
from __future__ import annotations

import torch


def knn_sq_dists(points: torch.Tensor, k: int, chunk: int = 2048) -> torch.Tensor:
    """Squared distances [N, k] to the k nearest points (self included)."""
    p_sq = (points * points).sum(-1)
    out = []
    for s in range(0, points.shape[0], chunk):
        q = points[s : s + chunk]
        d2 = (q * q).sum(-1, keepdim=True) - 2.0 * q @ points.T + p_sq[None, :]
        out.append(torch.topk(d2, k, dim=1, largest=False).values.clamp(min=0.0))
    return torch.cat(out, 0)


def mean_knn_dist(points: torch.Tensor, k: int = 3, chunk: int = 2048) -> torch.Tensor:
    """sqrt of the mean squared distance to the k nearest strict neighbours [N]."""
    d2 = knn_sq_dists(points, k + 1, chunk)[:, 1:]
    return torch.sqrt(d2.mean(-1))
