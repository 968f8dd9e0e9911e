"""Brute-force k-nearest neighbours, chunked for memory — port of
``gs_init_tpu/ops/knn.py``.

Squared distances as |x|^2 + |y|^2 - 2 x.y in full f32 (``torch.matmul``
in f32 does not use TF32 unless enabled globally). ``knn`` blocks over both
queries and points with a running top-k, so its peak memory is
[chunk, point_chunk] whatever the cloud's size (a [chunk, N] block is
24 GB at N = 3M). ``mean_knn_dist`` (the reference's kNN scale
initialisation) takes [chunk, N] blocks with one top-k each.
"""
from __future__ import annotations

import torch


def knn(
    queries: torch.Tensor,  # [M, D]
    points: torch.Tensor,  # [N, D]
    k: int = 4,
    chunk: int = 2048,
    point_chunk: int = 16384,
):
    """(dists [M, k], idx [M, k] int64) of the k nearest points per query,
    nearest first. If ``queries`` are the ``points``, column 0 is each
    point itself (distance ~0): ask for k + 1 and drop it."""
    p_sq = (points * points).sum(-1)
    out_d, out_i = [], []
    for qs in range(0, queries.shape[0], chunk):
        q = queries[qs : qs + chunk]
        q_sq = (q * q).sum(-1, keepdim=True)
        best_d = torch.full((q.shape[0], k), float("inf"), dtype=q.dtype, device=q.device)
        best_i = torch.zeros((q.shape[0], k), dtype=torch.int64, device=q.device)
        for ps in range(0, points.shape[0], point_chunk):
            pb = points[ps : ps + point_chunk]
            d2 = q_sq - 2.0 * q @ pb.T + p_sq[None, ps : ps + point_chunk]
            # Winners from the previous best (sel < k) keep their index; the
            # others are points of this block.
            best_d, sel = torch.topk(torch.cat([best_d, d2], dim=1), k, dim=1, largest=False)
            keep = sel < k
            old = torch.gather(best_i, 1, torch.where(keep, sel, 0))
            best_i = torch.where(keep, old, ps + sel - k)
        out_d.append(best_d)
        out_i.append(best_i)
    return torch.sqrt(torch.cat(out_d).clamp(min=0.0)), torch.cat(out_i)


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
