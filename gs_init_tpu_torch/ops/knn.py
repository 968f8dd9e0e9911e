"""Brute-force k-nearest neighbours, chunked for memory — port of
``gs_init_tpu/ops/knn.py``.

Squared distances as |x|^2 + |y|^2 - 2 x.y in full f32 (``torch.matmul``
in f32 does not use TF32 unless enabled globally). ``knn`` blocks over both
queries and points with a running top-k, so its peak memory is
[chunk, point_chunk] whatever the cloud's size (a [chunk, N] block is
24 GB at N = 3M).

``knn_sq_dists`` (behind ``mean_knn_dist``, the reference's kNN scale
initialisation) and ``knn_self`` (behind ``ops/lof.py`` and the scale
outliers of ``mdi/alignment/interp.py``, with indices) find the same k
nearest points of a cloud among itself as the brute force, from the same
per-pair arithmetic, without visiting every pair: the points are put in
Morton order and cut into blocks of ``chunk``; each query block first
takes a bound from its ``BOUND_BLOCKS`` nearest blocks by bounding box,
then visits only the other blocks whose box lies within that bound: on a
surface-like cloud a few dozen blocks per block, not all of them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.compression import morton_order

# Blocks a query block scans first, its own included, for its bound.
BOUND_BLOCKS = 3
# Distances to several blocks are taken this many at a time (256 MB in f32).
MAX_BLOCK_ELEMS = 1 << 26


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


def _bounded_search(points: torch.Tensor, k: int, chunk: int, indices: bool):
    """The k smallest squared distances [N, k] from each point to the
    points (self included), nearest first, clamped at 0, and with
    ``indices`` their point indices [N, k] (else None)."""
    n = points.shape[0]
    dev, dt = points.device, points.dtype
    order = torch.as_tensor(morton_order(_as_3d(points)).astype(np.int64), device=dev)
    p = points[order]
    p_sq = (p * p).sum(-1)
    nb = -(-n // chunk)
    # Each block's bounding box (the last block padded with its last point).
    padded = torch.cat([p, p[-1:].expand(nb * chunk - n, p.shape[1])]).reshape(nb, chunk, -1)
    lo, hi = padded.amin(1), padded.amax(1)
    gap = (lo[None] - hi[:, None]).clamp(min=0) + (lo[:, None] - hi[None]).clamp(min=0)
    box_d2 = (gap * gap).sum(-1)  # [nb, nb]: no pair of the two blocks is nearer
    # The computed d2 of a pair may fall below its true value by rounding
    # (a few ulp of |x|^2 + |y|^2): a block is visited within this margin.
    margin = 1e-5 * 2.0 * float(p_sq.max())
    per_group = max(1, MAX_BLOCK_ELEMS // (chunk * chunk))
    rows = lambda j: slice(j * chunk, min(n, (j + 1) * chunk))

    def scan(qi, blocks, best_d, best_i):
        q = p[rows(qi)]
        q_sq = p_sq[rows(qi)][:, None]
        for g in range(0, len(blocks), per_group):
            grp = blocks[g : g + per_group]
            pb = torch.cat([p[rows(j)] for j in grp])
            pb_sq = torch.cat([p_sq[rows(j)] for j in grp])
            d2 = q_sq - 2.0 * q @ pb.T + pb_sq[None, :]
            best_d, sel = torch.topk(torch.cat([best_d, d2], dim=1), k, dim=1, largest=False)
            if indices:
                # Winners from the previous best (sel < k) keep their index;
                # the others are rows of this group, in Morton order.
                cand = torch.cat([torch.arange(rows(j).start, rows(j).stop, device=dev) for j in grp])
                keep = sel < k
                best_i = torch.where(keep, torch.gather(best_i, 1, torch.where(keep, sel, 0)),
                                     cand[(sel - k).clamp(min=0)])
        return best_d, best_i

    first = torch.topk(box_d2, min(BOUND_BLOCKS, nb), dim=1, largest=False).indices.tolist()
    best = []
    for qi in range(nb):
        m = rows(qi).stop - rows(qi).start
        init_i = torch.zeros((m, k), dtype=torch.int64, device=dev) if indices else None
        best.append(scan(qi, first[qi], torch.full((m, k), float("inf"), dtype=dt, device=dev), init_i))
    bound = torch.stack([b[0][:, -1].max() for b in best])  # each block's worst k-th distance
    visit = (box_d2 <= bound[:, None] + margin).cpu()
    for qi in range(nb):
        visit[qi, first[qi]] = False
        rest = torch.nonzero(visit[qi]).flatten().tolist()
        if rest:
            best[qi] = scan(qi, rest, *best[qi])
    d2 = torch.empty((n, k), dtype=dt, device=dev)
    d2[order] = torch.cat([b[0] for b in best]).clamp(min=0.0)
    if not indices:
        return d2, None
    idx = torch.empty((n, k), dtype=torch.int64, device=dev)
    idx[order] = order[torch.cat([b[1] for b in best])]
    return d2, idx


def _as_3d(points: torch.Tensor) -> np.ndarray:
    """The first three coordinates on the host, zero-padded below three:
    what the Morton order is taken over (any order gives the same result;
    this one makes the blocks compact)."""
    p = points.detach()[:, :3].cpu().numpy()
    return np.pad(p, ((0, 0), (0, 3 - p.shape[1])))


def knn_sq_dists(points: torch.Tensor, k: int, chunk: int = 2048) -> torch.Tensor:
    """Squared distances [N, k] to the k nearest points [N, D] (self
    included), nearest first, clamped at 0: the values ``knn(points,
    points, k)`` squares, visiting only blocks that can hold a neighbour."""
    return _bounded_search(points, k, chunk, indices=False)[0]


def knn_self(points: torch.Tensor, k: int, chunk: int = 2048):
    """(dists [N, k], idx [N, k] int64) of the k nearest points [N, D] to
    each point, self included (column 0, distance ~0), nearest first: what
    ``knn(points, points, k)`` returns, by the bounded search. Points at
    exactly equal distances may come in another order than the brute
    force's."""
    d2, idx = _bounded_search(points, k, chunk, indices=True)
    return torch.sqrt(d2), idx


def mean_knn_dist(points: torch.Tensor, k: int = 3, chunk: int = 2048) -> torch.Tensor:
    """sqrt of the mean squared distance to the k nearest strict neighbours [N]."""
    d2 = knn_sq_dists(points, k + 1, chunk)[:, 1:]
    return torch.sqrt(d2.mean(-1))
