"""Tile binning for the tile compositor: static pair capacity, one sort.

Port of ``gs_init_tpu/ops/tiles.py``. Per (camera, gaussian) tile spans from
the elliptical per-axis extents; an exclusive prefix sum gives pair
offsets; the pair list has a fixed capacity (pairs past it are dropped and
counted in ``overflow``, as in the JAX package); pairs sort by (tile, depth)
as one int64 key ``tile << 32 | depth_bits`` (positive float bits order like
the floats); per-tile ranges come from ``searchsorted``.

Gaussian ids stay int32: the JAX package's biased-float gid encoding, the
bf16 wire format, the backward's aligned record slots (``out_starts``) and
the presort segment reduction exist for the TPU only. On the card the
backward kernel reduces per-gaussian gradients with atomics.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

class TileBinning(NamedTuple):
    gid_sorted: torch.Tensor  # [PAIR_CAP] int32 flattened (cam*N + gaussian)
    tile_starts: torch.Tensor  # [num_tiles + 1] int32 sorted-order ranges
    num_tiles_x: int
    num_tiles_y: int
    overflow: torch.Tensor  # [] int32: pairs dropped due to capacity
    gauss_offsets: torch.Tensor  # [C*N] exclusive prefix of per-gaussian pairs
    gauss_counts: torch.Tensor  # [C*N]


def tile_spans(
    means2d: torch.Tensor,  # [M, 2]
    radii: torch.Tensor,  # [M] int32 (0 = culled)
    width: int,
    height: int,
    tile_size: int,
    extents: Optional[torch.Tensor] = None,  # [M, 2] int32
):
    """Inclusive tile ranges [x0, x1] x [y0, y1] per gaussian and pair counts."""
    num_tx = -(-width // tile_size)
    num_ty = -(-height // tile_size)
    if extents is not None:
        rx = extents[:, 0].float()
        ry = extents[:, 1].float()
    else:
        rx = ry = radii.float()
    x0 = torch.floor((means2d[:, 0] - rx) / tile_size).int().clamp(0, num_tx - 1)
    x1 = torch.floor((means2d[:, 0] + rx) / tile_size).int().clamp(0, num_tx - 1)
    y0 = torch.floor((means2d[:, 1] - ry) / tile_size).int().clamp(0, num_ty - 1)
    y1 = torch.floor((means2d[:, 1] + ry) / tile_size).int().clamp(0, num_ty - 1)
    counts = torch.where(radii > 0, (x1 - x0 + 1) * (y1 - y0 + 1), 0).int()
    return (x0, x1, y0, y1), counts, (num_tx, num_ty)


def bin_gaussians(
    means2d: torch.Tensor,  # [C, N, 2]
    radii: torch.Tensor,  # [C, N] int32
    depths: torch.Tensor,  # [C, N]
    width: int,
    height: int,
    tile_size: int,
    pair_capacity: int,
    chunk: int = 128,
    extents: Optional[torch.Tensor] = None,  # [C, N, 2] int32
) -> TileBinning:
    if pair_capacity % chunk:
        raise ValueError("pair_capacity must be a multiple of chunk")
    c, n = radii.shape
    dev = means2d.device
    m2 = means2d.detach().reshape(c * n, 2)
    rad = radii.reshape(c * n)
    dep = depths.detach().reshape(c * n)
    (x0, x1, y0, y1), counts, (ntx, nty) = tile_spans(
        m2, rad, width, height, tile_size,
        extents=None if extents is None else extents.reshape(c * n, 2),
    )
    tiles_per_cam = ntx * nty
    num_tiles = c * tiles_per_cam

    counts64 = counts.long()
    ends = torch.cumsum(counts64, 0)
    offsets = ends - counts64
    total = ends[-1] if c * n else torch.zeros((), dtype=torch.long, device=dev)

    # Slot -> gaussian: the last gaussian whose segment starts at or before
    # the slot (empty segments share their start with the next one).
    idx = torch.arange(pair_capacity, device=dev)
    pair_gid = (torch.searchsorted(offsets, idx, right=True) - 1).clamp(min=0)
    valid = idx < total
    local = idx - offsets[pair_gid]
    w_span = (x1 - x0 + 1).long()[pair_gid]
    tx = x0.long()[pair_gid] + local % w_span
    ty = y0.long()[pair_gid] + torch.div(local, w_span, rounding_mode="floor")
    cam = torch.div(pair_gid, n, rounding_mode="floor")
    tile_id = torch.where(valid, cam * tiles_per_cam + ty * ntx + tx, num_tiles)
    depth_bits = dep.clamp(min=0.0).view(torch.int32).long()[pair_gid]
    key = (tile_id << 32) | depth_bits
    key_s, order = torch.sort(key)
    gid_s = pair_gid[order].int()
    tile_s = key_s >> 32
    starts = torch.searchsorted(
        tile_s, torch.arange(num_tiles + 1, device=dev), right=False
    ).int()
    overflow = (total - pair_capacity).clamp(min=0).int()
    return TileBinning(
        gid_sorted=gid_s,
        tile_starts=starts,
        num_tiles_x=ntx,
        num_tiles_y=nty,
        overflow=overflow,
        gauss_offsets=offsets.int(),
        gauss_counts=counts,
    )
