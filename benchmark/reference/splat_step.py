"""Frozen plain copy of the port's training step, for the benchmark's check.

Copied from ``gs_init_tpu_torch`` (``ops/projection.py``, ``ops/sh.py``,
``ops/tiles.py``, the plain compositor of ``ops/rasterize.py``,
``ops/ssim.py``, ``ops/render.py``, ``engine/train_step.py``,
``engine/optim.py``, ``engine/strategy/default.py`` and ``mcmc.py``) and kept
here so that a later change to the port cannot move the yardstick. It imports
nothing of the port. Departures from the copied code:

- the compositor runs its plain PyTorch forward and backward on every device
  (the port launches its CUDA kernels on the card);
- the binning sizes its pair table to the demand, so no pair is dropped;
- the step keeps only the path the benchmark's configurations take: SH
  colours, no pose, appearance or bilateral-grid groups, no depth loss, no
  sampling mask, no patches; anything else raises;
- the state is plain dicts of tensors, not the port's dataclasses.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

PARAM_NAMES = ("means", "quats", "scales", "opacities", "sh0", "shN")


# ------------------------------------------------------------ projection


class Projected(NamedTuple):
    """Per-(camera, gaussian) screen-space quantities; leading dims [C, N]."""

    means2d: torch.Tensor  # [C, N, 2] pixel coords
    conics: torch.Tensor  # [C, N, 3] inverse 2D covariance (a, b, c)
    depths: torch.Tensor  # [C, N] camera-space z
    radii: torch.Tensor  # [C, N] int32 screen radius (0 = culled)
    opacities: torch.Tensor  # [C, N] (compensated when antialiased)
    extents: torch.Tensor  # [C, N, 2] int32 per-axis half-extents, 0 = culled


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """Normalised quaternion (wxyz) -> rotation matrix. [..., 4] -> [..., 3, 3]."""
    q = quats / torch.clamp(torch.linalg.norm(quats, dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def _rot_components(quats):
    n = torch.sqrt(torch.clamp(torch.sum(quats * quats, dim=-1, keepdim=True), min=1e-24))
    q = quats / n
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]


_SYM = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]


def _sym_at(s, i, j):
    return s[_SYM.index((i, j) if i <= j else (j, i))]


def covariance_3d_packed(quats, scales):
    """Sigma = R diag(s^2) R^T as six [N] components (upper triangle)."""
    r = _rot_components(quats)
    s2 = [scales[..., k] * scales[..., k] for k in range(3)]
    return [sum(r[i][k] * r[j][k] * s2[k] for k in range(3)) for (i, j) in _SYM]


def covariance_3d(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Sigma = R diag(s^2) R^T. quats [..., 4], scales [..., 3] -> [..., 3, 3]."""
    m = quat_to_rotmat(quats) * scales[..., None, :]
    return m @ m.transpose(-1, -2)


def project_gaussians(
    means: torch.Tensor,  # [N, 3]
    quats: torch.Tensor,  # [N, 4]
    scales: torch.Tensor,  # [N, 3] post-activation
    opacities: torch.Tensor,  # [N] post-sigmoid
    viewmats: torch.Tensor,  # [C, 4, 4] world->camera
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    eps2d: float = 0.3,
    antialiased: bool = False,
    radius_clip: float = 0.0,
    camera_model: str = "pinhole",
    alive: Optional[torch.Tensor] = None,  # [N] bool capacity mask
) -> Projected:
    """Project gaussians into each camera. Batched over [C, N]."""
    w = [[viewmats[:, i, j, None] for j in range(3)] for i in range(3)]
    tr = [viewmats[:, i, 3, None] for i in range(3)]
    mx, my, mz = means[None, :, 0], means[None, :, 1], means[None, :, 2]
    tx, ty, tz = [w[i][0] * mx + w[i][1] * my + w[i][2] * mz + tr[i] for i in range(3)]

    fx, fy = Ks[:, None, 0, 0], Ks[:, None, 1, 1]
    cx, cy = Ks[:, None, 0, 2], Ks[:, None, 1, 2]

    s3 = covariance_3d_packed(quats, scales)
    ws = [[sum(w[a][j] * _sym_at(s3, j, k) for j in range(3)) for k in range(3)] for a in range(3)]
    cc = [sum(ws[a][k] * w[b][k] for k in range(3)) for (a, b) in _SYM]

    zeros = torch.zeros_like(tz)
    if camera_model == "pinhole":
        tan_fovx = 0.5 * width / fx
        tan_fovy = 0.5 * height / fy
        # A gaussian on or behind the near plane is culled below; its
        # arithmetic runs at depth 1, because at tz == 0 the covariance
        # holds inf - inf and its zero cotangents times NaN are NaN
        # gradients (a 10^6-point init cloud over 161 cameras had one).
        inv_z = 1.0 / torch.where(tz > near_plane, tz, torch.ones_like(tz))
        lim_x, lim_y = 1.3 * tan_fovx, 1.3 * tan_fovy
        txz = torch.clamp(tx * inv_z, -lim_x, lim_x)
        tyz = torch.clamp(ty * inv_z, -lim_y, lim_y)
        J = [
            [fx * inv_z, zeros, -fx * txz * inv_z],
            [zeros, fy * inv_z, -fy * tyz * inv_z],
        ]
        mean2d_x = fx * tx * inv_z + cx
        mean2d_y = fy * ty * inv_z + cy
    elif camera_model == "ortho":
        J = [[fx + zeros, zeros, zeros], [zeros, fy + zeros, zeros]]
        mean2d_x = fx * tx + cx
        mean2d_y = fy * ty + cy
    elif camera_model == "fisheye":
        r2 = tx * tx + ty * ty
        r = torch.sqrt(torch.clamp(r2, min=1e-12))
        theta = torch.atan2(r, tz)
        s_ = theta / r
        mean2d_x = fx * tx * s_ + cx
        mean2d_y = fy * ty * s_ + cy
        l2 = r2 + tz * tz
        dth_dx = tz * tx / (l2 * r)
        dth_dy = tz * ty / (l2 * r)
        dth_dz = -r / l2
        ds_dx = (dth_dx - s_ * tx / r) / r
        ds_dy = (dth_dy - s_ * ty / r) / r
        ds_dz = dth_dz / r
        J = [
            [fx * (s_ + tx * ds_dx), fx * tx * ds_dy, fx * tx * ds_dz],
            [fy * ty * ds_dx, fy * (s_ + ty * ds_dy), fy * ty * ds_dz],
        ]
    else:
        raise ValueError(f"unknown camera model {camera_model!r}")

    jc = [[sum(J[a][j] * _sym_at(cc, j, k) for j in range(3)) for k in range(3)] for a in range(2)]
    v00 = sum(jc[0][k] * J[0][k] for k in range(3))
    v01 = sum(jc[0][k] * J[1][k] for k in range(3))
    v11 = sum(jc[1][k] * J[1][k] for k in range(3))

    det_raw = v00 * v11 - v01 * v01
    a = v00 + eps2d
    c = v11 + eps2d
    b = v01
    det = a * c - b * b
    det_safe = torch.where(det > 0, det, torch.ones_like(det))

    if antialiased:
        compensation = torch.sqrt(torch.clamp(det_raw / det_safe, min=0.0))
    else:
        compensation = torch.ones_like(det)
    opac = opacities[None, :] * compensation

    inv_det = 1.0 / det_safe
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    mean2d = torch.stack([mean2d_x, mean2d_y], dim=-1)

    # Screen radius shrunk to the compositor's support (alpha >= 1/255),
    # capped at 3 sigma; elliptical per-axis extents for binning.
    with torch.no_grad():
        mid = 0.5 * (a + c)
        lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.01))
        nsigma = torch.sqrt(2.0 * torch.log(torch.clamp(opac * 255.0, min=1.0 + 1e-6)))
        nsig = torch.clamp(nsigma, max=3.0)
        radius_f = torch.ceil(nsig * torch.sqrt(lam1))
        ext_x = torch.ceil(nsig * torch.sqrt(torch.clamp(a, min=0.0)))
        ext_y = torch.ceil(nsig * torch.sqrt(torch.clamp(c, min=0.0)))
        valid = (
            (tz > near_plane)
            & (tz < far_plane)
            & (det > 0)
            & (radius_f > radius_clip)
            & (mean2d_x + ext_x > 0)
            & (mean2d_x - ext_x < width)
            & (mean2d_y + ext_y > 0)
            & (mean2d_y - ext_y < height)
            & (opac > 1.0 / 255.0)
        )
        if alive is not None:
            valid = valid & alive[None, :]
        radii = torch.where(valid, radius_f, 0.0).int()
        extents = torch.stack(
            [torch.where(valid, ext_x, 0.0), torch.where(valid, ext_y, 0.0)], dim=-1
        ).int()

    return Projected(
        means2d=mean2d, conics=conic, depths=tz, radii=radii, opacities=opac, extents=extents
    )



# ---------------------------------------------------------------- SH


_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)

NUM_SH_BASES = {0: 1, 1: 4, 2: 9, 3: 16}


def num_sh_bases(degree: int) -> int:
    return NUM_SH_BASES[degree]


def eval_sh_bases(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """SH basis values [..., num_bases] at unit directions [..., 3]."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, _C0)]
    if degree >= 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        xy = x * y
        out += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)


def sh_to_color(
    sh_coeffs: torch.Tensor,  # [..., K, 3], K >= num_bases(degree)
    dirs: torch.Tensor,  # [..., 3], not necessarily normalised
    degree: int,
    basis_mask: Optional[torch.Tensor] = None,  # [num_bases(degree)] 0/1
) -> torch.Tensor:
    """RGB [..., 3] = max(SH . basis + 0.5, 0); the degree schedule rides
    ``basis_mask`` on the basis, not on the coefficient buffer."""
    n = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)
    basis = eval_sh_bases(degree, n)
    if basis_mask is not None:
        basis = basis * basis_mask
    b = basis.shape[-1]
    color = torch.einsum("...k,...kc->...c", basis, sh_coeffs[..., :b, :])
    return torch.clamp(color + 0.5, min=0.0)


# ------------------------------------------------------------- tiles


# Column layout of the per-gaussian table row the compositor reads.
PACK_MX, PACK_MY = 0, 1
PACK_CA, PACK_CB, PACK_CC = 2, 3, 4
PACK_OPA = 5
PACK_R, PACK_G, PACK_B = 6, 7, 8
PACK_DEPTH = 9
# Rows are 16 floats (64 bytes) so the kernels load them as four float4.
PACK_COLS = 16


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
    key_s, order = torch.sort(key, stable=True)  # ties (equal depths in a tile) in pair order, as the card sorts them
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


def pack_table(
    means2d: torch.Tensor,  # [C, N, 2]
    conics: torch.Tensor,  # [C, N, 3]
    opacities: torch.Tensor,  # [C, N]
    colors: torch.Tensor,  # [C, N, 3]
    depths: torch.Tensor,  # [C, N]
) -> torch.Tensor:
    """Per-gaussian attribute rows [C*N, 16] f32 with the conic diagonal
    PRE-HALVED (0.5a, b, 0.5c), so the kernels' quadratic form needs no 0.5
    pass; autograd through this function restores the factor."""
    c, n = opacities.shape
    half = torch.tensor([0.5, 1.0, 0.5], dtype=conics.dtype, device=conics.device)
    return torch.cat(
        [
            means2d.reshape(c * n, 2),
            (conics * half).reshape(c * n, 3),
            opacities.reshape(c * n, 1),
            colors.reshape(c * n, 3),
            depths.reshape(c * n, 1),
            torch.zeros((c * n, PACK_COLS - 10), dtype=means2d.dtype, device=means2d.device),
        ],
        dim=1,
    ).contiguous()


# -------------------------------------------------- plain compositor

ALPHA_MAX = 0.999
ALPHA_MIN = 1.0 / 255.0
TERM_EPS = 1e-4
OUT_ROWS = 8
ROW_R, ROW_G, ROW_B, ROW_ACC, ROW_DEPTH, ROW_T, ROW_NPROC = 0, 1, 2, 3, 4, 5, 6
NATTR = 10  # table columns the compositor reads: mx my ca cb cc opa r g b d
MAX_TILE_PIXELS = 1024  # 256 threads x 4 pixels in the CUDA kernels
# Shared memory of a block per pair of a chunk, as the C entry points size
# it: two staged 48-byte rows (double buffering) and three pair ids; the
# backward adds eight warps' ten partial sums. A block may take at most
# 232,448 B on sm_90, which bounds the chunk (543 pairs).
FWD_SMEM_PER_PAIR = 2 * 48 + 3 * 4
BWD_SMEM_PER_PAIR = FWD_SMEM_PER_PAIR + 8 * 10 * 4
MAX_CHUNK = 232_448 // BWD_SMEM_PER_PAIR
def _chunk_windows(tile_starts: torch.Tensor, chunk: int):
    """Per tile: start, end, aligned window base c0, and chunk count."""
    starts = tile_starts[:-1].long()
    ends = tile_starts[1:].long()
    c0 = torch.div(starts, chunk, rounding_mode="floor") * chunk
    nchunks = torch.where(
        ends > starts, torch.div(ends - c0 + chunk - 1, chunk, rounding_mode="floor"), 0
    )
    return starts, ends, c0, nchunks


def _pixel_coords(tiles: torch.Tensor, tile: int, ntx: int, nty: int):
    """Pixel-centre coordinates [L, 1, P] of the given tiles."""
    pixels = tile * tile
    tloc = tiles % (ntx * nty)
    col = torch.arange(pixels, device=tiles.device)
    px = ((tloc % ntx) * tile)[:, None] + (col % tile)[None, :]
    py = (torch.div(tloc, ntx, rounding_mode="floor") * tile)[:, None] + (
        torch.div(col, tile, rounding_mode="floor")
    )[None, :]
    return (px.float() + 0.5)[:, None, :], (py.float() + 0.5)[:, None, :]


def _gather_chunk(table, gid_sorted, starts, ends, c0, i, chunk):
    """Pair rows [L, chunk, 16] of chunk i of the given tiles, plus the
    in-range mask [L, chunk] and the gaussian ids. Rows outside the tile's
    range of the aligned window are zeros (opacity 0: skipped), as the CUDA
    kernels stage them, so no other gaussian's values leak in."""
    idx = c0[:, None] + i * chunk + torch.arange(chunk, device=c0.device)[None, :]
    inrange = (idx >= starts[:, None]) & (idx < ends[:, None])
    gid = torch.where(
        inrange, gid_sorted[idx.clamp(max=gid_sorted.shape[0] - 1)].long(), 0
    )
    return torch.where(inrange[:, :, None], table[gid], 0.0), inrange, gid


def _alpha_terms(rows, inrange, px, py):
    """Shared fwd/bwd alpha of one chunk, [L, chunk, P]; the diagonal conic
    entries arrive pre-halved (tiles.pack_table). Same operation order as
    the CUDA kernels' alpha_at, so both round alike."""
    col = lambda c: rows[:, :, c : c + 1]  # [L, chunk, 1]
    mx, my, ca, cb, cc, opa = (col(c) for c in range(6))
    dx = px - mx
    dy = py - my
    sigma = ca * dx * dx + cc * dy * dy + cb * dx * dy
    e = torch.exp(-sigma)
    araw = opa * e
    ok = inrange[:, :, None] & (sigma >= 0.0) & (araw >= ALPHA_MIN)
    alpha = torch.where(ok, torch.clamp(araw, max=ALPHA_MAX), 0.0)
    unclamped = ok & (araw <= ALPHA_MAX)
    return alpha, dict(dx=dx, dy=dy, e=e, unclamped=unclamped, ca=ca, cb=cb, cc=cc, opa=opa)


def pair_bounds(rows: torch.Tensor):
    """The CUDA kernels' bounds of each pair (``csrc/composite_common.cuh``
    ``pair_bounds``), from rows [..., >= 6] f32 (mx, my, ca, cb, cc, opa).

    Returns ``(s_cut, hx, hy)``: a pixel at which ``_alpha_terms`` gives
    ``ok`` has sigma <= s_cut (f32) and lies within hx, hy (f64) of the
    mean. A pair with opacity below 1/255 never composites: s_cut = -inf,
    hx = hy = -1. Non-finite inputs give s_cut = +inf; they and
    non-positive or near-degenerate conics give an unbounded box (inf). The
    source comment of the CUDA function argues the margins."""
    mx, my, ca, cb, cc, opa = (rows[..., c] for c in range(6))
    finite = torch.stack([mx, my, ca, cb, cc, opa]).isfinite().all(dim=0)
    s = torch.log(255.0 * opa)
    s_cut = s + 1e-3 * s.abs() + 1e-3
    a, b, c = ca.double(), cb.double(), cc.double()
    d = a * c - 0.25 * b * b
    boxed = finite & (a > 0) & (c > 0) & (d > 1e-5 * a * c)  # else degenerate: no box
    sb = s_cut.double() * (1.0 + 4e-6 * (a * c / d))
    hx = torch.sqrt(sb * c / d) * (1.0 + 1e-5) + 1e-3
    hy = torch.sqrt(sb * a / d) * (1.0 + 1e-5) + 1e-3
    never = ~(opa >= ALPHA_MIN)
    inf = float("inf")
    s_cut = torch.where(never, -inf, torch.where(finite, s_cut, inf))
    hx = torch.where(never, -1.0, torch.where(boxed, hx, inf))
    hy = torch.where(never, -1.0, torch.where(boxed, hy, inf))
    return s_cut, hx, hy


def tile_order(counts: torch.Tensor) -> torch.Tensor:
    """Tile ids by descending ``counts`` (ties in tile order), int32: block
    b of a compositor launch works on tile ``order[b]``, so the longest
    tiles start first and a long tile does not start in the last wave."""
    return torch.argsort(counts, descending=True, stable=True).to(torch.int32)


def _exclusive_cumprod(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    ones = torch.ones_like(x.narrow(dim, 0, 1))
    return torch.cat([ones, torch.cumprod(x, dim).narrow(dim, 0, x.shape[dim] - 1)], dim)


# ------------------------------------------------------- plain PyTorch twins


def composite_fwd_plain(
    table: torch.Tensor,  # [C*N, 16] f32
    gid_sorted: torch.Tensor,  # [PAIR_CAP] int
    tile_starts: torch.Tensor,  # [num_tiles + 1] int
    num_tiles: int,
    ntx: int,
    nty: int,
    tile: int,
    chunk: int,
) -> torch.Tensor:
    """Plain version of the forward kernel; differentiable in ``table``
    (the tests check the explicit backward against autograd through it)."""
    pixels = tile * tile
    dev = table.device
    starts, ends, c0, nchunks = _chunk_windows(tile_starts, chunk)
    color = torch.zeros((num_tiles, 4, pixels), dtype=table.dtype, device=dev)
    tcur = torch.ones((num_tiles, pixels), dtype=table.dtype, device=dev)
    nproc = torch.zeros((num_tiles,), dtype=torch.long, device=dev)
    alive = nchunks > 0
    i = 0
    while True:
        live = torch.nonzero(alive & (i < nchunks)).flatten()
        if live.numel() == 0:
            break
        rows, inrange, _ = _gather_chunk(
            table, gid_sorted, starts[live], ends[live], c0[live], i, chunk
        )
        px, py = _pixel_coords(live, tile, ntx, nty)
        alpha, _ = _alpha_terms(rows, inrange, px, py)
        om = 1.0 - alpha
        pexcl = _exclusive_cumprod(om)
        tk = tcur[live][:, None, :] * pexcl  # [L, chunk, P]
        w = alpha * tk
        contrib = torch.einsum("lkp,lkc->lcp", w, rows[:, :, 6:10])  # r g b d
        color = color.index_add(0, live, contrib)
        tnew = tcur[live] * (pexcl[:, -1, :] * om[:, -1, :])
        tcur = tcur.index_copy(0, live, tnew)
        nproc = nproc.index_add(0, live, torch.ones_like(live))
        alive = alive.index_copy(0, live, tnew.amax(dim=1) > TERM_EPS)
        i += 1
    out = torch.stack(
        [
            color[:, 0], color[:, 1], color[:, 2], 1.0 - tcur, color[:, 3], tcur,
            nproc[:, None].to(table.dtype).expand(num_tiles, pixels),
            torch.zeros_like(tcur),
        ],
        dim=1,
    )
    return out


def composite_bwd_plain(
    table: torch.Tensor,
    gid_sorted: torch.Tensor,
    tile_starts: torch.Tensor,
    fwd_out: torch.Tensor,  # [num_tiles, 8, P]
    g_out: torch.Tensor,  # [num_tiles, 8, P]
    num_tiles: int,
    ntx: int,
    nty: int,
    tile: int,
    chunk: int,
    want_absgrad: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel: the same front-to-back replay
    of the processed chunks (suffix sums from the forward totals, Kahan
    carry across chunks), reduced per pair and added into per-gaussian
    rows with ``index_add_``."""
    dev = table.device
    starts, ends, c0, _ = _chunk_windows(tile_starts, chunk)
    nproc = fwd_out[:, ROW_NPROC, 0].long()
    dtable = torch.zeros_like(table)
    absgrad = torch.zeros((table.shape[0], 2), dtype=table.dtype, device=dev)
    g_rgbd = g_out[:, [ROW_R, ROW_G, ROW_B, ROW_DEPTH], :]  # [T, 4, P]
    out_rgbd = fwd_out[:, [ROW_R, ROW_G, ROW_B, ROW_DEPTH], :]
    g_tn = g_out[:, ROW_ACC, :] - g_out[:, ROW_T, :]
    gt = g_tn * fwd_out[:, ROW_T, :]
    r_tot = (g_rgbd * out_rgbd).sum(dim=1)
    tcur = torch.ones_like(gt)
    rrem = r_tot - gt  # sum of u over chunks >= i, less the T_final term
    comp = torch.zeros_like(gt)  # Kahan compensation of rrem
    i = 0
    while True:
        live = torch.nonzero((i < nproc) & (ends > starts)).flatten()
        if live.numel() == 0:
            break
        rows, inrange, gid = _gather_chunk(
            table, gid_sorted, starts[live], ends[live], c0[live], i, chunk
        )
        px, py = _pixel_coords(live, tile, ntx, nty)
        alpha, aux = _alpha_terms(rows, inrange, px, py)
        om = 1.0 - alpha
        inv1m = 1.0 / om
        pexcl = _exclusive_cumprod(om)
        tk = tcur[live][:, None, :] * pexcl
        w = alpha * tk
        gr = g_rgbd[live]  # [L, 4, P]
        q = torch.einsum("lkc,lcp->lkp", rows[:, :, 6:10], gr)
        u = q * w
        usum = u.sum(dim=1)
        y = -usum - comp[live]
        rr = rrem[live]
        rnext = rr + y
        comp = comp.index_copy(0, live, (rnext - rr) - y)
        rrem = rrem.index_copy(0, live, rnext)
        rev = torch.flip(torch.cumsum(torch.flip(u, [1]), 1), [1])
        r_in = torch.cat([rev[:, 1:], torch.zeros_like(rev[:, :1])], 1) + rnext[:, None, :]
        dalpha = q * tk - r_in * inv1m
        dcols = torch.einsum("lkp,lcp->lkc", w, gr)  # dr dg db ddepth
        de = dalpha * torch.where(aux["unclamped"], aux["e"], 0.0)
        dopa = de.sum(dim=2)
        dsig = de * (-aux["opa"])
        dx, dy = aux["dx"], aux["dy"]
        dsx = dsig * dx
        dsy = dsig * dy
        dca = (dsx * dx).sum(dim=2)
        dcb = (dsx * dy).sum(dim=2)
        dcc = (dsy * dy).sum(dim=2)
        sx = dsx.sum(dim=2)
        sy = dsy.sum(dim=2)
        ca, cb, cc = (rows[:, :, c] for c in (2, 3, 4))
        dmx = -(2.0 * ca * sx + cb * sy)
        dmy = -(2.0 * cc * sy + cb * sx)
        grads = torch.stack([dmx, dmy, dca, dcb, dcc, dopa], dim=2)
        grads = torch.cat([grads, dcols], dim=2)  # [L, chunk, 10]
        m = inrange.reshape(-1)
        flat_gid = gid.reshape(-1)[m]
        dtable[:, :NATTR].index_add_(0, flat_gid, grads.reshape(-1, NATTR)[m])
        if want_absgrad:
            dm = torch.stack([dmx, dmy], dim=2).abs().reshape(-1, 2)[m]
            absgrad.index_add_(0, flat_gid, dm)
        tcur = tcur.index_copy(0, live, tcur[live] * (pexcl[:, -1, :] * om[:, -1, :]))
        i += 1
    return dtable, absgrad


# -------------------------------------------------------------- SSIM

def _gaussian_window(size: int = 11, sigma: float = 1.5) -> tuple:
    x = np.arange(size) - (size - 1) / 2
    w = np.exp(-(x**2) / (2 * sigma**2))
    return tuple(float(v) for v in (w / w.sum()).astype(np.float32))


def _blur_valid(x: torch.Tensor, window: tuple) -> torch.Tensor:
    """Separable valid-padding filter over [N, H, W] (shifted-slice FMAs)."""
    k = len(window)
    h_out = x.shape[1] - k + 1
    acc = window[0] * x[:, :h_out, :]
    for i in range(1, k):
        acc = acc + window[i] * x[:, i : i + h_out, :]
    w_out = x.shape[2] - k + 1
    out = window[0] * acc[:, :, :w_out]
    for i in range(1, k):
        out = out + window[i] * acc[:, :, i : i + w_out]
    return out


def ssim(
    img0: torch.Tensor,  # [B, H, W, C] predictions in [0, 1]
    img1: torch.Tensor,  # [B, H, W, C] targets
    c1: float = 0.01**2,
    c2: float = 0.03**2,
    window_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """Mean SSIM over a batch (scalar), valid padding."""
    w = _gaussian_window(window_size, sigma)
    b, h, wd, c = img0.shape
    i0 = img0.permute(0, 3, 1, 2)
    i1 = img1.permute(0, 3, 1, 2)
    stacked = torch.cat([i0, i1, i0 * i0, i1 * i1, i0 * i1], dim=1).reshape(b * 5 * c, h, wd)
    blurred = _blur_valid(stacked, w)
    blurred = blurred.reshape(b, 5, c, *blurred.shape[1:])
    mu0, mu1, e00, e11, e01 = (blurred[:, i] for i in range(5))
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = e00 - mu00
    s11 = e11 - mu11
    s01 = e01 - mu01
    m = ((2 * mu01 + c1) * (2 * s01 + c2)) / ((mu00 + mu11 + c1) * (s00 + s11 + c2))
    return torch.mean(m)


# ------------------------------------------------------- strategies

@torch.no_grad()
def update_state(
    state: DefaultStrategyState,
    means2d_grads: torch.Tensor,  # [C, CAP, 2]
    radii: torch.Tensor,  # [C, CAP] int32
    width: int,
    height: int,
) -> DefaultStrategyState:
    """Accumulate densification statistics (in place). Pixel grads are
    scaled by [W/2, H/2] times the camera count, as gsplat does."""
    c = means2d_grads.shape[0]
    scale = torch.tensor(
        [width * c / 2.0, height * c / 2.0], dtype=torch.float32, device=means2d_grads.device
    )
    norms = torch.linalg.norm(means2d_grads * scale, dim=-1)
    visible = radii > 0
    state.grad2d += torch.where(visible, norms, 0.0).sum(0)
    state.count += visible.sum(0).float()
    torch.maximum(
        state.radii_max,
        radii.amax(0).float() / float(max(width, height)),
        out=state.radii_max,
    )
    return state


def _alloc_slots(alive: torch.Tensor, cand: torch.Tensor):
    """Assign a free slot to each candidate; returns (dst, ok)."""
    cap = alive.shape[0]
    free_idx = torch.argsort(alive.to(torch.int8), stable=True)  # dead slots first
    n_free = cap - alive.sum()
    rank = torch.cumsum(cand.long(), 0) - 1
    ok = cand & (rank < n_free)
    dst = free_idx[rank.clamp(0, cap - 1)]
    return dst, ok


def split_noise(capacity: int, generator: torch.Generator, device=None):
    """The two [CAP, 3] standard-normal draws ``refine`` uses for splits."""
    eps1 = torch.randn((capacity, 3), generator=generator, device=device)
    eps2 = torch.randn((capacity, 3), generator=generator, device=device)
    return eps1, eps2


@torch.no_grad()
def refine_default(
    gstate: GaussianState,
    adam: AdamState,
    sstate: DefaultStrategyState,
    eps1: torch.Tensor,  # [CAP, 3] split noise for the original slot
    eps2: torch.Tensor,  # [CAP, 3] split noise for the new twin
    scene_scale: float,
    cfg: DefaultStrategyConfig,
    step: int,
):
    """Grow (duplicate / split) then prune. Returns (gstate, adam, new
    strategy state, stats); the buffers are updated in place."""
    params, alive = gstate.params, gstate.alive
    cap = alive.shape[0]
    dev = alive.device

    grads = sstate.grad2d / torch.clamp(sstate.count, min=1.0)
    is_high = grads > cfg.grow_grad2d
    scale_max = torch.exp(params.scales).amax(-1)
    is_small = scale_max <= cfg.grow_scale3d * scene_scale
    is_dup = alive & is_high & is_small
    is_split = alive & is_high & ~is_small
    if cfg.refine_scale2d_stop_iter > 0:
        scale2d_on = step < cfg.refine_scale2d_stop_iter
        is_split = is_split | (alive & scale2d_on & (sstate.radii_max > cfg.grow_scale2d))
        is_dup = is_dup & ~is_split

    cand = is_dup | is_split
    dst, ok = _alloc_slots(alive, cand)

    rot = quat_to_rotmat(params.quats)
    sigma = torch.exp(params.scales)
    samp1 = params.means + torch.einsum("nij,nj->ni", rot, eps1 * sigma)
    samp2 = params.means + torch.einsum("nij,nj->ni", rot, eps2 * sigma)
    split_scales = params.scales - math.log(1.6)

    new_vals = {name: v.clone() for name, v in params.items()}
    new_vals["means"] = torch.where(is_split[:, None], samp2, params.means)
    new_vals["scales"] = torch.where(is_split[:, None], split_scales, params.scales)
    if cfg.revised_opacity:
        o = torch.sigmoid(params.opacities)
        rev = torch.clamp(1.0 - torch.sqrt(torch.clamp(1.0 - o, min=0.0)), 1e-7, 1 - 1e-7)
        new_vals["opacities"] = torch.where(
            is_dup, torch.log(rev) - torch.log1p(-rev), new_vals["opacities"]
        )

    src = torch.nonzero(ok).flatten()
    d = dst[src]
    for name, buf in params.items():
        buf[d] = new_vals[name][src]
    params.means.copy_(torch.where(is_split[:, None], samp1, params.means))
    params.scales.copy_(torch.where(is_split[:, None], split_scales, params.scales))
    alive[d] = True

    for moments in (adam.mu, adam.nu):
        for _, m in moments.items():
            m[d] = 0.0
            m[is_split] = 0.0

    opa = torch.sigmoid(params.opacities)
    prune = opa < cfg.prune_opa
    is_too_big = scale_max > cfg.prune_scale3d * scene_scale
    if cfg.refine_scale2d_stop_iter > 0:
        is_too_big = is_too_big | (
            (step < cfg.refine_scale2d_stop_iter) & (sstate.radii_max > cfg.prune_scale2d)
        )
    prune = prune | (is_too_big & (step > cfg.reset_every))
    alive &= ~prune

    stats = dict(
        n_dup=int(is_dup.sum()), n_split=int(is_split.sum()), n_pruned=int(prune.sum())
    )
    return gstate, adam, init_state(cap, dev), stats

_N_MAX = 51  # the binomial table bound of 3DGS-MCMC


def _log_binom(n: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return torch.lgamma(n + 1.0) - torch.lgamma(i + 1.0) - torch.lgamma(n - i + 1.0)


def relocation_params(opacity: torch.Tensor, n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """New (opacity, scale factor) when a gaussian is split into n samples.

    opacity: [K] post-sigmoid; n: [K] sample counts >= 1. Eq. 9 of
    3DGS-MCMC as an alternating binomial sum over i <= 51 in float32, as the
    JAX package computes it (it cancels badly for large n; kept, so results
    match the reference)."""
    n = torch.clamp(n.float(), 1.0, float(_N_MAX))
    new_o = 1.0 - torch.pow(1.0 - opacity, 1.0 / n)
    i = torch.arange(1, _N_MAX + 1, dtype=torch.float32, device=opacity.device)
    sign = torch.where(i % 2 == 1, 1.0, -1.0)
    log_terms = _log_binom(n[:, None], i[None, :]) + i[None, :] * torch.log(
        torch.clamp(new_o[:, None], min=1e-12)
    )
    terms = sign[None, :] / torch.sqrt(i)[None, :] * torch.exp(log_terms)
    terms = torch.where(i[None, :] <= n[:, None], terms, 0.0)
    denom = torch.sum(terms, dim=1)
    factor = opacity / torch.clamp(denom, min=1e-12)
    return new_o, factor


def live_mask(gstate: GaussianState, cfg: MCMCStrategyConfig):
    """(post-sigmoid opacities, dead mask, live mask)."""
    opa = torch.sigmoid(gstate.params.opacities)
    dead = gstate.alive & (opa < cfg.min_opacity)
    return opa, dead, gstate.alive & ~dead


def draw_targets(opa: torch.Tensor, live: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """[CAP] slots drawn with probability proportional to opacity among the
    live ones, on the device, no host sync. With no live gaussian every
    draw is slot 0, as JAX's categorical over all -inf logits gives."""
    cap = opa.shape[0]
    any_live = live.any()
    weights = torch.where(any_live, opa * live, torch.ones_like(opa))
    targets = torch.multinomial(weights, cap, replacement=True, generator=generator)
    return torch.where(any_live, targets, torch.zeros_like(targets))


def noise_eps(capacity: int, generator: torch.Generator) -> torch.Tensor:
    """The [CAP, 3] standard normals ``add_noise`` uses."""
    return torch.randn((capacity, 3), generator=generator, device=generator.device)


@torch.no_grad()
def refine_mcmc(
    gstate: GaussianState,
    adam: AdamState,
    sstate,
    targets: torch.Tensor,  # [CAP] int: a live slot drawn for every slot
    cfg: MCMCStrategyConfig,
):
    """Relocate dead gaussians and add new ones (5% growth up to cap_max),
    in place. Returns (gstate, adam, sstate)."""
    params, alive = gstate.params, gstate.alive
    cap = alive.shape[0]
    opa, dead, live = live_mask(gstate, cfg)

    # Growth tranche: +5% of the current count, bounded by cap_max and capacity.
    n_alive = alive.sum(dtype=torch.int32)
    target_n = torch.clamp((n_alive.float() * 1.05).int(), max=min(cfg.cap_max, cap))
    free = ~alive
    add_rank = torch.cumsum(free.int(), 0) - 1
    add_mask = free & (add_rank < torch.clamp(target_n - n_alive, min=0))

    recv = dead | add_mask
    sent = torch.where(recv, targets, cap)  # cap: the sentinel of non-receivers
    extra = torch.zeros(cap + 1, dtype=torch.int32, device=alive.device)
    extra.scatter_add_(0, sent, torch.ones_like(sent, dtype=torch.int32))
    extra = extra[:cap]

    new_o, factor = relocation_params(opa, 1.0 + extra.float())
    touched = (extra > 0) & live
    # The targets' new opacity and scale first; the receivers then copy the
    # updated rows (receivers are never targets: they are dead or free).
    params.opacities.copy_(torch.where(
        touched,
        torch.log(torch.clamp(new_o, min=1e-9) / torch.clamp(1.0 - new_o, min=1e-9)),
        params.opacities,
    ))
    params.scales.copy_(torch.where(
        touched[:, None], params.scales + torch.log(torch.clamp(factor, min=1e-12))[:, None],
        params.scales,
    ))
    t = torch.clamp(targets, 0, cap - 1)
    for _, leaf in params.items():
        mask = recv.reshape((cap,) + (1,) * (leaf.dim() - 1))
        leaf.copy_(torch.where(mask, leaf[t], leaf))
    alive |= add_mask

    # Zero the Adam moments of every touched slot (receivers and split targets).
    zero = recv | touched
    for moments in (adam.mu, adam.nu):
        for _, m in moments.items():
            m.masked_fill_(zero.reshape((cap,) + (1,) * (m.dim() - 1)), 0.0)
    return gstate, adam, sstate


def relocate(gstate: GaussianState, adam: AdamState, sstate, generator: torch.Generator,
             cfg: MCMCStrategyConfig):
    """``refine`` with targets drawn by ``draw_targets`` (the Runner's call)."""
    opa, _, live = live_mask(gstate, cfg)
    return refine_mcmc(gstate, adam, sstate, draw_targets(opa, live, generator), cfg)


@torch.no_grad()
def add_noise(gstate: GaussianState, eps: torch.Tensor, lr: float, cfg: MCMCStrategyConfig):
    """Covariance-shaped positional noise on near-transparent gaussians, in
    place: means += noise_lr * lr * sigmoid gate * R diag(s^2) R^T eps (the
    full covariance, not a Cholesky sample). Only alive slots move."""
    params, alive = gstate.params, gstate.alive
    opa = torch.sigmoid(params.opacities)
    gate = torch.sigmoid(-100.0 * (opa - 1.0 + 0.995))
    rot = quat_to_rotmat(params.quats)
    s2 = torch.exp(2.0 * params.scales)
    sample = torch.einsum("nij,nj->ni", rot, s2 * torch.einsum("nji,nj->ni", rot, eps))
    noise = cfg.noise_lr * lr * gate[:, None] * sample
    params.means.copy_(torch.where(alive[:, None], params.means + noise, params.means))
    return gstate


# ------------------------------------------------------------------ state


class Leaves:
    """Named tensors with attribute access, in insertion order: the port's
    ``GaussianParams`` and strategy state as plain containers."""

    def __init__(self, **leaves):
        self.__dict__.update(leaves)

    def items(self):
        return iter(list(self.__dict__.items()))

    def clone(self) -> "Leaves":
        return Leaves(**{k: v.clone() for k, v in self.__dict__.items()})


class GState:
    def __init__(self, params: Leaves, alive: torch.Tensor):
        self.params, self.alive = params, alive


class AdamS:
    def __init__(self, mu: Leaves, nu: Leaves, count: int):
        self.mu, self.nu, self.count = mu, nu, count


def init_state(capacity: int, device=None) -> Leaves:
    z = lambda: torch.zeros((capacity,), dtype=torch.float32, device=device)
    return Leaves(grad2d=z(), count=z(), radii_max=z())


# ------------------------------------------------------------------- Adam


def adam_config(st: dict, scene_scale: float) -> dict:
    """``make_adam_config`` over the settings dict ``st``."""
    bs = st["batch_size"] * max(st["data_parallel"], 1)
    s = math.sqrt(bs)
    lrs = dict(
        means=st["means_lr"] * scene_scale * s, quats=st["quats_lr"] * s, scales=st["scales_lr"] * s,
        opacities=st["opacities_lr"] * s, sh0=st["sh0_lr"] * s, shN=st["shN_lr"] * s,
    )
    return dict(lrs=lrs, b1=0.9**bs, b2=0.999**bs, eps=1e-15 / s,
                means_decay_gamma=0.01 ** (1.0 / max(st["max_steps"], 1)))


@torch.no_grad()
def adam_update(params: Leaves, grads: dict, state: AdamS, acfg: dict, step: int) -> AdamS:
    """One Adam step in place, its count advanced: p -= lr * (m / bc1) / (sqrt(v / bc2) + eps)."""
    count = state.count + 1
    bc1 = 1.0 - np.float32(acfg["b1"]) ** np.float32(count)
    bc2 = 1.0 - np.float32(acfg["b2"]) ** np.float32(count)
    means_scale = float(np.float32(acfg["means_decay_gamma"]) ** np.float32(step))
    for name, p in params.items():
        g = grads[name]
        m = getattr(state.mu, name)
        v = getattr(state.nu, name)
        m.mul_(acfg["b1"]).add_(g * (1 - acfg["b1"]))
        v.mul_(acfg["b2"]).add_(g * (1 - acfg["b2"]) * g)
        lr = acfg["lrs"][name] * (means_scale if name == "means" else 1.0)
        p.sub_(lr * (m / float(bc1)) / (torch.sqrt(v / float(bc2)) + acfg["eps"]))
    state.count = count
    return state


# ----------------------------------------------------------------- render


class _RenderTiles(torch.autograd.Function):
    """The compositor with its plain forward and explicit plain backward."""

    @staticmethod
    def forward(ctx, table, gid_sorted, tile_starts, num_tiles, ntx, nty, tile, chunk):
        out = composite_fwd_plain(table, gid_sorted, tile_starts, num_tiles, ntx, nty, tile, chunk)
        ctx.save_for_backward(table, gid_sorted, tile_starts, out)
        ctx.meta = (num_tiles, ntx, nty, tile, chunk)
        return out

    @staticmethod
    def backward(ctx, g_out):
        table, gid_sorted, tile_starts, out = ctx.saved_tensors
        num_tiles, ntx, nty, tile, chunk = ctx.meta
        dtable, _ = composite_bwd_plain(table, gid_sorted, tile_starts, out, g_out.contiguous(),
                                        num_tiles, ntx, nty, tile, chunk, False)
        dtable[:, PACK_DEPTH] = 0.0  # RGB renders: the depth row takes no gradient
        return (dtable,) + (None,) * 7


def unpack_tiles(out, num_cams, ntx, nty, tile, width, height):
    rows = ROW_DEPTH + 1
    x = out.reshape(num_cams, nty, ntx, OUT_ROWS, tile, tile)[:, :, :, :rows]
    x = x.permute(0, 3, 1, 4, 2, 5).reshape(num_cams, rows, nty * tile, ntx * tile)
    x = x[:, :, :height, :width]
    return x[:, ROW_R : ROW_B + 1].permute(0, 2, 3, 1), x[:, ROW_ACC]


def render(st: dict, means, quats, scales, opacities, sh, viewmats, Ks, width, height, sh_mask, alive, dummy,
           bkgd=None):
    """The port's ``rasterize`` on its tile path, RGB, SH colours: returns
    (colour [C, H, W, 3], alpha [C, H, W, 1], radii [C, N])."""
    tile, chunk = st["tile_size"], st["chunk_size"]
    proj = project_gaussians(
        means, quats, scales, opacities, viewmats, Ks, width, height,
        near_plane=st["near_plane"], far_plane=st["far_plane"], antialiased=st["antialiased"],
        camera_model="pinhole", alive=alive,
    )
    means2d = proj.means2d + dummy
    c = viewmats.shape[0]
    centers = -torch.einsum("cji,cj->ci", viewmats[:, :3, :3], viewmats[:, :3, 3])
    dirs = means[None, :, :] - centers[:, None, :]
    colors = sh_to_color(sh[None].expand((c,) + sh.shape), dirs, st["sh_degree"], basis_mask=sh_mask)
    _, counts, _ = tile_spans(means2d.detach().reshape(-1, 2), proj.radii.reshape(-1), width, height, tile,
                              extents=proj.extents.reshape(-1, 2))
    demand = int(counts.long().sum())
    binning = bin_gaussians(means2d, proj.radii, proj.depths, width, height, tile,
                            max(chunk, -(-demand // chunk) * chunk), chunk=chunk, extents=proj.extents)
    table = pack_table(means2d, proj.conics, proj.opacities, colors, proj.depths)
    ntx, nty = binning.num_tiles_x, binning.num_tiles_y
    out = _RenderTiles.apply(table, binning.gid_sorted, binning.tile_starts, c * ntx * nty, ntx, nty, tile, chunk)
    color, alpha = unpack_tiles(out, c, ntx, nty, tile, width, height)
    if bkgd is not None:
        color = color + (1.0 - alpha)[..., None] * bkgd[:, None, None, :]
    return color, alpha[..., None], proj.radii


# ------------------------------------------------------------------- step

UNSUPPORTED = ("pose_opt", "app_opt", "use_bilateral_grid", "depth_loss", "random_bkgd", "patch_size", "absgrad")


def sh_basis_mask(st: dict, step: int, device) -> torch.Tensor:
    n_active = (min(step // st["sh_degree_interval"], st["sh_degree"]) + 1) ** 2
    idx = torch.arange(num_sh_bases(st["sh_degree"]), device=device)
    return (idx < n_active).float()


def train_step(st: dict, acfg: dict, g: GState, adam: AdamS, sstate: Optional[Leaves], batch: dict, step: int,
               width: int, height: int, half: bool = False):
    """One step of the port's train step, in place on ``g``, ``adam`` and
    ``sstate`` (None under MCMC). ``batch`` holds ``camtoworlds`` [B, 4, 4],
    ``Ks`` [B, 3, 3] and ``pixels`` [B, H, W, 3]. Returns (loss, grads).
    ``half`` plants a fault (the loss over the upper half of the rows) for
    the calibration of the check's limits."""
    for k in UNSUPPORTED:
        if st.get(k) or st["strategy"].get(k):
            raise ValueError(f"the reference step has no {k}")
    p = g.params
    dev = p.means.device
    c = batch["pixels"].shape[0]
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    dummy = torch.zeros((c, p.means.shape[0], 2), device=dev, requires_grad=True)
    scales, opac = torch.exp(leaves["scales"]), torch.sigmoid(leaves["opacities"])
    viewmats = torch.linalg.inv(batch["camtoworlds"])
    bkgd = None
    if st.get("background_color") is not None:
        bkgd = torch.tensor(st["background_color"], dtype=torch.float32, device=dev)[None].repeat(c, 1)
    sh = torch.cat([leaves["sh0"], leaves["shN"]], 1)
    rendered, alpha, radii = render(st, leaves["means"], leaves["quats"], scales, opac, sh, viewmats, batch["Ks"],
                                    width, height, sh_basis_mask(st, step, dev), g.alive, dummy, bkgd)
    pixels = batch["pixels"]
    if half:  # a fault for the check's calibration: the mean over half of the batch's pixels
        rendered, pixels = rendered[:, : height // 2], pixels[:, : height // 2]
    l1 = torch.mean(torch.abs(rendered - pixels))
    loss = (1.0 - st["ssim_lambda"]) * l1 + st["ssim_lambda"] * (1.0 - ssim(rendered, pixels))
    if st["opacity_reg"] > 0.0:
        loss = loss + st["opacity_reg"] * torch.mean(torch.where(g.alive, torch.abs(opac), 0.0))
    if st["scale_reg"] > 0.0:
        loss = loss + st["scale_reg"] * torch.mean(torch.where(g.alive[:, None], torch.abs(scales), 0.0))
    grads = torch.autograd.grad(loss, [leaves[k] for k in PARAM_NAMES] + [dummy])
    gd = dict(zip(PARAM_NAMES, grads[:6]))
    adam_update(p, gd, adam, acfg, step)
    if sstate is not None:
        update_state(sstate, grads[6], radii, width, height)
    return loss.detach(), gd
