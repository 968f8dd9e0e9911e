"""Gaussian projection: world space -> screen space (EWA splatting).

Port of ``gs_init_tpu/ops/projection.py``: the covariance algebra stays
component-wise on flat [C, N] tensors, differentiable by autograd. Pinhole,
ortho and fisheye cameras; classic and antialiased modes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


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
        inv_z = 1.0 / tz
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
