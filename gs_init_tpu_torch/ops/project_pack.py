"""Projection, SH colours and the table pack as one op: a CUDA kernel pair
(K4 forward, K5 backward) and their plain twins.

``project_pack`` is how both train steps reach the compositor's table: it
computes the composition ``projection.project_gaussians``, the SH colours of
``sh.sh_to_color`` (or given colours) and ``pack_table``. It returns the
table ``[C*N, 16]`` (the ``PACK_*`` columns, conic diagonal pre-halved,
columns 10-15 zero), the radii ``[C, N]`` and extents ``[C, N, 2]`` (int32,
0 where culled) and the depths ``[C, N]``. The table's layout is defined
here and nowhere else.

On a CPU tensor it runs that composition itself (``project_pack_plain``),
differentiable by autograd, so CPU results are those of the three modules to
the bit. On a CUDA tensor it launches ``csrc/project_pack_fwd.cu`` (K4), and
its gradient is ``csrc/project_pack_bwd.cu`` (K5), or it raises: one pass
over the gaussians each way where the composition dispatched ~440 elementwise
kernels forward and ~620 backward. ``project_pack_bwd_plain`` is the
backward's specification: the chain rule in closed form, with autograd's
conventions at ties, which K5 transcribes line for line and the tests hold
against autograd through the plain forward.

The colour input is either SH coefficients ``[N, K, 3]`` (``sh_degree``
given) or colours ``[N, 3]`` or ``[C, N, 3]``. ``means2d_dummy`` is zeros by
contract (a gradient tap, as ``pair_dummy`` is for the compositor): its
gradient is the table's columns 0-1. The plain composition adds it to the
projected means; K4 does not read it, so a non-zero tap gives other tables on
the card than on the CPU. ``Ks`` take no gradient on the kernel path.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .projection import project_gaussians
from .sh import _C0, _C1, _C2, _C3, num_sh_bases, sh_to_color

CAMERA_MODELS = ("pinhole", "ortho", "fisheye")

# Column layout of the per-gaussian table row the compositor reads.
PACK_MX, PACK_MY = 0, 1
PACK_CA, PACK_CB, PACK_CC = 2, 3, 4
PACK_OPA = 5
PACK_R, PACK_G, PACK_B = 6, 7, 8
PACK_DEPTH = 9
NATTR = 10  # the columns above; the rest of a row is zeros
# Rows are 16 floats (64 bytes) so the kernels load them as four float4.
PACK_COLS = 16


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
            torch.zeros((c * n, PACK_COLS - NATTR), dtype=means2d.dtype, device=means2d.device),
        ],
        dim=1,
    ).contiguous()


def camera_colors(means, colors, viewmats, sh_degree, sh_mask):
    """[C, N, 3] colours of each camera, as ``render.rasterize`` made them."""
    c = viewmats.shape[0]
    if sh_degree is not None:
        # Camera centres from world->camera: c = -R^T t.
        centers = -torch.einsum("cji,cj->ci", viewmats[:, :3, :3], viewmats[:, :3, 3])
        dirs = means[None, :, :] - centers[:, None, :]
        return sh_to_color(colors[None].expand((c,) + colors.shape), dirs, sh_degree, basis_mask=sh_mask)
    if colors.dim() == 2:
        return colors[None].expand((c,) + colors.shape)
    return colors


def project_pack_plain(
    means, quats, scales, opacities, colors, viewmats, Ks, width, height, *,
    sh_degree=None, sh_mask=None, near_plane=0.01, far_plane=1e10,
    eps2d=0.3, antialiased=False, radius_clip=0.0, camera_model="pinhole",
    alive=None, means2d_dummy=None,
):
    """The composition projection -> colours -> pack, differentiable by
    autograd: (table [C*N, 16], radii [C, N], extents [C, N, 2], depths [C, N])."""
    proj = project_gaussians(
        means, quats, scales, opacities, viewmats, Ks, width, height,
        near_plane=near_plane, far_plane=far_plane, eps2d=eps2d, antialiased=antialiased,
        radius_clip=radius_clip, camera_model=camera_model, alive=alive,
    )
    means2d = proj.means2d if means2d_dummy is None else proj.means2d + means2d_dummy
    cam_colors = camera_colors(means, colors, viewmats, sh_degree, sh_mask)
    table = pack_table(means2d, proj.conics, proj.opacities, cam_colors, proj.depths)
    return table, proj.radii, proj.extents, proj.depths


# ------------------------------------------------- the backward, in closed form


def _mv(m, v):
    return [m[i][0] * v[0] + m[i][1] * v[1] + m[i][2] * v[2] for i in range(3)]


def _tmm(a, b):
    """a^T b of two 3x3 nested lists."""
    return [[a[0][i] * b[0][j] + a[1][i] * b[1][j] + a[2][i] * b[2][j] for j in range(3)] for i in range(3)]


def _mm(a, b):
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j] for j in range(3)] for i in range(3)]


def _sh_bases_and_grads(degree, x, y, z):
    """SH bases 1..(degree+1)^2-1 at the unit direction (x, y, z) and the
    partial derivatives of each: a list of (value, (d/dx, d/dy, d/dz))."""
    zero = torch.zeros_like(x)
    out = []
    if degree >= 1:
        out += [(-_C1 * y, (zero, zero - _C1, zero)), (_C1 * z, (zero, zero, zero + _C1)),
                (-_C1 * x, (zero - _C1, zero, zero))]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        out += [
            (_C2[0] * x * y, (_C2[0] * y, _C2[0] * x, zero)),
            (_C2[1] * y * z, (zero, _C2[1] * z, _C2[1] * y)),
            (_C2[2] * (2.0 * zz - xx - yy), (-2.0 * _C2[2] * x, -2.0 * _C2[2] * y, 4.0 * _C2[2] * z)),
            (_C2[3] * x * z, (_C2[3] * z, zero, _C2[3] * x)),
            (_C2[4] * (xx - yy), (2.0 * _C2[4] * x, -2.0 * _C2[4] * y, zero)),
        ]
    if degree >= 3:
        out += [
            (_C3[0] * y * (3.0 * xx - yy), (6.0 * _C3[0] * x * y, 3.0 * _C3[0] * (xx - yy), zero)),
            (_C3[1] * x * y * z, (_C3[1] * y * z, _C3[1] * x * z, _C3[1] * x * y)),
            (_C3[2] * y * (4.0 * zz - xx - yy),
             (-2.0 * _C3[2] * x * y, _C3[2] * (4.0 * zz - xx - 3.0 * yy), 8.0 * _C3[2] * y * z)),
            (_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
             (-6.0 * _C3[3] * x * z, -6.0 * _C3[3] * y * z, 3.0 * _C3[3] * (2.0 * zz - xx - yy))),
            (_C3[4] * x * (4.0 * zz - xx - yy),
             (_C3[4] * (4.0 * zz - 3.0 * xx - yy), -2.0 * _C3[4] * x * y, 8.0 * _C3[4] * x * z)),
            (_C3[5] * z * (xx - yy), (2.0 * _C3[5] * x * z, -2.0 * _C3[5] * y * z, _C3[5] * (xx - yy))),
            (_C3[6] * x * (xx - 3.0 * yy), (3.0 * _C3[6] * (xx - yy), -6.0 * _C3[6] * x * y, zero)),
        ]
    return out


def _camera_backward(camera_model, tx, ty, tz, fx, fy, width, height, near_plane, g_mx, g_my, dj):
    """Per camera model: the Jacobian J (2x3) and, when ``dj`` (its
    gradient, 2x3) is given, the gradient of (tx, ty, tz) from J and from
    the projected mean's gradient (g_mx, g_my)."""
    zeros = torch.zeros_like(tz)
    if camera_model == "pinhole":
        in_front = tz > near_plane
        inv_z = 1.0 / torch.where(in_front, tz, torch.ones_like(tz))
        lim_x, lim_y = 1.3 * (0.5 * width / fx), 1.3 * (0.5 * height / fy)
        u, v = tx * inv_z, ty * inv_z
        txz, tyz = torch.clamp(u, -lim_x, lim_x), torch.clamp(v, -lim_y, lim_y)
        jac = [[fx * inv_z, zeros, -fx * txz * inv_z], [zeros, fy * inv_z, -fy * tyz * inv_z]]
        if dj is None:
            return jac, None
        d_txz = dj[0][2] * (-fx) * inv_z
        d_tyz = dj[1][2] * (-fy) * inv_z
        d_inv = (dj[0][0] * fx + dj[0][2] * (-fx * txz) + dj[1][1] * fy + dj[1][2] * (-fy * tyz)
                 + g_mx * fx * tx + g_my * fy * ty)
        du = torch.where((u >= -lim_x) & (u <= lim_x), d_txz, 0.0)
        dv = torch.where((v >= -lim_y) & (v <= lim_y), d_tyz, 0.0)
        d_inv = d_inv + du * tx + dv * ty
        dtx = g_mx * fx * inv_z + du * inv_z
        dty = g_my * fy * inv_z + dv * inv_z
        dtz = torch.where(in_front, -d_inv * inv_z * inv_z, 0.0)
        return jac, (dtx, dty, dtz)
    if camera_model == "ortho":
        jac = [[fx + zeros, zeros, zeros], [zeros, fy + zeros, zeros]]
        return jac, None if dj is None else (g_mx * fx, g_my * fy, zeros)
    # fisheye
    r2 = tx * tx + ty * ty
    big = r2 >= 1e-12
    r = torch.sqrt(torch.clamp(r2, min=1e-12))
    theta = torch.atan2(r, tz)
    s = theta / r
    l2 = r2 + tz * tz
    den = l2 * r
    dth_dx, dth_dy, dth_dz = tz * tx / den, tz * ty / den, -r / l2
    p_x = dth_dx - s * tx / r
    p_y = dth_dy - s * ty / r
    ds_dx, ds_dy, ds_dz = p_x / r, p_y / r, dth_dz / r
    jac = [
        [fx * (s + tx * ds_dx), fx * tx * ds_dy, fx * tx * ds_dz],
        [fy * ty * ds_dx, fy * (s + ty * ds_dy), fy * ty * ds_dz],
    ]
    if dj is None:
        return jac, None
    g_s = g_mx * fx * tx + g_my * fy * ty + dj[0][0] * fx + dj[1][1] * fy
    dtx = g_mx * fx * s + dj[0][0] * fx * ds_dx + dj[0][1] * fx * ds_dy + dj[0][2] * fx * ds_dz
    dty = g_my * fy * s + dj[1][0] * fy * ds_dx + dj[1][1] * fy * ds_dy + dj[1][2] * fy * ds_dz
    g_dsdx = dj[0][0] * fx * tx + dj[1][0] * fy * ty
    g_dsdy = dj[0][1] * fx * tx + dj[1][1] * fy * ty
    g_dsdz = dj[0][2] * fx * tx + dj[1][2] * fy * ty
    # ds_* = p_* / r, ds_dz = dth_dz / r
    g_px, g_py, g_thz = g_dsdx / r, g_dsdy / r, g_dsdz / r
    g_r = -(g_dsdx * ds_dx + g_dsdy * ds_dy + g_dsdz * ds_dz) / r
    # p_x = dth_dx - s tx / r
    g_s = g_s - (g_px * tx + g_py * ty) / r
    dtx = dtx - g_px * s / r
    dty = dty - g_py * s / r
    g_r = g_r + (g_px * tx + g_py * ty) * s / (r * r)
    # dth_dz = -r / l2; dth_dx = tz tx / den, dth_dy = tz ty / den
    g_r = g_r - g_thz / l2
    g_l2 = g_thz * r / (l2 * l2)
    dtz = (g_px * tx + g_py * ty) / den
    dtx = dtx + g_px * tz / den
    dty = dty + g_py * tz / den
    g_den = -(g_px * tx + g_py * ty) * tz / (den * den)
    g_l2 = g_l2 + g_den * r
    g_r = g_r + g_den * l2
    # l2 = r2 + tz^2; s = theta / r; theta = atan2(r, tz)
    g_r2 = g_l2
    dtz = dtz + 2.0 * tz * g_l2
    g_th = g_s / r
    g_r = g_r - g_s * theta / (r * r)
    rec = 1.0 / (r * r + tz * tz)
    g_r = g_r + g_th * tz * rec
    dtz = dtz - g_th * r * rec
    # r = sqrt(max(r2, 1e-12)); r2 = tx^2 + ty^2
    g_r2 = g_r2 + torch.where(big, g_r / (2.0 * r), 0.0)
    dtx = dtx + 2.0 * tx * g_r2
    dty = dty + 2.0 * ty * g_r2
    return jac, (dtx, dty, dtz)


def project_pack_bwd_plain(
    dtable, means, quats, scales, opacities, colors, viewmats, Ks, width, height, *,
    sh_degree=None, sh_mask=None, near_plane=0.01, eps2d=0.3,
    antialiased=False, camera_model="pinhole", want_viewmats=True,
):
    """Gradients of ``project_pack_plain``'s table from ``dtable`` [C*N, 16],
    without autograd: (means, quats, scales, opacities, colors, viewmats),
    None where an input takes none. Recomputes the forward's
    intermediates, then applies the chain rule with autograd's conventions:
    a clamp passes the gradient at its bounds, ``where`` branches as taken
    (``det_safe``, the near-plane guard), the colour clamp passes where
    ``x >= 0``. The means2d tap's gradient is ``dtable[:, 0:2]``."""
    if camera_model not in CAMERA_MODELS:
        raise ValueError(f"unknown camera model {camera_model!r}")
    c, n = viewmats.shape[0], means.shape[0]
    g = dtable.reshape(c, n, PACK_COLS)
    g_mx, g_my, g_op, g_tz = g[..., 0], g[..., 1], g[..., 5], g[..., 9]
    g_ca, g_cb, g_cc = 0.5 * g[..., 2], g[..., 3], 0.5 * g[..., 4]  # the pack's halves

    w = [[viewmats[:, i, j, None] for j in range(3)] for i in range(3)]
    tr = [viewmats[:, i, 3, None] for i in range(3)]
    m = [means[None, :, k] for k in range(3)]
    tx, ty, tz = [w[i][0] * m[0] + w[i][1] * m[1] + w[i][2] * m[2] + tr[i] for i in range(3)]
    fx, fy = Ks[:, None, 0, 0], Ks[:, None, 1, 1]

    # Sigma3 = R diag(s^2) R^T from the normalised quaternion.
    qsq = torch.sum(quats * quats, dim=-1)
    qn_norm = torch.sqrt(torch.clamp(qsq, min=1e-24))
    qw, qx, qy, qz = (quats[:, k] / qn_norm for k in range(4))
    rot = [
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
    ]
    s2 = [scales[:, k] * scales[:, k] for k in range(3)]
    sig3 = [[sum(rot[i][k] * rot[j][k] * s2[k] for k in range(3)) for j in range(3)] for i in range(3)]
    sigc = _mm(_mm(w, sig3), [[w[j][i] for j in range(3)] for i in range(3)])  # W S3 W^T

    jac, _ = _camera_backward(camera_model, tx, ty, tz, fx, fy, width, height, near_plane, None, None, None)
    sj = [_mv(sigc, jac[0]), _mv(sigc, jac[1])]  # Sigma_c J_a^T
    v00 = sum(jac[0][k] * sj[0][k] for k in range(3))
    v01 = sum(jac[1][k] * sj[0][k] for k in range(3))
    v11 = sum(jac[1][k] * sj[1][k] for k in range(3))
    a, b, cc = v00 + eps2d, v01, v11 + eps2d
    det = a * cc - b * b
    pos = det > 0
    det_safe = torch.where(pos, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe

    # conic = (c, -b, a) / det_safe
    d_inv = g_ca * cc - g_cb * b + g_cc * a
    da, dc, db = g_cc * inv_det, g_ca * inv_det, -g_cb * inv_det
    d_safe = -d_inv * inv_det * inv_det
    opac = opacities[None, :]
    if antialiased:
        det_raw = v00 * v11 - v01 * v01
        ratio = det_raw / det_safe
        comp = torch.sqrt(torch.clamp(ratio, min=0.0))
        d_ratio = torch.where(ratio >= 0.0, g_op * opac / (2.0 * comp), 0.0)
        d_raw = d_ratio / det_safe
        d_safe = d_safe - d_ratio * ratio / det_safe
        dop = (g_op * comp).sum(0)
    else:
        d_raw = torch.zeros_like(det)
        dop = g_op.sum(0)
    d_det = torch.where(pos, d_safe, 0.0)
    dv00 = da + d_det * cc + d_raw * v11
    dv11 = dc + d_det * a + d_raw * v00
    dv01 = db - 2.0 * b * d_det - 2.0 * v01 * d_raw

    # V = J Sigma_c J^T
    dj = [[2.0 * dv00 * sj[0][k] + dv01 * sj[1][k] for k in range(3)],
          [dv01 * sj[0][k] + 2.0 * dv11 * sj[1][k] for k in range(3)]]
    dsc = [[dv00 * jac[0][i] * jac[0][j] + 0.5 * dv01 * (jac[0][i] * jac[1][j] + jac[0][j] * jac[1][i])
            + dv11 * jac[1][i] * jac[1][j] for j in range(3)] for i in range(3)]
    _, (dtx, dty, dtz) = _camera_backward(
        camera_model, tx, ty, tz, fx, fy, width, height, near_plane, g_mx, g_my, dj
    )
    dtz = dtz + g_tz

    # Sigma_c = W Sigma3 W^T; Sigma3 = R D R^T, D = diag(s^2)
    g3 = _tmm(w, _mm(dsc, w))  # [C, N] each
    g3 = [[x.sum(0) for x in row] for row in g3]
    g3r = _mm(g3, rot)
    drot = [[2.0 * g3r[i][k] * s2[k] for k in range(3)] for i in range(3)]
    dscales = torch.stack(
        [2.0 * scales[:, k] * sum(rot[i][k] * g3r[i][k] for i in range(3)) for k in range(3)], -1
    )
    dw_ = 2.0 * (qx * drot[2][1] - qx * drot[1][2] + qy * drot[0][2] - qy * drot[2][0]
                 + qz * drot[1][0] - qz * drot[0][1])
    dx_ = 2.0 * (qy * drot[0][1] + qz * drot[0][2] + qy * drot[1][0] - 2.0 * qx * drot[1][1]
                 - qw * drot[1][2] + qz * drot[2][0] + qw * drot[2][1] - 2.0 * qx * drot[2][2])
    dy_ = 2.0 * (-2.0 * qy * drot[0][0] + qx * drot[0][1] + qw * drot[0][2] + qx * drot[1][0]
                 + qz * drot[1][2] - qw * drot[2][0] + qz * drot[2][1] - 2.0 * qy * drot[2][2])
    dz_ = 2.0 * (-2.0 * qz * drot[0][0] - qw * drot[0][1] + qx * drot[0][2] + qw * drot[1][0]
                 - 2.0 * qz * drot[1][1] + qy * drot[1][2] + qx * drot[2][0] + qy * drot[2][1])
    dqn = torch.stack([dw_, dx_, dy_, dz_], -1)
    qn = quats / qn_norm[:, None]
    # q / sqrt(max(|q|^2, 1e-24)): the clamp passes where |q|^2 >= 1e-24.
    dot = torch.where(qsq >= 1e-24, (dqn * qn).sum(-1), 0.0)
    dquats = (dqn - dot[:, None] * qn) / qn_norm[:, None]

    dt = [dtx, dty, dtz]
    dmeans = torch.stack([sum(w[i][k] * dt[i] for i in range(3)).sum(0) for k in range(3)], -1)
    dview = None
    if want_viewmats:
        dview = torch.zeros_like(viewmats)
        dwc = _mm(_mm(dsc, w), sig3)  # Dfull W S3; dW = 2 of it
        for i in range(3):
            for j in range(3):
                dview[:, i, j] = (2.0 * dwc[i][j] + dt[i] * m[j]).sum(1)
            dview[:, i, 3] = dt[i].sum(1)

    g_rgb = g[..., 6:9]
    if sh_degree is not None:
        nb = num_sh_bases(sh_degree)
        coef = [colors[:, k] for k in range(nb)]  # [N, 3] each
        mask = [1.0] * nb if sh_mask is None else [sh_mask[k] for k in range(nb)]
        centers = [-(w[0][i] * tr[0] + w[1][i] * tr[1] + w[2][i] * tr[2]) for i in range(3)]  # [C, 1]
        dirs = [m[i] - centers[i] for i in range(3)]
        length = torch.sqrt(dirs[0] * dirs[0] + dirs[1] * dirs[1] + dirs[2] * dirs[2])
        lc = torch.clamp(length, min=1e-12)
        unit = [d / lc for d in dirs]
        bases = [(torch.full_like(lc, _C0), None)] + _sh_bases_and_grads(sh_degree, *unit)
        raw = sum(bases[k][0][..., None] * mask[k] * coef[k][None] for k in range(nb)) + 0.5
        g_raw = torch.where(raw >= 0.0, g_rgb, 0.0)
        dcoef = [(bases[k][0][..., None] * mask[k] * g_raw).sum(0) for k in range(nb)]
        dcolors = torch.zeros_like(colors)
        for k in range(nb):
            dcolors[:, k] = dcoef[k]
        if sh_degree > 0:
            dunit = [0.0, 0.0, 0.0]
            for k in range(1, nb):
                db_k = (coef[k][None] * g_raw).sum(-1) * mask[k]
                dunit = [dunit[i] + db_k * bases[k][1][i] for i in range(3)]
            d_lc = -(dunit[0] * dirs[0] + dunit[1] * dirs[1] + dunit[2] * dirs[2]) / (lc * lc)
            d_len = torch.where(length >= 1e-12, d_lc, 0.0)
            d_len = torch.where(length > 0, d_len / length, 0.0)
            ddirs = [dunit[i] / lc + d_len * dirs[i] for i in range(3)]
            dmeans = dmeans + torch.stack([d.sum(0) for d in ddirs], -1)
            if want_viewmats:
                dcen = [-d.sum(1) for d in ddirs]  # [C]
                for i in range(3):
                    for j in range(3):
                        dview[:, j, i] -= dcen[i] * tr[j][:, 0]
                        dview[:, j, 3] -= dcen[i] * w[j][i][:, 0]
    elif colors.dim() == 2:
        dcolors = g_rgb.sum(0)
    else:
        dcolors = g_rgb.clone()
    return dmeans, dquats, dscales, dop, dcolors, dview


# ------------------------------------------------------------ kernel wrappers


def _cam_code(camera_model):
    if camera_model not in CAMERA_MODELS:
        raise ValueError(f"unknown camera model {camera_model!r}")
    return CAMERA_MODELS.index(camera_model)


def _checked(name, x, shape, dtype=torch.float32):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or not x.is_cuda:
        raise ValueError(f"{name} must be a {dtype} CUDA tensor of shape {tuple(shape)}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    return x.contiguous()


def _ptr(x):
    return 0 if x is None else x.data_ptr()


class _Inputs:
    """The kernels' inputs, checked and contiguous, and the meta they need."""

    def __init__(self, means, quats, scales, opacities, colors, viewmats, Ks, sh_mask, alive, kw):
        n, c = means.shape[0], viewmats.shape[0]
        dev = means.device
        self.n, self.c = n, c
        self.means = _checked("means", means, (n, 3))
        self.quats = _checked("quats", quats, (n, 4))
        self.scales = _checked("scales", scales, (n, 3))
        self.opacities = _checked("opacities", opacities, (n,))
        self.viewmats = _checked("viewmats", viewmats, (c, 4, 4))
        self.Ks = _checked("Ks", Ks, (c, 3, 3))
        self.sh_degree = kw["sh_degree"]
        if self.sh_degree is not None:
            self.nb = num_sh_bases(self.sh_degree)
            k = colors.shape[1] if colors.dim() == 3 else -1
            self.colors = _checked("colors (SH)", colors, (n, k, 3))
            if k < self.nb:
                raise ValueError(f"SH degree {self.sh_degree} needs {self.nb} coefficients, got {k}")
            self.coefs = k
            self.sh_mask = None if sh_mask is None else _checked("sh_mask", sh_mask.float(), (self.nb,))
            self.color_stride = 0
        else:
            self.nb, self.coefs, self.sh_mask = 0, 0, None
            shape = (n, 3) if colors.dim() == 2 else (c, n, 3)
            self.colors = _checked("colors", colors, shape)
            self.color_stride = 0 if colors.dim() == 2 else n * 3
        self.alive = None if alive is None else _checked("alive", alive, (n,), torch.bool)
        for name, x in (("Ks", Ks), ("colors", colors), ("viewmats", viewmats)):
            if x.device != dev:
                raise ValueError(f"{name} is on {x.device}, means on {dev}")
        self.cam = _cam_code(kw["camera_model"])
        self.kw = kw


def project_pack_fwd(inp: _Inputs, width: int, height: int):
    """K4: (table [C*N, 16], radii [C, N] int32, extents [C, N, 2] int32)."""
    c, n, kw = inp.c, inp.n, inp.kw
    dev = inp.means.device
    table = torch.empty((c * n, PACK_COLS), dtype=torch.float32, device=dev)
    radii = torch.empty((c, n), dtype=torch.int32, device=dev)
    extents = torch.empty((c, n, 2), dtype=torch.int32, device=dev)
    kernels.launch(
        "project_pack_fwd", inp.means,
        inp.means.data_ptr(), inp.quats.data_ptr(), inp.scales.data_ptr(), inp.opacities.data_ptr(),
        inp.colors.data_ptr(), _ptr(inp.sh_mask), _ptr(inp.alive),
        inp.viewmats.data_ptr(), inp.Ks.data_ptr(), table.data_ptr(), radii.data_ptr(), extents.data_ptr(),
        n, c, width, height, inp.cam, int(kw["antialiased"]), inp.nb, inp.coefs, inp.color_stride,
        float(kw["near_plane"]), float(kw["far_plane"]), float(kw["eps2d"]), float(kw["radius_clip"]),
    )
    return table, radii, extents


def project_pack_bwd(inp: _Inputs, dtable: torch.Tensor, width: int, height: int, want_viewmats: bool):
    """K5: the gradients of ``project_pack_bwd_plain``, in its order."""
    c, n, kw = inp.c, inp.n, inp.kw
    dtable = _checked("dtable", dtable, (c * n, PACK_COLS))
    e = torch.empty_like
    dmeans, dquats, dscales, dop = e(inp.means), e(inp.quats), e(inp.scales), e(inp.opacities)
    dcolors = e(inp.colors)
    dview = torch.zeros_like(inp.viewmats) if want_viewmats else None
    kernels.launch(
        "project_pack_bwd", inp.means,
        inp.means.data_ptr(), inp.quats.data_ptr(), inp.scales.data_ptr(), inp.opacities.data_ptr(),
        inp.colors.data_ptr(), _ptr(inp.sh_mask), inp.viewmats.data_ptr(), inp.Ks.data_ptr(),
        dtable.data_ptr(), dmeans.data_ptr(), dquats.data_ptr(), dscales.data_ptr(), dop.data_ptr(),
        dcolors.data_ptr(), _ptr(dview),
        n, c, width, height, inp.cam, int(kw["antialiased"]), inp.nb, inp.coefs, inp.color_stride,
        float(kw["near_plane"]), float(kw["eps2d"]),
    )
    return dmeans, dquats, dscales, dop, dcolors, dview


class _ProjectPack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, means, quats, scales, opacities, colors, viewmats, Ks, means2d_dummy,
                sh_mask, alive, width, height, kw):
        del means2d_dummy  # zeros by contract: its gradient is dtable[:, 0:2]
        inp = _Inputs(means, quats, scales, opacities, colors, viewmats, Ks, sh_mask, alive, kw)
        table, radii, extents = project_pack_fwd(inp, width, height)
        ctx.mark_non_differentiable(radii, extents)
        # Saved through autograd, so an input changed in place before the
        # backward raises instead of giving gradients of other values.
        ctx.save_for_backward(means, quats, scales, opacities, colors, viewmats, Ks, sh_mask)
        ctx.size, ctx.kw = (width, height), kw
        return table, radii, extents

    @staticmethod
    def backward(ctx, dtable, _dradii, _dextents):
        need = ctx.needs_input_grad
        if need[6]:
            raise ValueError("project_pack gives Ks no gradient on the kernel path")
        means, quats, scales, opacities, colors, viewmats, Ks, sh_mask = ctx.saved_tensors
        inp = _Inputs(means, quats, scales, opacities, colors, viewmats, Ks, sh_mask, None, ctx.kw)
        dmeans, dquats, dscales, dop, dcolors, dview = project_pack_bwd(
            inp, dtable, *ctx.size, want_viewmats=need[5]
        )
        ddummy = dtable[:, :2].reshape(inp.c, inp.n, 2) if need[7] else None
        return (dmeans, dquats, dscales, dop, dcolors, dview, None, ddummy) + (None,) * 5


def project_pack(
    means: torch.Tensor,  # [N, 3]
    quats: torch.Tensor,  # [N, 4]
    scales: torch.Tensor,  # [N, 3] post-activation
    opacities: torch.Tensor,  # [N] post-activation
    colors: torch.Tensor,  # [N, 3] / [C, N, 3] rgb, or [N, K, 3] SH with sh_degree
    viewmats: torch.Tensor,  # [C, 4, 4] world->camera
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    *,
    sh_degree: Optional[int] = None,
    sh_mask: Optional[torch.Tensor] = None,  # [num_bases] 0/1 schedule mask
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    eps2d: float = 0.3,
    antialiased: bool = False,
    radius_clip: float = 0.0,
    camera_model: str = "pinhole",
    alive: Optional[torch.Tensor] = None,  # [N] bool capacity mask
    means2d_dummy: Optional[torch.Tensor] = None,  # [C, N, 2] zeros; grad tap
):
    """Project, colour and pack: (table [C*N, 16], radii [C, N] int32,
    extents [C, N, 2] int32, depths [C, N]). K4 / K5 for CUDA tensors, the
    plain composition for CPU tensors (see the module docstring)."""
    kw = dict(
        sh_degree=sh_degree, near_plane=near_plane, far_plane=far_plane, eps2d=eps2d,
        antialiased=antialiased, radius_clip=radius_clip, camera_model=camera_model,
    )
    if not means.is_cuda:
        return project_pack_plain(
            means, quats, scales, opacities, colors, viewmats, Ks, width, height,
            sh_mask=sh_mask, alive=alive, means2d_dummy=means2d_dummy, **kw,
        )
    table, radii, extents = _ProjectPack.apply(
        means, quats, scales, opacities, colors, viewmats, Ks, means2d_dummy,
        sh_mask, alive, width, height, kw,
    )
    depths = table[:, 9].view(viewmats.shape[0], means.shape[0])
    return table, radii, extents, depths
