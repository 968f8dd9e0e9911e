"""Camera-pose, appearance and bilateral-grid optimisation modules — port of
``gs_init_tpu/engine/appearance.py``.

- Pose: per-image 9D deltas (3 translation + 6D rotation, Zhou et al.)
  right-multiplied onto camtoworld.
- Appearance: per-image embedding + per-gaussian feature + SH-basis view
  encoding -> MLP colour residual.
- Bilateral grid: per-view [L, H, W, 12] grids of 3x4 colour affines
  sliced with grayscale guidance, a total-variation regulariser, and
  ``color_correct``, the quadratic-expansion least-squares warp of eval.
- The low-rank CP4D grid (a rank-R CP decomposition of a 4D affine grid).

Plain tensors and dataclasses of tensors plus functions, so each group is
one more optimiser group of the train step. Random initialisations take a
``torch.Generator``. ``_clip`` takes the gradient at a bound the way
``jnp.clip`` does (half to each side), so gradients match the JAX package
where a pixel's grey value is exactly 0 or 1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.sh import eval_sh_bases, num_sh_bases


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: maximum then minimum, whose gradients split ties."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


# ------------------------------------------------------------------ pose opt


def init_pose_params(
    n_images: int, std: float = 0.0, generator: Optional[torch.Generator] = None, device=None
) -> torch.Tensor:
    """[n, 9] pose deltas; zero, or normal with ``std`` (pose noise)."""
    if std > 0:
        return std * torch.randn((n_images, 9), generator=generator, device=device)
    return torch.zeros((n_images, 9), device=device)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Zhou et al. continuous 6D rotation -> 3x3 matrix. [..., 6] -> [..., 3, 3]."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True), min=1e-8)
    a2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2 / torch.clamp(torch.linalg.norm(a2, dim=-1, keepdim=True), min=1e-8)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def apply_pose_deltas(
    camtoworlds: torch.Tensor,  # [B, 4, 4]
    pose_params: torch.Tensor,  # [n_images, 9]
    image_ids: torch.Tensor,  # [B]
) -> torch.Tensor:
    deltas = pose_params[image_ids]
    dx, drot = deltas[..., :3], deltas[..., 3:]
    identity = torch.tensor([1.0, 0, 0, 0, 1.0, 0], device=deltas.device)
    rot = rotation_6d_to_matrix(drot + identity)
    b = camtoworlds.shape[0]
    bottom = torch.tensor([0.0, 0, 0, 1.0], device=deltas.device).expand(b, 1, 4)
    transform = torch.cat([torch.cat([rot, dx[:, :, None]], dim=2), bottom], dim=1)
    return camtoworlds @ transform


# ------------------------------------------------------------ appearance opt


@dataclass
class AppearanceParams:
    embeds: torch.Tensor  # [n_images, embed_dim]
    features: torch.Tensor  # [CAP, feature_dim] per gaussian
    w0: torch.Tensor
    b0: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def _glorot(shape, generator, device) -> torch.Tensor:
    limit = float(np.sqrt(6.0 / (shape[0] + shape[1])))
    u = torch.rand(shape, generator=generator, device=device)
    return (2.0 * u - 1.0) * limit


def init_appearance_params(
    generator: torch.Generator,
    n_images: int,
    capacity: int,
    feature_dim: int = 32,
    embed_dim: int = 16,
    sh_degree: int = 3,
    mlp_width: int = 64,
    device=None,
) -> AppearanceParams:
    """Zero embeddings and features, Glorot-uniform MLP weights, zero biases."""
    in_dim = embed_dim + feature_dim + num_sh_bases(sh_degree)
    z = lambda *shape: torch.zeros(shape, device=device)
    return AppearanceParams(
        embeds=z(n_images, embed_dim),
        features=z(capacity, feature_dim),
        w0=_glorot((in_dim, mlp_width), generator, device),
        b0=z(mlp_width),
        w1=_glorot((mlp_width, mlp_width), generator, device),
        b1=z(mlp_width),
        w2=_glorot((mlp_width, 3), generator, device),
        b2=z(3),
    )


def appearance_colors(
    params: AppearanceParams,
    image_ids: torch.Tensor,  # [C]
    dirs: torch.Tensor,  # [C, N, 3]
    active_sh_degree: int,
    max_sh_degree: int,
) -> torch.Tensor:
    """MLP colour residual [C, N, 3] (the caller adds sh0 and takes the sigmoid)."""
    c, n = dirs.shape[:2]
    ndirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-8)
    bases = eval_sh_bases(max_sh_degree, ndirs)
    # Zero the bases above the active degree.
    kidx = torch.arange(bases.shape[-1], device=dirs.device)
    bases = torch.where(kidx < (active_sh_degree + 1) ** 2, bases, 0.0)
    embeds = params.embeds[image_ids][:, None, :].expand(c, n, params.embeds.shape[-1])
    feats = params.features[None].expand(c, n, params.features.shape[-1])
    h = torch.cat([embeds, feats, bases], dim=-1)
    h = torch.relu(h @ params.w0 + params.b0)
    h = torch.relu(h @ params.w1 + params.b1)
    return h @ params.w2 + params.b2


# ------------------------------------------------------------ bilateral grid


def init_bilateral_grids(n_images: int, shape=(16, 16, 8), device=None) -> torch.Tensor:
    """[n, L, H, W, 12] grids initialised to the identity 3x4 affine."""
    gw, gh, gl = shape
    identity = torch.tensor([1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0], device=device)
    return identity.repeat(n_images, gl, gh, gw, 1)


def _rgb2gray(rgb: torch.Tensor) -> torch.Tensor:
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


class _GridCorner(torch.autograd.Function):
    """``grids[img, z, y, x]`` (the corner's [.., 12] affines) whose
    backward is an ``index_add_`` over the flattened grid cells (atomic adds
    on the card). Advanced indexing's own backward sorts its 1.1M indices at
    1296x840 (12.35 ms per step for the 8 corners), and ``index_select`` /
    ``gather``'s row-gather forward took 5.25 ms (PERF.md §5)."""

    @staticmethod
    def forward(ctx, grids, img, z, y, x):
        _, gl, gh, gw, _ = grids.shape
        ctx.save_for_backward(((img * gl + z) * gh + y) * gw + x)
        ctx.shape = grids.shape
        return grids[img, z, y, x]

    @staticmethod
    def backward(ctx, grad):
        (flat,) = ctx.saved_tensors
        cells = grad.new_zeros((ctx.shape.numel() // 12, 12))
        cells.index_add_(0, flat.reshape(-1), grad.reshape(-1, 12))
        return cells.reshape(ctx.shape), None, None, None, None


def slice_bilateral_grid(
    grids: torch.Tensor,  # [n, L, H, W, 12]
    rgb: torch.Tensor,  # [B, H_img, W_img, 3] rendered colours (guidance and input)
    image_ids: torch.Tensor,  # [B]
) -> torch.Tensor:
    """Trilinear slice at (x, y, grey) -> a 3x4 affine applied to rgb."""
    b, hi, wi, _ = rgb.shape
    _, gl, gh, gw, _ = grids.shape
    dev = rgb.device
    gray = _clip(_rgb2gray(rgb), 0.0, 1.0)
    xs = (torch.arange(wi, dtype=torch.float32, device=dev) + 0.5) / wi * (gw - 1)
    ys = (torch.arange(hi, dtype=torch.float32, device=dev) + 0.5) / hi * (gh - 1)
    zs = gray * (gl - 1)
    x = xs[None, None, :].expand(b, hi, wi)
    y = ys[None, :, None].expand(b, hi, wi)

    def tri(coord, size):
        c0 = torch.clamp(torch.floor(coord).long(), 0, size - 2)
        return c0, _clip(coord - c0, 0.0, 1.0)

    x0, fx = tri(x, gw)
    y0, fy = tri(y, gh)
    z0, fz = tri(zs, gl)
    img = image_ids.long()[:, None, None].expand(b, hi, wi)
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                wgt = (fz if dz else 1 - fz) * (fy if dy else 1 - fy) * (fx if dx else 1 - fx)
                corner = _GridCorner.apply(grids, img, z0 + dz, y0 + dy, x0 + dx)
                out = out + wgt[..., None] * corner
    aff = out.reshape(b, hi, wi, 3, 4)
    return torch.einsum("bhwij,bhwj->bhwi", aff[..., :3], rgb) + aff[..., 3]


def total_variation_loss(grids: torch.Tensor) -> torch.Tensor:
    """Mean squared difference between neighbouring grid cells (3 axes)."""
    tv = 0.0
    for ax in (1, 2, 3):
        d = torch.diff(grids, dim=ax)
        tv = tv + torch.mean(d * d)
    return tv


def color_correct(
    img: torch.Tensor, ref: torch.Tensor, num_iters: int = 5, eps: float = 0.5 / 255
) -> torch.Tensor:
    """Per-channel quadratic-expansion least-squares colour warp of ``img``
    toward ``ref`` (eval's cc_psnr). The fit is one direct solve, as the
    JAX package's is: ``num_iters`` and ``eps`` keep its signature and, as
    there, change nothing.

    ``jnp.linalg.lstsq(rcond=None)`` returns the minimum-norm solution and
    drops singular values below eps(f32) * max(M, N) of the largest; a flat
    or saturated image makes the [H*W, 10] expansion rank-deficient. Here
    the 10x10 normal matrix is formed in float64 and inverted by ``pinv``
    with the squared cut (its eigenvalues are the squared singular values),
    which gives the same minimum-norm solution on every device."""
    x = img.reshape(-1, 3).double()
    y = ref.reshape(-1, 3).double()
    feats = torch.cat(
        [
            x,
            x[:, :1] * x[:, 1:2],
            x[:, :1] * x[:, 2:3],
            x[:, 1:2] * x[:, 2:3],
            x * x,
            torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device),
        ],
        dim=1,
    )
    rcond = float(np.finfo(np.float32).eps) * max(feats.shape)
    pinv = torch.linalg.pinv(feats.T @ feats, rtol=rcond * rcond, hermitian=True)
    w = pinv @ (feats.T @ y)  # [10, 3], one column per channel
    out = torch.clamp(feats @ w, 0.0, 1.0)
    return out.to(img.dtype).reshape(img.shape)


# ------------------------------------------------------------------ CP4D grid


@dataclass
class CP4DGridParams:
    """Low-rank 4D bilateral grid: a rank-R CP decomposition of a
    (12, W, Z, Y, X) affine grid over (grey, z, y, x). ``fac0`` mixes the
    rank coefficients into 3x4 affines; each spatial dimension has a frozen
    init factor and a learnable residual (TV-regularised), sampled by 1-D
    linear interpolation."""

    fac0: torch.Tensor  # [12, rank]
    facs_init: Tuple[torch.Tensor, ...]  # 4 x [rank, grid_dim], frozen (x, y, z, w)
    facs_resid: Tuple[torch.Tensor, ...]  # 4 x [rank, grid_dim], learnable
    gray_w: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]  # rgb -> grey MLP (W, b), or ()


_IDENTITY_AFFINE = np.eye(3, 4, dtype=np.float32).reshape(12)


def init_cp4d_grid(
    generator: torch.Generator,
    grid_x: int = 16,
    grid_y: int = 16,
    grid_z: int = 16,
    grid_w: int = 8,
    rank: int = 5,
    learn_gray: bool = True,
    gray_mlp_width: int = 8,
    gray_mlp_depth: int = 2,
    init_noise_scale: float = 1e-6,
    device=None,
) -> CP4DGridParams:
    """Identity-affine init: the identity grid is exactly rank 1, so column
    0 carries it and the other rank columns start at noise scale."""
    randn = lambda *shape: torch.randn(shape, generator=generator, device=device)
    fac0 = torch.cat(
        [
            torch.as_tensor(_IDENTITY_AFFINE, device=device)[:, None],
            init_noise_scale * randn(12, rank - 1),
        ],
        dim=1,
    )
    dims = (grid_x, grid_y, grid_z, grid_w)
    facs_init = tuple(
        torch.cat([torch.ones((1, d), device=device), init_noise_scale * randn(rank - 1, d)], dim=0)
        for d in dims
    )
    facs_resid = tuple(torch.zeros((rank, d), device=device) for d in dims)
    gray_w = ()
    if learn_gray:
        widths = [3] + [gray_mlp_width] * (gray_mlp_depth - 1) + [1]
        gray_w = tuple(
            (randn(widths[i], widths[i + 1]) * (1.0 / np.sqrt(widths[i])),
             torch.zeros((widths[i + 1],), device=device))
            for i in range(len(widths) - 1)
        )
    return CP4DGridParams(fac0=fac0, facs_init=facs_init, facs_resid=facs_resid, gray_w=gray_w)


def _interp1d(fac: torch.Tensor, coord: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of the [rank, G] rows at coord in [-1, 1]
    (grid_sample with align_corners=True and border padding). [N, rank]."""
    g = fac.shape[1]
    t = _clip((coord + 1.0) * 0.5, 0.0, 1.0) * (g - 1)
    i0 = torch.clamp(torch.floor(t).long(), 0, g - 1)
    i1 = torch.clamp(i0 + 1, 0, g - 1)
    f = t - i0
    return fac.T[i0] * (1.0 - f[:, None]) + fac.T[i1] * f[:, None]


def cp4d_rgb2gray(params: CP4DGridParams, rgb: torch.Tensor) -> torch.Tensor:
    """Guidance in [-1, 1]: the learnable MLP (2 tanh) or BT.601 weights."""
    if params.gray_w:
        h = rgb
        n = len(params.gray_w)
        for i, (w, b) in enumerate(params.gray_w):
            h = h @ w + b
            if i < n - 1:
                h = torch.relu(h)
        return 2.0 * torch.tanh(h[..., 0])
    return rgb @ rgb.new_tensor([0.299, 0.587, 0.114]) * 2.0 - 1.0


def slice_cp4d_grid(
    params: CP4DGridParams,
    xyz: torch.Tensor,  # [..., 3] world coordinates
    rgb: torch.Tensor,  # [..., 3]
    bound: float = 2.0,
) -> torch.Tensor:
    """Per-point 3x4 colour affines from the low-rank grid, [..., 3, 4]."""
    sh = xyz.shape[:-1]
    x = xyz.reshape(-1, 3) / bound
    c = rgb.reshape(-1, 3)
    coords = [x[:, 0], x[:, 1], x[:, 2], cp4d_rgb2gray(params, c)]
    coef = torch.ones((x.shape[0], params.fac0.shape[1]), device=x.device)
    for fac_i, fac_r, co in zip(params.facs_init, params.facs_resid, coords):
        coef = coef * _interp1d(fac_i + fac_r, co)
    mat = coef @ params.fac0.T  # [N, 12]
    return mat.reshape(*sh, 3, 4)


def cp4d_apply(params: CP4DGridParams, xyz, rgb, bound: float = 2.0) -> torch.Tensor:
    """The sliced affine applied to rgb, [..., 3]."""
    m = slice_cp4d_grid(params, xyz, rgb, bound)
    return torch.einsum("...ij,...j->...i", m[..., :3], rgb) + m[..., 3]


def cp4d_tv_loss(params: CP4DGridParams) -> torch.Tensor:
    """TV on the learnable factor residuals."""
    tv = params.fac0.new_zeros(())
    for fac in params.facs_resid:
        d = fac[:, 1:] - fac[:, :-1]
        tv = tv + torch.mean(d * d)
    return tv
