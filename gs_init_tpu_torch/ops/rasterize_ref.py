"""Dense differentiable rasterizer, O(N x pixels) with no binning — port of
``gs_init_tpu/ops/rasterize_ref.py``.

The correctness oracle for the tile compositor (``ops/rasterize.py``): it
composites every valid gaussian against every pixel in global depth order,
with gradients from autograd. Pixels go in chunks, each under
``torch.utils.checkpoint`` so the backward recomputes alpha per chunk and
its memory stays O(N x pixel_chunk) (the JAX version's ``jax.checkpoint``).

Semantics:
  sigma = 0.5 (A dx^2 + C dy^2) + B dx dy
  alpha = min(opacity * exp(-sigma), 0.999), dropped when alpha < 1/255
  C(p)  = sum_i c_i alpha_i prod_{j<i} (1 - alpha_j) + T_final * background
plus the accumulated depth (expected depth = depth / alpha).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .projection import Projected

ALPHA_MAX = 0.999
ALPHA_MIN = 1.0 / 255.0
PAD_PIXEL = -1e6  # padding pixels sit far outside every gaussian


def pixel_grid(width: int, height: int, device=None) -> torch.Tensor:
    """Pixel centres (x + 0.5, y + 0.5), row-major, [H*W, 2]."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack([xs + 0.5, ys + 0.5], dim=-1).reshape(-1, 2)


def padded_pixel_chunks(width: int, height: int, pixel_chunk: int, device=None) -> torch.Tensor:
    """The pixel grid padded with far-away pixels to whole chunks,
    [n_chunks, pixel_chunk, 2]."""
    pix = pixel_grid(width, height, device)
    pad = (-pix.shape[0]) % pixel_chunk
    pix = torch.cat([pix, torch.full((pad, 2), PAD_PIXEL, device=device)])
    return pix.reshape(-1, pixel_chunk, 2)


def alpha_at(
    means2d: torch.Tensor,  # [N, 2]
    conics: torch.Tensor,  # [N, 3]
    opacities: torch.Tensor,  # [N]
    valid: torch.Tensor,  # [N] bool
    pix: torch.Tensor,  # [P, 2]
    radii: Optional[torch.Tensor] = None,  # [N] for the tile-consistency filter
    tile_size: Optional[int] = None,
    extents: Optional[torch.Tensor] = None,  # [N, 2] per-axis half-extents
) -> torch.Tensor:
    """Per-gaussian, per-pixel alpha [N, P].

    With ``tile_size`` a gaussian reaches only pixels whose tile meets its
    support box, as the tile binning does: the elliptical per-axis box when
    ``extents`` is given, else the bounding circle of ``radii``."""
    dx = pix[None, :, 0] - means2d[:, None, 0]
    dy = pix[None, :, 1] - means2d[:, None, 1]
    a, b, c = conics[:, 0:1], conics[:, 1:2], conics[:, 2:3]
    sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    alpha = torch.clamp(opacities[:, None] * torch.exp(-sigma), max=ALPHA_MAX)
    ok = valid[:, None] & (sigma >= 0.0) & (alpha >= ALPHA_MIN)
    if tile_size is not None:
        ts = float(tile_size)
        if extents is not None:
            rx = extents[:, 0].float()[:, None]
            ry = extents[:, 1].float()[:, None]
        else:
            rx = ry = radii.float()[:, None]
        ptx = torch.floor(pix[None, :, 0] / ts)
        pty = torch.floor(pix[None, :, 1] / ts)
        gx0 = torch.floor((means2d[:, None, 0] - rx) / ts)
        gx1 = torch.floor((means2d[:, None, 0] + rx) / ts)
        gy0 = torch.floor((means2d[:, None, 1] - ry) / ts)
        gy1 = torch.floor((means2d[:, None, 1] + ry) / ts)
        ok = ok & (ptx >= gx0) & (ptx <= gx1) & (pty >= gy0) & (pty <= gy1)
    return torch.where(ok, alpha, torch.zeros((), dtype=alpha.dtype, device=alpha.device))


def composite_chunk(
    alpha: torch.Tensor,  # [N, P] in depth order
    colors: torch.Tensor,  # [N, 3]
    depths: torch.Tensor,  # [N]
    t_in: torch.Tensor,  # [P] incoming transmittance
):
    """Front-to-back compositing of one gaussian chunk: exclusive
    transmittance products as a cumulative sum in log space. Returns
    (colour [P, 3], depth [P], acc [P], t_out [P]); acc is t_in - t_out, so
    it stays in [0, 1] under f32 rounding."""
    log1m = torch.log1p(-alpha)
    log_t_excl = torch.cumsum(log1m, dim=0) - log1m
    w = alpha * torch.exp(log_t_excl) * t_in[None, :]
    color = torch.einsum("np,nc->pc", w, colors)
    depth = torch.einsum("np,n->p", w, depths)
    t_out = t_in * torch.exp(torch.sum(log1m, dim=0))
    return color, depth, t_in - t_out, t_out


def depth_order(depths: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Stable front-to-back order with culled gaussians last."""
    key = torch.where(valid, depths, torch.full_like(depths, float("inf")))
    return torch.argsort(key, stable=True)


def _render_chunk(pix, means2d, conics, opac, depths, valid, radii, cols, exts, tile_size):
    alpha = alpha_at(means2d, conics, opac, valid, pix, radii, tile_size, extents=exts)
    t0 = torch.ones(pix.shape[0], dtype=alpha.dtype, device=alpha.device)
    color, depth, acc, _ = composite_chunk(alpha, cols, depths, t0)
    return color, depth, acc


def rasterize_reference(
    proj: Projected,
    colors: torch.Tensor,  # [C, N, 3]
    width: int,
    height: int,
    backgrounds: Optional[torch.Tensor] = None,  # [C, 3]
    pixel_chunk: int = 4096,
    tile_size: Optional[int] = None,
):
    """Render colour [C, H, W, 3], alpha [C, H, W] and accumulated depth
    [C, H, W] (divide by alpha for the expected depth)."""
    dev = proj.means2d.device
    npix = width * height
    chunks = padded_pixel_chunks(width, height, pixel_chunk, dev)
    grad = torch.is_grad_enabled()
    out_c, out_d, out_a = [], [], []
    for ci in range(proj.means2d.shape[0]):
        valid = proj.radii[ci] > 0
        order = depth_order(proj.depths[ci], valid)
        args = (
            proj.means2d[ci][order], proj.conics[ci][order], proj.opacities[ci][order],
            proj.depths[ci][order], valid[order], proj.radii[ci][order], colors[ci][order],
            None if proj.extents is None else proj.extents[ci][order],
        )
        parts = [
            checkpoint(_render_chunk, pix, *args, tile_size, use_reentrant=False)
            if grad
            else _render_chunk(pix, *args, tile_size)
            for pix in chunks
        ]
        out_c.append(torch.cat([p[0] for p in parts])[:npix].reshape(height, width, 3))
        out_d.append(torch.cat([p[1] for p in parts])[:npix].reshape(height, width))
        out_a.append(torch.cat([p[2] for p in parts])[:npix].reshape(height, width))
    color, depth, acc = torch.stack(out_c), torch.stack(out_d), torch.stack(out_a)
    if backgrounds is not None:
        color = color + (1.0 - acc)[..., None] * backgrounds[:, None, None, :]
    return color, acc, depth
