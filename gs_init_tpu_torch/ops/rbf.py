"""Thin-plate-spline RBF interpolation — port of ``gs_init_tpu/ops/rbf.py``:
a dense masked solve (``torch.linalg.solve``; the JAX package leaves its
solve to XLA too) and evaluation on a coarse grid, bilinearly upsampled.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _tps_kernel(r2: torch.Tensor) -> torch.Tensor:
    # phi(r) = r^2 log r = 0.5 r^2 log r^2, with phi(0) = 0.
    return 0.5 * r2 * torch.log(torch.clamp(r2, min=1e-20))


def tps_fit(
    centers: torch.Tensor,  # [M, 2] (padded)
    values: torch.Tensor,  # [M]
    valid: torch.Tensor,  # [M] bool
    smoothing: float = 0.0,
):
    """Fit a 2-D thin-plate spline with an affine part. Padded centres get
    identity rows, so the solve stays well posed and their weights are 0.
    Returns (weights [M], poly coefficients (1, x, y) [3])."""
    m = centers.shape[0]
    dev = centers.device
    v = valid.float()
    eye = torch.eye(m, device=dev)
    d = centers[:, None, :] - centers[None, :, :]
    K = _tps_kernel((d * d).sum(-1)) + smoothing * eye
    K = K * v[:, None] * v[None, :] + (1.0 - v)[:, None] * eye
    P = torch.cat([torch.ones((m, 1), device=dev), centers], dim=1) * v[:, None]
    A = torch.cat(
        [torch.cat([K, P], dim=1), torch.cat([P.T, torch.zeros((3, 3), device=dev)], dim=1)]
    )
    A = A + 1e-8 * torch.eye(m + 3, device=dev)  # a ridge for degenerate layouts
    rhs = torch.cat([values * v, torch.zeros(3, device=dev)])
    sol = torch.linalg.solve(A, rhs)
    return sol[:m], sol[m:]


def tps_eval(
    centers: torch.Tensor,  # [M, 2]
    weights: torch.Tensor,  # [M]
    poly: torch.Tensor,  # [3]
    queries: torch.Tensor,  # [Q, 2]
) -> torch.Tensor:
    d = queries[:, None, :] - centers[None, :, :]
    return _tps_kernel((d * d).sum(-1)) @ weights + poly[0] + queries @ poly[1:]


def upsample_bilinear(coarse: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[h, w] -> [height, width], bilinear with half-pixel centres and edge
    samples clamped to the border: the JAX package's
    ``jax.image.resize(..., "bilinear")`` when it enlarges."""
    return F.interpolate(
        coarse[None, None], size=(height, width), mode="bilinear", align_corners=False,
        antialias=False,
    )[0, 0]


def tps_interpolate_grid(
    centers: torch.Tensor,
    values: torch.Tensor,
    valid: torch.Tensor,
    height: int,
    width: int,
    grid_width: int = 256,
    smoothing: float = 1e-6,
) -> torch.Tensor:
    """Dense [H, W] map: the TPS on a grid at most ``grid_width`` wide,
    bilinearly upsampled."""
    w, p = tps_fit(centers, values, valid, smoothing=smoothing)
    gw = min(grid_width, width)
    gh = max(int(round(height * gw / width)), 1)
    dev = centers.device
    xs = (torch.arange(gw, device=dev, dtype=torch.float32) + 0.5) * (width / gw)
    ys = (torch.arange(gh, device=dev, dtype=torch.float32) + 0.5) * (height / gh)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    q = torch.stack([gx, gy], dim=-1).reshape(-1, 2)
    coarse = tps_eval(centers, w, p, q).reshape(gh, gw)
    return upsample_bilinear(coarse, height, width)
