"""Thin-plate-spline RBF interpolation — port of ``gs_init_tpu/ops/rbf.py``:
a dense masked solve (``torch.linalg.solve``; the JAX package leaves its
solve to XLA too) and evaluation on a coarse grid, bilinearly upsampled.

``tps_interpolate_grid`` fits on the valid centres alone (the JAX
package's identity rows for the others leave the result as it is) and
fits and evaluates in float64, the grid in blocks of ``EVAL_BLOCK``
queries. At pixel coordinates the kernel reaches 10^7 and the system is
ill-conditioned: in float32 (as the JAX package solves it) 3,000
clustered centres with values 1 +- 3e-4 give a map from 0.75 to 1.39
over the frame, in float64 from 0.976 to 1.002.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# Grid queries per block of the evaluation: a [block, M] float64 kernel
# matrix, 0.33 GB at M = 5,000 (max_rbf_points).
EVAL_BLOCK = 8192


def _tps_kernel(r2: torch.Tensor) -> torch.Tensor:
    # phi(r) = r^2 log r = 0.5 r^2 log r^2, with phi(0) = 0.
    return 0.5 * r2 * torch.log(torch.clamp(r2, min=1e-20))


def tps_fit(
    centers: torch.Tensor,  # [M, 2] (padded)
    values: torch.Tensor,  # [M]
    valid: Optional[torch.Tensor] = None,  # [M] bool; None: all
    smoothing: float = 0.0,
):
    """Fit a 2-D thin-plate spline with an affine part. Padded centres get
    identity rows, so the solve stays well posed and their weights are 0:
    the JAX signature; the port's own caller passes only valid centres.
    Returns (weights [M], poly coefficients (1, x, y) [3])."""
    m = centers.shape[0]
    dev, dt = centers.device, centers.dtype
    eye = torch.eye(m, device=dev, dtype=dt)
    d = centers[:, None, :] - centers[None, :, :]
    K = _tps_kernel((d * d).sum(-1)) + smoothing * eye
    P = torch.cat([torch.ones((m, 1), device=dev, dtype=dt), centers], dim=1)
    if valid is not None:
        v = valid.to(dt)
        K = K * v[:, None] * v[None, :] + (1.0 - v)[:, None] * eye
        P, values = P * v[:, None], values * v
    A = torch.cat(
        [torch.cat([K, P], dim=1), torch.cat([P.T, torch.zeros((3, 3), device=dev, dtype=dt)], dim=1)]
    )
    A = A + 1e-8 * torch.eye(m + 3, device=dev, dtype=dt)  # a ridge for degenerate layouts
    rhs = torch.cat([values, torch.zeros(3, device=dev, dtype=dt)])
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
    """Dense [H, W] float32 map: the TPS over the valid centres, fitted and
    evaluated in float64, on a grid at most ``grid_width`` wide, bilinearly
    upsampled."""
    centers, values = centers[valid].double(), values[valid].double()
    w, p = tps_fit(centers, values, smoothing=smoothing)
    gw = min(grid_width, width)
    gh = max(int(round(height * gw / width)), 1)
    dev = centers.device
    xs = (torch.arange(gw, device=dev, dtype=torch.float64) + 0.5) * (width / gw)
    ys = (torch.arange(gh, device=dev, dtype=torch.float64) + 0.5) * (height / gh)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    q = torch.stack([gx, gy], dim=-1).reshape(-1, 2)
    coarse = torch.cat([tps_eval(centers, w, p, b) for b in q.split(EVAL_BLOCK)]).reshape(gh, gw).float()
    return upsample_bilinear(coarse, height, width)
