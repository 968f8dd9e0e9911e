"""Depth-map subsampling masks — port of ``gs_init_tpu/mdi/subsampling.py``:

- static: every k-th row and column;
- adaptive: a per-pixel stride in [min, max] from the IQR-clamped,
  normalised depth (far pixels sampled denser);
- SfM density: drop the patches (about 20 per side) that already hold more
  than ``threshold`` projected SfM points;
- depth gradient: drop pixels with a steep normalised depth gradient.
"""
from __future__ import annotations

import torch


def static_mask(height: int, width: int, factor: int, device=None) -> torch.Tensor:
    yy = torch.arange(height, device=device)[:, None] % factor == 0
    xx = torch.arange(width, device=device)[None, :] % factor == 0
    return yy & xx


def _iqr_input_range(depth: torch.Tensor, mask: torch.Tensor):
    big = torch.where(mask, depth, torch.full_like(depth, float("nan"))).reshape(-1)
    q1 = torch.nanquantile(big, 0.25)
    q3 = torch.nanquantile(big, 0.75)
    iqr = q3 - q1
    finite = ~torch.isnan(big)
    lo = torch.maximum(torch.where(finite, big, float("inf")).min(), q1 - 1.5 * iqr)
    hi = torch.minimum(torch.where(finite, big, float("-inf")).max(), q3 + 1.5 * iqr)
    return lo, hi


def adaptive_mask(
    depth: torch.Tensor,  # [H, W] aligned depth
    mask: torch.Tensor,  # [H, W] validity
    min_stride: int = 5,
    max_stride: int = 15,
) -> torch.Tensor:
    lo, hi = _iqr_input_range(depth, mask)
    norm = torch.clamp((depth - lo) / torch.clamp(hi - lo, min=1e-8), 0.0, 1.0)
    mult = torch.where(mask, 1.0 - norm, torch.full_like(norm, 0.5))
    # .to(int32) truncates toward zero, as the JAX astype does.
    factor = torch.clamp(min_stride + mult * (max_stride - min_stride), min_stride, max_stride)
    factor = torch.clamp(factor.to(torch.int32), min=1)
    h, w = depth.shape
    yy = torch.arange(h, device=depth.device, dtype=torch.int32)[:, None]
    xx = torch.arange(w, device=depth.device, dtype=torch.int32)[None, :]
    return (yy % factor == 0) & (xx % factor == 0) & mask


def sfm_density_mask(
    sfm_xy: torch.Tensor,  # [M, 2] projected SfM pixel coords
    sfm_valid: torch.Tensor,  # [M]
    height: int,
    width: int,
    num_patches_small_axis: int = 20,
    threshold: int = 15,
) -> torch.Tensor:
    """True where the patch still needs points (it holds <= threshold SfM
    points). The patch side comes from the smaller image axis."""
    psize = max(min(height, width) // num_patches_small_axis, 1)
    gy = -(-height // psize)
    gx = -(-width // psize)
    pidx_y = torch.clamp(sfm_xy[:, 1].to(torch.int32) // psize, 0, gy - 1)
    pidx_x = torch.clamp(sfm_xy[:, 0].to(torch.int32) // psize, 0, gx - 1)
    flat = pidx_y.long() * gx + pidx_x.long()
    # Invalid entries land in an extra slot that is dropped.
    slot = torch.where(sfm_valid, flat, torch.full_like(flat, gy * gx))
    counts = torch.zeros(gy * gx + 1, dtype=torch.int32, device=sfm_xy.device)
    counts = counts.index_add(0, slot, torch.ones_like(slot, dtype=torch.int32))[:-1]
    keep_patch = (counts <= threshold).reshape(gy, gx)
    yy = torch.clamp(torch.arange(height, device=sfm_xy.device) // psize, max=gy - 1)
    xx = torch.clamp(torch.arange(width, device=sfm_xy.device) // psize, max=gx - 1)
    return keep_patch[yy[:, None], xx[None, :]]


def depth_gradient_mask(depth: torch.Tensor, threshold: float) -> torch.Tensor:
    """True where the forward-difference depth gradient, normalised to
    [0, 1], is at most ``threshold``. Non-finite depths (masked pixels, the
    alignment's INVALID sentinel's neighbours) count as 0 first, so one NaN
    cannot poison the normalisation; the valid/invalid border then carries
    a large gradient and is masked."""
    depth = torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))
    g = torch.zeros_like(depth)
    g[:, 1:] += (depth[:, 1:] - depth[:, :-1]).abs()
    g[1:, :] += (depth[1:, :] - depth[:-1, :]).abs()
    g = g - g.min()
    g = g / (g.max() + 1e-8)
    return g <= threshold
