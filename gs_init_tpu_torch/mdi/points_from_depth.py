"""Depth map -> world-space points, the per-image core of monocular-depth
init — port of ``gs_init_tpu/mdi/points_from_depth.py``.

Project the image's SfM points with P = K R [I | -C] and check them
(the caller skips an image below ``min_valid_sfm_fraction``), align the
predicted depth to metric scale, combine the masks (prediction validity,
aligned >= 0, optional depth gradient, optional SfM density, subsampling)
and unproject every pixel (+0.5 centre offset) through K^-1 to world
space. SfM correspondences are padded to a fixed M; the points come back as
an [H*W, 3] buffer with an [H*W] mask, which the caller compacts. Runs on
the device of its inputs and never waits for it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .alignment.lstsqrs import align_lstsqrs
from .alignment.ransac import ransac_scale_shift
from .subsampling import adaptive_mask, depth_gradient_mask, sfm_density_mask, static_mask


class PointsFromDepth(NamedTuple):
    pts_world: torch.Tensor  # [H*W, 3]
    mask: torch.Tensor  # [H*W] bool: the points to keep
    valid_sfm_fraction: torch.Tensor  # [] fraction of SfM points that project
    scale: torch.Tensor  # [] alignment scale
    shift: torch.Tensor  # [] alignment shift


def project_sfm_points(
    sfm_points: torch.Tensor,  # [M, 3] world (padded)
    sfm_valid: torch.Tensor,  # [M]
    viewmat: torch.Tensor,  # [4, 4] world -> camera
    K: torch.Tensor,  # [3, 3]
    width: int,
    height: int,
):
    """(pixel coords [M, 2], camera depth [M], in-frame mask [M])."""
    cam = sfm_points @ viewmat[:3, :3].T + viewmat[:3, 3]
    z = cam[:, 2]
    uv = cam[:, :2] / torch.clamp(z[:, None], min=1e-8)
    pix = uv @ K[:2, :2].T + K[:2, 2]
    ok = (
        sfm_valid
        & (z > 0)
        & (pix[:, 0] >= 0)
        & (pix[:, 0] < width)
        & (pix[:, 1] >= 0)
        & (pix[:, 1] < height)
    )
    return pix, z, ok


def _sample_depth_at(depth: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """Nearest sampling by truncation, the reference's integer indexing."""
    x = torch.clamp(pix[:, 0].to(torch.int64), 0, depth.shape[1] - 1)
    y = torch.clamp(pix[:, 1].to(torch.int64), 0, depth.shape[0] - 1)
    return depth[y, x]


def points_from_depth(
    pred_depth: torch.Tensor,  # [H, W]
    pred_mask: torch.Tensor,  # [H, W] bool
    camtoworld: torch.Tensor,  # [4, 4]
    K: torch.Tensor,  # [3, 3]
    sfm_points: torch.Tensor,  # [M, 3] padded
    sfm_valid: torch.Tensor,  # [M]
    idx: Optional[torch.Tensor] = None,  # RANSAC sample indices [HYP, S]
    generator: Optional[torch.Generator] = None,  # draws them when idx is None
    *,
    width: int,
    height: int,
    align_method: str = "ransac",
    subsample_method: str = "static",
    subsample_factor: int = 10,
    min_stride: int = 5,
    max_stride: int = 15,
    use_grad_mask: bool = False,
    grad_threshold: float = 0.1,
    use_sfm_density_mask: bool = False,
    ransac_iters: int = 2500,
    ransac_threshold: float = 0.01,
    sample_size: int = 4,
) -> PointsFromDepth:
    viewmat = torch.linalg.inv(camtoworld)
    pix, gt_z, ok = project_sfm_points(sfm_points, sfm_valid, viewmat, K, width, height)
    n_input = torch.clamp(sfm_valid.sum(), min=1)
    valid_fraction = ok.sum() / n_input

    pred_at = _sample_depth_at(pred_depth, pix)
    corr_ok = ok & _sample_depth_at(pred_mask, pix)

    if align_method == "lstsqrs":
        aligned, (s, t) = align_lstsqrs(pred_depth, pred_at, gt_z, corr_ok.float())
    elif align_method in ("ransac", "msac"):
        s, t, _ = ransac_scale_shift(
            pred_at, gt_z, corr_ok, idx=idx, generator=generator,
            inlier_threshold=ransac_threshold, num_hyp=ransac_iters,
            sample_size=sample_size, msac=(align_method == "msac"),
        )
        aligned = pred_depth * s + t
    else:
        raise ValueError(f"unknown alignment {align_method!r}")

    mask = _combine_masks(
        aligned, pred_mask, pix, ok, width, height,
        subsample_method, subsample_factor, min_stride, max_stride,
        use_grad_mask, grad_threshold, use_sfm_density_mask,
    )
    world = _unproject(aligned, camtoworld, K, width, height)
    return PointsFromDepth(
        pts_world=world, mask=mask.reshape(-1), valid_sfm_fraction=valid_fraction,
        scale=s, shift=t,
    )


def _combine_masks(
    aligned, pred_mask, pix, ok, width, height,
    subsample_method, subsample_factor, min_stride, max_stride,
    use_grad_mask, grad_threshold, use_sfm_density_mask,
):
    mask = pred_mask & (aligned >= 0)
    if use_grad_mask:
        mask = mask & depth_gradient_mask(aligned, grad_threshold)
    if use_sfm_density_mask:
        mask = mask & sfm_density_mask(pix, ok, height, width)
    if subsample_method == "static":
        sub = static_mask(height, width, subsample_factor, device=aligned.device)
    elif subsample_method == "adaptive":
        sub = adaptive_mask(aligned, pred_mask, min_stride, max_stride)
    else:
        raise ValueError(f"unknown subsampling {subsample_method!r}")
    return mask & sub


def _unproject(aligned, camtoworld, K, width, height):
    """(u + 0.5, v + 0.5, 1) z -> K^-1 -> camera-to-world, every pixel."""
    dev = aligned.device
    ys = torch.arange(height, dtype=torch.float32, device=dev)[:, None].expand(height, width)
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :].expand(height, width)
    z = aligned
    homo = torch.stack([(xs + 0.5) * z, (ys + 0.5) * z, z], dim=-1).reshape(-1, 3)
    cam = homo @ torch.linalg.inv(K).T
    return cam @ camtoworld[:3, :3].T + camtoworld[:3, 3]


def masks_and_unproject(
    aligned: torch.Tensor,  # [H, W] depth aligned by the alignment pipeline
    align_mask: torch.Tensor,  # [H, W] its validity
    camtoworld: torch.Tensor,
    K: torch.Tensor,
    sfm_pix: torch.Tensor,  # [M, 2]
    sfm_ok: torch.Tensor,  # [M]
    *,
    width: int,
    height: int,
    subsample_method: str = "static",
    subsample_factor: int = 10,
    min_stride: int = 5,
    max_stride: int = 15,
    use_grad_mask: bool = False,
    grad_threshold: float = 0.1,
    use_sfm_density_mask: bool = False,
):
    """The tail of the pipeline path (segmentation or an interpolated
    scale): mask combination and unprojection of an aligned depth map.
    Returns (points [H*W, 3], mask [H*W])."""
    mask = _combine_masks(
        aligned, align_mask, sfm_pix, sfm_ok, width, height,
        subsample_method, subsample_factor, min_stride, max_stride,
        use_grad_mask, grad_threshold, use_sfm_density_mask,
    )
    return _unproject(aligned, camtoworld, K, width, height), mask.reshape(-1)
