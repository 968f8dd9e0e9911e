"""SIFT descriptors at subsampled depth points — port of
``gs_init_tpu/mdi/descriptors.py``.

Gates the subsampling mask to pixels whose patch fits in the image, gathers
grayscale patches there and computes 128-D SIFT descriptors for all of them
at once (the reference prepares them with kornia, one indexed copy per
patch, ``point_cloud_postprocess/prepare_descriptors.py:13-48``). Lowe's
SIFT as kornia's ``SIFTDescriptor``: central-difference gradients, a
Gaussian window, trilinear soft binning into 4 x 4 cells of 8 orientations
(the spatial pooling one ``einsum`` against per-axis bilinear weights),
L2 -> clip(0.2) -> L2, optional RootSIFT. Like the JAX package's, nothing
in the training path calls it: the reference's feature is unused in its own
main path.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

DESCRIPTOR_PATCH_SIZE = 32

# ITU-R BT.601 luma weights (kornia.color.rgb_to_grayscale's).
_GRAY_W = (0.299, 0.587, 0.114)


def rgb_to_grayscale(image: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] float in [0, 1] -> [H, W] luma."""
    return _GRAY_W[0] * image[..., 0] + _GRAY_W[1] * image[..., 1] + _GRAY_W[2] * image[..., 2]


def border_mask(height: int, width: int, border: int) -> np.ndarray:
    """[H, W] bool, False within ``border`` pixels of any edge (the patch
    window must fit)."""
    m = np.zeros((height, width), dtype=bool)
    if height > 2 * border and width > 2 * border:
        m[border : height - border, border : width - border] = True
    return m


def extract_patches(gray: torch.Tensor, yx: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[N, P, P] patches of ``gray`` [H, W] centred at integer pixel coords
    ``yx`` [N, 2]. Window starts follow ``jax.lax.dynamic_slice``: a
    negative start counts from the end, then the window is clamped inside
    the image. Callers gate the centres with ``border_mask``."""
    h, w = gray.shape
    half = patch_size // 2
    yx = yx.long().to(gray.device)

    def start(c, size):
        s = c - half
        return torch.where(s < 0, s + size, s).clamp(0, size - patch_size)

    y0, x0 = start(yx[:, 0], h), start(yx[:, 1], w)
    r = torch.arange(patch_size, device=gray.device)
    return gray[(y0[:, None] + r)[:, :, None], (x0[:, None] + r)[:, None, :]]


def _pooling_weights(patch_size: int, num_spatial_bins: int) -> np.ndarray:
    """[num_spatial_bins, patch_size] bilinear bin weights along one axis."""
    bin_w = patch_size / num_spatial_bins
    p = np.arange(patch_size, dtype=np.float64) + 0.5
    centers = (np.arange(num_spatial_bins, dtype=np.float64) + 0.5) * bin_w
    w = np.maximum(0.0, 1.0 - np.abs(p[None, :] - centers[:, None]) / bin_w)
    return w.astype(np.float32)


def _gaussian_window(patch_size: int) -> np.ndarray:
    """[P, P] Gaussian weighting window, sigma = patch_size / 2 (Lowe)."""
    sigma = patch_size / 2.0
    p = np.arange(patch_size, dtype=np.float64) + 0.5 - patch_size / 2.0
    g1 = np.exp(-0.5 * (p / sigma) ** 2)
    return np.outer(g1, g1).astype(np.float32)


def sift_descriptors(
    patches: torch.Tensor,
    *,
    num_ang_bins: int = 8,
    num_spatial_bins: int = 4,
    clipval: float = 0.2,
    rootsift: bool = True,
    eps: float = 1e-10,
) -> torch.Tensor:
    """[N, P, P] grayscale patches -> [N, num_spatial_bins^2 * num_ang_bins]
    SIFT descriptors."""
    n, p, _ = patches.shape
    dev = patches.device
    # Central differences, replicate padding at the patch edge.
    padded = F.pad(patches[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    gx = 0.5 * (padded[:, 1:-1, 2:] - padded[:, 1:-1, :-2])
    gy = 0.5 * (padded[:, 2:, 1:-1] - padded[:, :-2, 1:-1])
    mag = torch.sqrt(gx * gx + gy * gy + eps)
    ori = torch.atan2(gy, gx)  # [-pi, pi]

    # Soft orientation binning: each pixel votes into its two nearest bins.
    two_pi = 2.0 * math.pi
    of = torch.remainder(ori, two_pi) / two_pi * num_ang_bins  # [0, A)
    bins = torch.arange(num_ang_bins, dtype=torch.float32, device=dev)
    d = torch.abs(of[..., None] - bins)  # [N, P, P, A]
    d = torch.minimum(d, num_ang_bins - d)  # circular distance
    wo = torch.clamp(1.0 - d, min=0.0)

    votes = wo * (mag * torch.as_tensor(_gaussian_window(p), device=dev))[..., None]
    wyx = torch.as_tensor(_pooling_weights(p, num_spatial_bins), device=dev)
    hist = torch.einsum("yi,xj,nija->nyxa", wyx, wyx, votes)

    desc = hist.reshape(n, -1)
    desc = desc / torch.linalg.norm(desc, dim=-1, keepdim=True).clamp(min=eps)
    desc = torch.clamp(desc, max=clipval)
    desc = desc / torch.linalg.norm(desc, dim=-1, keepdim=True).clamp(min=eps)
    if rootsift:
        desc = torch.sqrt(desc / desc.sum(dim=-1, keepdim=True).clamp(min=eps))
    return desc


def prepare_descriptors(
    image,
    subsampling_mask,
    *,
    patch_size: int = DESCRIPTOR_PATCH_SIZE,
    rootsift: bool = True,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """SIFT descriptors at every kept pixel of a depth-subsampling mask,
    after restricting it to pixels whose ``patch_size`` window fits.

    ``image`` [H, W, 3] float RGB in [0, 1] (numpy or a tensor, computed on
    its device or ``device``); ``subsampling_mask`` [H*W] or [H, W] bool.
    Returns (descriptors [M, 128] float32, the gated mask flattened to
    [H*W] bool), M the surviving pixels."""
    h, w = int(image.shape[0]), int(image.shape[1])
    mask = np.asarray(
        subsampling_mask.cpu() if torch.is_tensor(subsampling_mask) else subsampling_mask, dtype=bool
    ).reshape(h, w)
    mask = mask & border_mask(h, w, patch_size // 2)
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return np.zeros((0, 128), np.float32), mask.reshape(-1)
    img = torch.as_tensor(image, dtype=torch.float32, device=device)
    yx = torch.as_tensor(np.stack([ys, xs], -1), device=img.device)
    desc = sift_descriptors(extract_patches(rgb_to_grayscale(img), yx, patch_size), rootsift=rootsift)
    return desc.cpu().numpy(), mask.reshape(-1)
