"""Separable image filters (Gaussian and box blur, first-order gradients)
— port of ``gs_init_tpu/utils/image_filtering.py``.

Replicate padding and odd kernels, as the reference's own filters
(``utils/image_filtering.py:7-130``); each pass is a correlation with the
kernel (``F.conv2d``), vertical first. Images are [H, W] tensors.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache
def _gauss_kernel(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1)
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _sep_filter2d(img: torch.Tensor, ky: np.ndarray, kx: np.ndarray) -> torch.Tensor:
    """The separable filter (ky down the columns, then kx along the rows)
    with replicate padding. img: [H, W]."""
    ry, rx = len(ky) // 2, len(kx) // 2
    wy = torch.as_tensor(ky, dtype=img.dtype, device=img.device).reshape(1, 1, -1, 1)
    wx = torch.as_tensor(kx, dtype=img.dtype, device=img.device).reshape(1, 1, 1, -1)
    x = F.pad(img[None, None], (0, 0, ry, ry), mode="replicate")
    x = F.conv2d(x, wy)
    x = F.pad(x, (rx, rx, 0, 0), mode="replicate")
    return F.conv2d(x, wx)[0, 0]


def gaussian_filter2d(img: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    r = max(int(np.ceil(3 * sigma)), 1)
    k = _gauss_kernel(float(sigma), r)
    return _sep_filter2d(img, k, k)


def box_blur2d(img: torch.Tensor, size: int) -> torch.Tensor:
    k = np.full(size, 1.0 / size, np.float32)
    return _sep_filter2d(img, k, k)


def spatial_gradient_first_order(img: torch.Tensor, sigma: float = 1.0):
    """Gaussian-derivative gradients (dy, dx) of [H, W]."""
    r = max(int(np.ceil(3 * sigma)), 1)
    g = _gauss_kernel(float(sigma), r)
    x = np.arange(-r, r + 1).astype(np.float32)
    dg = (-x / (sigma**2)) * g
    return _sep_filter2d(img, dg, g), _sep_filter2d(img, g, dg)
