"""SSIM and PSNR — port of ``gs_init_tpu/ops/ssim.py``.

11x11 gaussian window (sigma 1.5), C1 = 0.01^2, C2 = 0.03^2, valid padding.
The blur is a separable sum of shifted slices in f32, as the JAX package's
``_blur_valid_cfirst`` does, not a convolution: cuDNN runs f32 convolutions
in TF32 by default, and the variance terms E[x^2] - mu^2 cancel
catastrophically below f32 on flat image regions.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache
def _gaussian_window(size: int = 11, sigma: float = 1.5) -> tuple:
    x = np.arange(size) - (size - 1) / 2
    w = np.exp(-(x**2) / (2 * sigma**2))
    return tuple(float(v) for v in (w / w.sum()).astype(np.float32))


def _blur_valid(x: torch.Tensor, window: tuple) -> torch.Tensor:
    """Separable valid-padding filter over [N, H, W] (shifted-slice FMAs)."""
    k = len(window)
    h_out = x.shape[1] - k + 1
    acc = window[0] * x[:, :h_out, :]
    for i in range(1, k):
        acc = acc + window[i] * x[:, i : i + h_out, :]
    w_out = x.shape[2] - k + 1
    out = window[0] * acc[:, :, :w_out]
    for i in range(1, k):
        out = out + window[i] * acc[:, :, i : i + w_out]
    return out


def ssim(
    img0: torch.Tensor,  # [B, H, W, C] predictions in [0, 1]
    img1: torch.Tensor,  # [B, H, W, C] targets
    c1: float = 0.01**2,
    c2: float = 0.03**2,
    window_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """Mean SSIM over a batch (scalar), valid padding."""
    w = _gaussian_window(window_size, sigma)
    b, h, wd, c = img0.shape
    i0 = img0.permute(0, 3, 1, 2)
    i1 = img1.permute(0, 3, 1, 2)
    stacked = torch.cat([i0, i1, i0 * i0, i1 * i1, i0 * i1], dim=1).reshape(b * 5 * c, h, wd)
    blurred = _blur_valid(stacked, w)
    blurred = blurred.reshape(b, 5, c, *blurred.shape[1:])
    mu0, mu1, e00, e11, e01 = (blurred[:, i] for i in range(5))
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = e00 - mu00
    s11 = e11 - mu11
    s01 = e01 - mu01
    m = ((2 * mu01 + c1) * (2 * s01 + c2)) / ((mu00 + mu11 + c1) * (s00 + s11 + c2))
    return torch.mean(m)


def psnr(img0: torch.Tensor, img1: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((img0 - img1) ** 2)
    return 20.0 * float(np.log10(max_val)) - 10.0 * torch.log10(torch.clamp(mse, min=1e-12))
