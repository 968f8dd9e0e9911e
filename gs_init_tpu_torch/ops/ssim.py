"""SSIM and PSNR — port of ``gs_init_tpu/ops/ssim.py``.

11x11 gaussian window (sigma 1.5), C1 = 0.01^2, C2 = 0.03^2, valid padding.
The blur is a separable sum of shifted slices in f32, as the JAX package's
``_blur_valid_cfirst`` does, not a convolution: cuDNN runs f32 convolutions
in TF32 by default, and the variance terms E[x^2] - mu^2 cancel
catastrophically below f32 on flat image regions.

``ssim`` runs, where ``img0`` needs a gradient, an autograd Function: on CPU
tensors its plain twins, on CUDA tensors a CUDA kernel pair or it raises.
The forward (``ssim_fwd_plain``, ``csrc/ssim_fwd.cu``, K6) computes the mean
SSIM and keeps the five blurred maps; the backward (``ssim_bwd_plain``,
``csrc/ssim_bwd.cu``, K7) computes from them the SSIM map's partial
derivatives times the mean's gradient, blurs them back (transposed) and
combines them into the gradient of ``img0``, every operation in the order in
which autograd runs the plain ops' backward: the gradient is autograd's to
the bit. The kernels round every product and sum as the twins do, so their
maps and gradient are the twins' to the bit, and only the mean differs, by
its order of summation. Without a gradient ``ssim`` computes the value
alone (K6 writes no maps). The target ``img1`` takes no gradient.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels

# Outputs (K6) or inputs (K7) a block, each way: csrc/ssim_common.cuh TILE.
TILE = 32
# The kernels' window: csrc/ssim_common.cuh K.
KERNEL_WINDOW = 11


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


# ------------------------------------------------------------ the plain twins


def _ssim_terms(mu0, mu1, e00, e11, e01, c1, c2):
    """The SSIM formula's terms from the five blurred maps: (a, bn, cc, d,
    a * bn, cc * d), the SSIM map being the quotient of the last two. The
    operations run in the order of the JAX package's one-line formula, which
    fixes the order of autograd's backward through them."""
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = e00 - mu00
    s11 = e11 - mu11
    s01 = e01 - mu01
    a = 2 * mu01 + c1
    bn = 2 * s01 + c2
    num = a * bn
    cc = mu00 + mu11 + c1
    d = s00 + s11 + c2
    return a, bn, cc, d, num, cc * d


def _blurred_maps(img0, img1, window):
    """mu0, mu1, E[x0^2], E[x1^2], E[x0 x1]: [B, 5, C, Ho, Wo] of two
    [B, H, W, C] images."""
    b, h, wd, c = img0.shape
    i0 = img0.permute(0, 3, 1, 2)
    i1 = img1.permute(0, 3, 1, 2)
    stacked = torch.cat([i0, i1, i0 * i0, i1 * i1, i0 * i1], dim=1).reshape(b * 5 * c, h, wd)
    blurred = _blur_valid(stacked, window)
    return blurred.reshape(b, 5, c, *blurred.shape[1:])


def ssim_fwd_plain(img0, img1, c1, c2, window, want_maps):
    """K6's specification: (mean SSIM, the blurred maps [B, 5, C, Ho, Wo] or
    None). Plain torch ops, so autograd differentiates it in both images."""
    blurred = _blurred_maps(img0, img1, window)
    *_, num, den = _ssim_terms(*(blurred[:, i] for i in range(5)), c1, c2)
    return torch.mean(num / den), blurred if want_maps else None


def ssim_bwd_plain(grad, img0, img1, blurred, c1, c2, window):
    """K7's specification: the gradient of ``grad * mean SSIM`` by ``img0``
    [B, H, W, C] from K6's blurred maps, as autograd computes it through
    ``ssim_fwd_plain``, operation for operation: the mean's backward (grad /
    count), the formula's backward, the transposed blur (the maps padded by
    k - 1 zeros each way, the window reversed, the horizontal pass first),
    and the products' and the concatenation's backward."""
    b, h, wd, c = img0.shape
    k = len(window)
    mu0, mu1, e00, e11, e01 = (blurred[:, i] for i in range(5))
    a, bn, cc, d, num, den = _ssim_terms(mu0, mu1, e00, e11, e01, c1, c2)
    g = grad / mu0.numel()
    g_num = g / den
    g_den = -g * ((num / den) / den)
    p_e01 = (g_num * a) * 2
    p_e00 = g_den * cc
    t_mu01 = ((g_num * bn) * 2 - p_e01) * mu1
    t_mu00 = (g_den * d - p_e00) * mu0
    p_mu = (t_mu01 + t_mu00) + t_mu00
    maps = torch.stack([p_mu, p_e00, p_e01], dim=1).reshape(3 * b * c, *mu0.shape[2:])
    padded = F.pad(maps, (k - 1,) * 4).transpose(1, 2)
    g_maps = _blur_valid(padded, window[::-1]).transpose(1, 2).reshape(b, 3, c, h, wd)
    g_mu, g_e00, g_e01 = (g_maps[:, i] for i in range(3))
    x0 = img0.permute(0, 3, 1, 2)
    x1 = img1.permute(0, 3, 1, 2)
    dx = ((g_mu + g_e01 * x1) + g_e00 * x0) + g_e00 * x0
    return dx.permute(0, 2, 3, 1).contiguous()


# ------------------------------------------------------------ kernel wrappers


def _check_images(img0, img1, window):
    if len(window) != KERNEL_WINDOW:
        raise ValueError(f"ssim's kernels blur with an {KERNEL_WINDOW}-tap window, got {len(window)}")
    if img0.dim() != 4 or img0.shape != img1.shape:
        raise ValueError(f"ssim takes two [B, H, W, C] images of one shape, got {tuple(img0.shape)} and "
                         f"{tuple(img1.shape)}")
    b, h, w, c = img0.shape
    if min(b, c) < 1 or min(h, w) < KERNEL_WINDOW or b * c > 65535:
        raise ValueError(f"ssim's kernels need 1 <= B * C <= 65535 and H, W >= {KERNEL_WINDOW}, got "
                         f"{tuple(img0.shape)}")
    if not (img0.is_cuda and img1.is_cuda) or img0.device != img1.device:
        raise ValueError(f"ssim's kernels need both images on one CUDA device, got {img0.device} and "
                         f"{img1.device}")
    if img0.dtype != torch.float32 or img1.dtype != torch.float32:
        raise ValueError(f"ssim's kernels take float32 images, got {img0.dtype} and {img1.dtype}")


def _host_args(img0, img1, window):
    """The strides of both images and the window, as the C entry points take
    them (host arrays, read before the launch returns)."""
    strides = (ctypes.c_longlong * 8)(*img0.stride(), *img1.stride())
    return strides, (ctypes.c_float * len(window))(*window)


def ssim_fwd(img0, img1, c1, c2, window, want_maps):
    """K6 on CUDA tensors, ``ssim_fwd_plain`` on CPU tensors: (mean SSIM as a
    0-dim tensor, the blurred maps [B, 5, C, Ho, Wo] or None)."""
    if not (img0.is_cuda or img1.is_cuda):
        return ssim_fwd_plain(img0, img1, c1, c2, window, want_maps)
    _check_images(img0, img1, window)
    b, h, w, c = img0.shape
    ho, wo = h - KERNEL_WINDOW + 1, w - KERNEL_WINDOW + 1
    dev = img0.device
    nsums = -(-wo // TILE) * -(-ho // TILE) * b * c
    sums = torch.empty(nsums, dtype=torch.float64, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    maps = torch.empty((b, 5, c, ho, wo), dtype=torch.float32, device=dev) if want_maps else None
    strides, win = _host_args(img0, img1, window)
    kernels.launch("ssim_fwd", img0, img0.data_ptr(), img1.data_ptr(), strides, win,
                   0 if maps is None else maps.data_ptr(), sums.data_ptr(), out.data_ptr(), nsums, b, h, w, c,
                   float(c1), float(c2))
    return out, maps


def ssim_bwd(grad, img0, img1, maps, c1, c2, window):
    """K7 on CUDA tensors, ``ssim_bwd_plain`` on CPU tensors: the gradient of
    ``img0`` [B, H, W, C], contiguous."""
    if not (img0.is_cuda or img1.is_cuda):
        return ssim_bwd_plain(grad, img0, img1, maps, c1, c2, window)
    _check_images(img0, img1, window)
    b, h, w, c = img0.shape
    ho, wo = h - KERNEL_WINDOW + 1, w - KERNEL_WINDOW + 1
    if maps.shape != (b, 5, c, ho, wo) or maps.dtype != torch.float32 or maps.device != img0.device:
        raise ValueError(f"K7 takes K6's float32 maps [{b}, 5, {c}, {ho}, {wo}] on {img0.device}, got "
                         f"{maps.dtype} {tuple(maps.shape)} on {maps.device}")
    maps = maps.contiguous()
    grad = grad.reshape(()).to(device=img0.device, dtype=torch.float32).contiguous()
    dx = torch.empty((b, h, w, c), dtype=torch.float32, device=img0.device)
    strides, win = _host_args(img0, img1, window[::-1])
    # The mean's backward on the card multiplies by the count's reciprocal,
    # rounded to float32 (torch's division of a tensor by a Python number).
    inv_count = float(np.float32(1.0) / np.float32(b * c * ho * wo))
    kernels.launch("ssim_bwd", img0, img0.data_ptr(), img1.data_ptr(), strides, win, maps.data_ptr(),
                   grad.data_ptr(), dx.data_ptr(), b, h, w, c, inv_count, float(c1), float(c2))
    return dx


class _SSIM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img0, img1, c1, c2, window):
        value, maps = ssim_fwd(img0, img1, c1, c2, window, want_maps=True)
        # Saved through autograd, so an image changed in place before the
        # backward raises instead of giving the gradient of other values.
        ctx.save_for_backward(img0, img1, maps)
        ctx.consts = (c1, c2, window)
        return value

    @staticmethod
    def backward(ctx, grad):
        img0, img1, maps = ctx.saved_tensors
        return ssim_bwd(grad, img0, img1, maps, *ctx.consts), None, None, None, None


def ssim(
    img0: torch.Tensor,  # [B, H, W, C] predictions in [0, 1]
    img1: torch.Tensor,  # [B, H, W, C] targets
    c1: float = 0.01**2,
    c2: float = 0.03**2,
    window_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """Mean SSIM over a batch (scalar), valid padding; differentiable in
    ``img0`` only."""
    w = _gaussian_window(window_size, sigma)
    if torch.is_grad_enabled() and img1.requires_grad:
        raise ValueError("ssim gives the target img1 no gradient; detach it")
    if torch.is_grad_enabled() and img0.requires_grad:
        return _SSIM.apply(img0, img1, c1, c2, w)
    return ssim_fwd(img0, img1, c1, c2, w, want_maps=False)[0]


def psnr(img0: torch.Tensor, img1: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((img0 - img1) ** 2)
    return 20.0 * float(np.log10(max_val)) - 10.0 * torch.log10(torch.clamp(mse, min=1e-12))
