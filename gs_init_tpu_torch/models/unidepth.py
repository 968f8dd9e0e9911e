"""UniDepth-v2-style camera-aware metric depth — port of
``gs_init_tpu/models/unidepth.py``.

A DINOv2 ViT encoder (4 levels); dense per-patch camera rays from the
intrinsics, Fourier-encoded and projected into every level (without
intrinsics, a camera head on the class token predicts pinhole ones); DPT
fusion at the patch resolution, one x4 upsample, and a head giving
log-depth and a confidence logit, resized to the input (bilinear,
align_corners=True). Depth is exp(log-depth) clipped to [0, max_depth].

Parameter names are the layout the JAX converter reads (``encoder.``,
``camera_head.{0,2}``, ``projects``, ``ray_projs``, ``refine.{j}``,
``out.{0,2}``), except that the fusion blocks' residual units are
``resConfUnit{1,2}`` (the DPT head's names) where that layout says
``rcu{1,2}``; ``unidepth_convert`` maps them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .common import resize_align_corners
from .dpt import FeatureFusionBlock, conv3
from .vit import VIT_CONFIGS, DinoViT

N_FREQ = 8  # Fourier frequencies of the ray embedding

# UniDepthModel's flax module paths against its torch names.
UNIDEPTH_RENAMES = (
    (r"^camera_head/fc1", "camera_head/0"),
    (r"^camera_head/fc2", "camera_head/2"),
    (r"^project_(\d)", r"projects/\1"),
    (r"^ray_proj_(\d)", r"ray_projs/\1"),
    (r"^refine_(\d)", r"refine/\1"),
    (r"/rcu(\d)", r"/resConfUnit\1"),
    (r"^out_conv1", "out/0"),
    (r"^out_conv2", "out/2"),
)


def ray_embedding(K: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Dense unit rays through the pixel centres of an h x w grid under K
    [B, 3, 3], with their sin / cos Fourier features: [B, 3 + 6 N_FREQ, h, w]."""
    dev = K.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[:, None]
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, :]
    fx, fy = K[:, 0, 0, None, None], K[:, 1, 1, None, None]
    cx, cy = K[:, 0, 2, None, None], K[:, 1, 2, None, None]
    rx, ry = torch.broadcast_tensors((xs - cx) / fx, (ys - cy) / fy)
    rays = torch.stack([rx, ry, torch.ones_like(rx)], dim=-1)
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    freqs = 2.0 ** torch.arange(N_FREQ, dtype=torch.float32, device=dev)
    ang = rays[..., None] * freqs * math.pi  # [B, h, w, 3, F]
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(rays.shape[:-1] + (6 * N_FREQ,))
    return torch.cat([rays, enc], dim=-1).permute(0, 3, 1, 2)


def camera_from_head(x: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """The camera head's output [B, 4] (log fx, log fy, dx, dy) -> K [B, 3, 3]."""
    f = torch.exp(x[:, :2]) * width
    K = torch.zeros(x.shape[0], 3, 3, device=x.device, dtype=x.dtype)
    K[:, 0, 0], K[:, 1, 1] = f[:, 0], f[:, 1]
    K[:, 0, 2] = width * (0.5 + 0.1 * torch.tanh(x[:, 2]))
    K[:, 1, 2] = height * (0.5 + 0.1 * torch.tanh(x[:, 3]))
    K[:, 2, 2] = 1.0
    return K


class UniDepthModel(nn.Module):
    def __init__(self, backbone: str = "vitl", features: int = 128, max_depth: float = 250.0):
        super().__init__()
        cfg = VIT_CONFIGS[backbone]
        dim = cfg["dim"]
        self.max_depth = max_depth
        self.encoder = DinoViT(**cfg, patch_size=14, num_register_tokens=0, pos_embed_size=37)
        self.camera_head = nn.Sequential(nn.Linear(dim, 256), nn.ReLU(), nn.Linear(256, 4))
        self.projects = nn.ModuleList(nn.Conv2d(dim, features, 1) for _ in range(4))
        self.ray_projs = nn.ModuleList(nn.Conv2d(3 + 6 * N_FREQ, features, 1) for _ in range(4))
        self.refine = nn.ModuleList(FeatureFusionBlock(features, skip=j != 3) for j in range(4))
        self.out = nn.Sequential(conv3(features, features // 2), nn.ReLU(), nn.Conv2d(features // 2, 2, 1))

    def forward(self, x: torch.Tensor, K: Optional[torch.Tensor] = None) -> dict:
        """x: [B, 3, H, W] ImageNet-normalised, H and W multiples of 14; K
        [B, 3, 3] in x's pixels (None: the camera head predicts it).
        Returns depth [B, H, W], confidence [B, H, W] and K [B, 3, 3]."""
        h, w = x.shape[2:]
        feats, prefix = self.encoder(x)
        if K is None:
            K = camera_from_head(self.camera_head(prefix[-1][:, 0]), w, h)
        ph, pw = h // 14, w // 14
        # Rays through the patch centres: K rescaled to the patch grid.
        rays = ray_embedding(torch.cat([K[:, :2] / 14.0, K[:, 2:]], dim=1), ph, pw)
        fused = [p(f) + r(rays) for f, p, r in zip(feats, self.projects, self.ray_projs)]
        rf = self.refine
        path = rf[3](fused[3], out_hw=(ph, pw))
        path = rf[2](path, fused[2], out_hw=(ph, pw))
        path = rf[1](path, fused[1], out_hw=(ph, pw))
        path = rf[0](path, fused[0], out_hw=(ph * 4, pw * 4))
        y = resize_align_corners(self.out(path), (h, w))
        depth = torch.clamp(torch.exp(y[:, 0]), 0.0, self.max_depth)
        return dict(depth=depth, confidence=torch.sigmoid(y[:, 1]), K=K)
