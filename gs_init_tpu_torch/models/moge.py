"""MoGe-2 monocular geometry model — port of ``gs_init_tpu/models/moge.py``.

A DINOv2 ViT encoder (no register tokens; features from 4 evenly spaced
blocks), a conv head (per-level 1x1 projections summed, three x2 bilinear
upsample stages each with a 3x3 conv and residual conv blocks, an output
stack giving the affine-invariant point map (3), a mask logit (1) and a
normal (3) at half the input resolution, upsampled to full), and a metric
scale from the class token (an MLP, exponentiated). ``z = exp(z_raw)``
keeps depth positive.

The head's resizes are torch's bilinear with align_corners=False and no
antialiasing, as the JAX package writes them out on purpose. Parameter
names are the MoGe layout the JAX converter reads (``encoder.``,
``head.projects``, ``head.upsample``, ``head.res``, ``head.out``,
``scale_head``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import without_cudnn
from .dpt import ResidualConvUnit, conv3
from .vit import VIT_CONFIGS, DinoViT

# MoGeModel's flax module paths against its torch names (state_dict_from_flax).
MOGE_RENAMES = (
    (r"^head/project_(\d)", r"head/projects/\1"),
    (r"^head/upsample_(\d)", r"head/upsample/\1"),
    (r"^head/res_(\d)_(\d)", r"head/res/\1/\2"),
    (r"^head/out_conv1", "head/out/0"),
    (r"^head/out_conv2", "head/out/2"),
    (r"^scale_head/fc1", "scale_head/0"),
    (r"^scale_head/fc2", "scale_head/2"),
)


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """torch bilinear, align_corners=False, no antialiasing, on [B, C, H, W]."""
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)


class MoGeHead(nn.Module):
    """Projection, 3-stage conv upsampler, split output stack."""

    def __init__(self, dim_in: int, dim_proj: int = 512, dim_upsample: Sequence[int] = (256, 128, 64),
                 num_res_blocks: int = 2, out_channels: int = 7):
        super().__init__()
        self.projects = nn.ModuleList(nn.Conv2d(dim_in, dim_proj, 1) for _ in range(4))
        dims = (dim_proj,) + tuple(dim_upsample)
        self.upsample = nn.ModuleList(conv3(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.res = nn.ModuleList(
            nn.ModuleList(ResidualConvUnit(d) for _ in range(num_res_blocks)) for d in dim_upsample
        )
        d = dim_upsample[-1]
        self.out = nn.Sequential(conv3(d, d), nn.ReLU(), nn.Conv2d(d, out_channels, 1))

    def forward(self, feats, out_hw):
        # Without cuDNN: in float32 with TF32 off its heuristics pick an FFT
        # algorithm with a 16 GiB workspace for the vitl head's 3x3 256 -> 128
        # conv at 136x212, hundreds of times slower than PyTorch's own
        # convolution on an H100 (scripts/torch_moge_head.py).
        with without_cudnn():
            x = sum(p(f) for p, f in zip(self.projects, feats))
            for up, blocks in zip(self.upsample, self.res):
                x = up(resize_bilinear(x, (x.shape[2] * 2, x.shape[3] * 2)))
                for blk in blocks:
                    x = blk(x)
            return self.out(resize_bilinear(x, out_hw))


class MoGeModel(nn.Module):
    def __init__(self, backbone: str = "vitl", dim_proj: int = 512,
                 dim_upsample: Sequence[int] = (256, 128, 64), num_res_blocks: int = 2,
                 scale_hidden: int = 512):
        super().__init__()
        cfg = VIT_CONFIGS[backbone]
        self.encoder = DinoViT(**cfg, patch_size=14, num_register_tokens=0, pos_embed_size=37)
        self.head = MoGeHead(cfg["dim"], dim_proj, dim_upsample, num_res_blocks)
        self.scale_head = nn.Sequential(
            nn.Linear(cfg["dim"], scale_hidden), nn.ReLU(), nn.Linear(scale_hidden, 1)
        )

    def forward(self, x: torch.Tensor) -> dict:
        """x: [B, 3, H, W] ImageNet-normalised, H and W multiples of 14.
        Returns points [B, 3, H, W] (metric), depth [B, H, W], mask_logit
        [B, H, W], normal [B, 3, H, W] (unit), scale [B]."""
        h, w = x.shape[2:]
        feats, prefix = self.encoder(x)
        out = resize_bilinear(self.head(feats, (h // 2, w // 2)), (h, w))
        scale = torch.exp(self.scale_head(prefix[-1][:, 0])[:, 0])
        z = torch.exp(out[:, 2])
        points = torch.stack([out[:, 0], out[:, 1], z], dim=1) * scale[:, None, None, None]
        normal = out[:, 4:7]
        normal = normal / torch.clamp(torch.linalg.norm(normal, dim=1, keepdim=True), min=1e-8)
        return dict(points=points, depth=points[:, 2], mask_logit=out[:, 3], normal=normal, scale=scale)
