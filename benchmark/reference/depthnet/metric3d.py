"""Frozen plain copy of the port's Metric3D v2 network and its pre- and
post-processing (``gs_init_tpu_torch/mdi/predictors/metric3d.py``), for the
benchmark's check of the depth network. Departures: no checkpoint search and
no random initialisation (the benchmark hands the weights in), no predictor
object (``predict`` is ``_forward`` and ``predict_depth_batch`` as
functions), and the outputs stay on the device; the network runs in float32
with TF32 off, as the port's does.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .common import full_fp32, resize
from .raft_dpt import RAFT_CONFIGS, RAFTDepthNormalDecoder
from .vit import VIT_CONFIGS, DinoViT

CANONICAL_FOCAL = 1000.0
CROP = (616, 1064)  # the reference's vit.raft5 crop_size
_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
_STD = np.array([58.395, 57.12, 57.375], np.float32)
CLIP_RANGE = (0.0, 300.0)

BACKBONES = {"small": "vits", "large": "vitl", "giant": "vitg"}


class Metric3DNet(nn.Module):
    """x [B, 3, 616, 1064] normalised -> depth [B, H, W], confidence
    [B, H, W], normal [B, 4, H, W]. The reference ViT feeds the same
    final-layer normed tokens to all four pyramid reads."""

    def __init__(self, backbone: str = "small"):
        super().__init__()
        if backbone not in RAFT_CONFIGS:
            raise ValueError(
                f"no Metric3D decoder preset for backbone {backbone!r} "
                f"(have {sorted(RAFT_CONFIGS)})"
            )
        v = VIT_CONFIGS[BACKBONES[backbone]]
        self.encoder = DinoViT(
            dim=v["dim"], depth=v["depth"], num_heads=v["num_heads"],
            out_layers=(v["depth"] - 1,), num_register_tokens=4, pos_interp="torch",
        )
        self.decoder = RAFTDepthNormalDecoder(**RAFT_CONFIGS[backbone], n_prefix=5)

    def forward(self, x):
        patches, prefixes = self.encoder(x)
        learn = prefixes[0].reshape(x.shape[0], -1)
        return self.decoder([patches[0]] * 4, [learn] * 4)


@torch.inference_mode()
def _forward(net, dev, imgs_u8: np.ndarray, nh, nw, pad_t, pad_l, fp32=True):
    """uint8 [B, H, W, 3] -> depth, confidence [B, H, W] and normal
    [B, H, W, 4] (unit xyz) on the host, before de-canonicalisation."""
    b, h, w = imgs_u8.shape[:3]
    mean = torch.as_tensor(_MEAN, device=dev).view(1, 3, 1, 1)
    std = torch.as_tensor(_STD, device=dev).view(1, 3, 1, 1)
    x = torch.from_numpy(imgs_u8).to(dev).permute(0, 3, 1, 2).float()
    x = resize(x, (nh, nw))
    canvas = mean.expand(b, 3, *CROP).clone()
    canvas[:, :, pad_t:pad_t + nh, pad_l:pad_l + nw] = x
    canvas = (canvas - mean) / std
    if fp32:
        with full_fp32():
            depth, conf, normal = net(canvas)
    else:
        depth, conf, normal = net(canvas)
    crop = (slice(None), slice(pad_t, pad_t + nh), slice(pad_l, pad_l + nw))
    depth = resize(depth[crop], (h, w))
    conf = resize(conf[crop], (h, w))
    normal = resize(normal[:, :, pad_t:pad_t + nh, pad_l:pad_l + nw], (h, w)).permute(0, 2, 3, 1)
    nxyz = normal[..., :3]
    nxyz = nxyz / torch.clamp(torch.linalg.norm(nxyz, dim=-1, keepdim=True), min=1e-8)
    normal = torch.cat([nxyz, normal[..., 3:]], dim=-1)
    return depth, conf, normal

def predict(net, dev, images: np.ndarray, fxs, fp32=True):
    """Depth [B, H, W] and mask of uint8 images [B, H, W, 3] at focal lengths
    ``fxs``, on the device: ``predict_depth_batch``'s depth and mask."""
    b, h, w = images.shape[:3]
    ch, cw = CROP
    scale = min(cw / w, ch / h)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    pad_t = (ch - nh) // 2
    pad_l = (cw - nw) // 2
    if images.dtype != np.uint8:
        # Source images are 8-bit files; the round trip to uint8 is
        # lossless in practice and quarters the bytes sent to the card.
        images = np.clip(np.asarray(images, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    depth, _, _ = _forward(net, dev, np.ascontiguousarray(images), nh, nw, pad_t, pad_l, fp32)
    fx = torch.as_tensor(np.asarray(fxs, np.float64) * scale / CANONICAL_FOCAL, dtype=torch.float32,
                         device=depth.device)
    d = torch.clamp(depth * fx[:, None, None], *CLIP_RANGE)
    return d, (d > CLIP_RANGE[0]) & (d < CLIP_RANGE[1])
