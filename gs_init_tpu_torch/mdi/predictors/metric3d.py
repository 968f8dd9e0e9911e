"""Metric3D v2 predictor — port of ``gs_init_tpu/mdi/predictors/metric3d.py``:
a DINOv2-reg ViT and the RAFT-DPT decoder.

Keep-ratio resize into the (616, 1064) canonical crop on a mean-value
canvas, ImageNet normalisation on the 0..255 scale, the network, unpad and
resize back, then the canonical -> metric de-normalisation ``depth *
fx_scaled / 1000`` clamped to [0, 300]; normals unit length. The resizes
are ``jax.image.resize``'s bilinear (antialiased where they shrink), as
weight matrices (``models/common.resize``). The network runs in float32
with TF32 off, a batch of images at a time on ``device`` (the card by
default).

Weights: the official torch checkpoint (``metric_depth_vit_{small,large}_
*.pth``) under ``$GS_TPU_CHECKPOINT_DIR`` or ``~/.cache/gs_init_tpu``,
loaded by ``metric3d_convert.load_metric3d_weights``. Without one the
predictor raises FileNotFoundError unless ``allow_random_weights`` is set
(random weights from ``seed``: for shape and pipeline runs only). Nothing
is downloaded.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...device import DeviceLike, resolve_device
from ...models.common import build, full_fp32, init_random_, resize
from ...models.raft_dpt import RAFT_CONFIGS, RAFTDepthNormalDecoder
from ...models.vit import VIT_CONFIGS, DinoViT
from .interface import PredictedDepth

_LOGGER = logging.getLogger(__name__)

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


def _find_ckpt(backbone: str) -> Optional[str]:
    for d in (os.environ.get("GS_TPU_CHECKPOINT_DIR", ""), os.path.expanduser("~/.cache/gs_init_tpu")):
        if d and os.path.isdir(d):
            for n in sorted(os.listdir(d)):
                if "metric" in n and backbone in n:
                    return os.path.join(d, n)
    return None


class Metric3DPredictor:
    name = "metric3d"

    def __init__(
        self,
        backbone: str = "small",
        checkpoint: Optional[str] = None,
        allow_random_weights: bool = False,
        device: DeviceLike = None,
        seed: int = 0,
    ):
        self.backbone = backbone
        self.device = resolve_device(device)
        ckpt = checkpoint or _find_ckpt(backbone)
        if not ckpt and not allow_random_weights:
            raise FileNotFoundError(
                "No Metric3D checkpoint found. Place the official torch "
                "checkpoint (metric_depth_vit_{small,large}_*.pth) under "
                "$GS_TPU_CHECKPOINT_DIR or ~/.cache/gs_init_tpu, or pass "
                "allow_random_weights=True (mdi.allow_random_weights) for "
                "pipeline/shape testing only."
            )
        self.net = build(Metric3DNet, backbone)
        if ckpt:
            from .metric3d_convert import load_metric3d_weights

            load_metric3d_weights(self.net, ckpt)
            _LOGGER.info("metric3d weights loaded from %s", ckpt)
        else:
            init_random_(self.net, seed)
            _LOGGER.warning(
                "Metric3D running with RANDOM weights (explicitly allowed) "
                "— predictions are not meaningful"
            )
        self.net.to(self.device).eval()

    @torch.inference_mode()
    def _forward(self, imgs_u8: np.ndarray, nh, nw, pad_t, pad_l):
        """uint8 [B, H, W, 3] -> depth, confidence [B, H, W] and normal
        [B, H, W, 4] (unit xyz) on the host, before de-canonicalisation."""
        b, h, w = imgs_u8.shape[:3]
        dev = self.device
        mean = torch.as_tensor(_MEAN, device=dev).view(1, 3, 1, 1)
        std = torch.as_tensor(_STD, device=dev).view(1, 3, 1, 1)
        x = torch.from_numpy(imgs_u8).to(dev).permute(0, 3, 1, 2).float()
        x = resize(x, (nh, nw))
        canvas = mean.expand(b, 3, *CROP).clone()
        canvas[:, :, pad_t:pad_t + nh, pad_l:pad_l + nw] = x
        canvas = (canvas - mean) / std
        with full_fp32():
            depth, conf, normal = self.net(canvas)
        crop = (slice(None), slice(pad_t, pad_t + nh), slice(pad_l, pad_l + nw))
        depth = resize(depth[crop], (h, w))
        conf = resize(conf[crop], (h, w))
        normal = resize(normal[:, :, pad_t:pad_t + nh, pad_l:pad_l + nw], (h, w)).permute(0, 2, 3, 1)
        nxyz = normal[..., :3]
        nxyz = nxyz / torch.clamp(torch.linalg.norm(nxyz, dim=-1, keepdim=True), min=1e-8)
        normal = torch.cat([nxyz, normal[..., 3:]], dim=-1)
        return depth.cpu().numpy(), conf.cpu().numpy(), normal.cpu().numpy()

    def predict_depth_batch(self, images: np.ndarray, intrinsics) -> list:
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
        depth, conf, normal = self._forward(np.ascontiguousarray(images), nh, nw, pad_t, pad_l)
        preds = []
        for i in range(b):
            fx = float(intrinsics[i].fx) if intrinsics[i] is not None else 1000.0
            d = depth[i] * (fx * scale) / CANONICAL_FOCAL
            d = np.clip(d, *CLIP_RANGE)
            preds.append(
                PredictedDepth(
                    depth=d.astype(np.float32),
                    mask=(d > CLIP_RANGE[0]) & (d < CLIP_RANGE[1]),
                    depth_confidence=conf[i],
                    normal=normal[i, ..., :3],
                    normal_confidence=normal[i, ..., 3],
                )
            )
        return preds

    def predict_depth(self, image, intrinsics) -> PredictedDepth:
        return self.predict_depth_batch(image[None], [intrinsics])[0]
