"""MoGe-2 predictor — port of ``gs_init_tpu/mdi/predictors/moge.py``.

The image is resized so the ViT sees about 1,800 tokens (inside MoGe's
[1200, 3600] range), both sides multiples of 14, with ``jax.image.resize``'s
antialiased bilinear, then ImageNet-normalised; depth, the mask logit and
the normals are resized back the same way (the mask is logit > 0, the
normals renormalised). Float32 with TF32 off, a batch at a time on
``device``. Images go to the card as float32, as the JAX package sends
them (no 8-bit round trip here).

Weights: a MoGe-2 state dict (``moge*<backbone>*``) under
``$GS_TPU_CHECKPOINT_DIR`` or ``~/.cache/gs_init_tpu``, loaded by
``moge_convert``. Without one the predictor raises FileNotFoundError
unless ``allow_random_weights`` is set (random weights from ``seed``: for
shape and pipeline runs only).
"""
from __future__ import annotations

import logging
import math
from typing import Optional

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ...models.common import build, full_fp32, init_random_, resize
from ...models.moge import MoGeModel
from .interface import PredictedDepth, find_checkpoint

_LOGGER = logging.getLogger(__name__)

_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)
TARGET_TOKENS = 1800  # inside MoGe's num_tokens_range [1200, 3600]


def token_budget_hw(h: int, w: int):
    """Keep the ratio, about ``TARGET_TOKENS`` 14-px patches, sides multiples
    of 14."""
    scale = math.sqrt(TARGET_TOKENS * 14 * 14 / (h * w))
    return max(1, round(h * scale / 14)) * 14, max(1, round(w * scale / 14)) * 14


def normalised_input(images: np.ndarray, hw, device) -> torch.Tensor:
    """float images [B, H, W, 3] in [0, 1] -> [B, 3, h, w] ImageNet-normalised
    after ``jax.image.resize`` bilinear."""
    x = torch.as_tensor(np.asarray(images, np.float32), device=device).permute(0, 3, 1, 2)
    x = resize(x, hw)
    mean = torch.as_tensor(_MEAN, device=device).view(1, 3, 1, 1)
    std = torch.as_tensor(_STD, device=device).view(1, 3, 1, 1)
    return (x - mean) / std


class MoGePredictor:
    name = "moge"

    def __init__(
        self,
        backbone: str = "vitl",
        checkpoint: Optional[str] = None,
        allow_random_weights: bool = False,
        device: DeviceLike = None,
        seed: int = 0,
    ):
        self.backbone = backbone
        self.name = f"moge_{backbone}"
        self.device = resolve_device(device)
        ckpt = checkpoint or find_checkpoint("moge", backbone)
        if not ckpt and not allow_random_weights:
            raise FileNotFoundError(
                "No MoGe checkpoint found. Place a moge-2 torch state_dict "
                "(moge2_<backbone>*.pt/.pth) under $GS_TPU_CHECKPOINT_DIR or "
                "~/.cache/gs_init_tpu, or pass allow_random_weights=True "
                "(mdi.allow_random_weights) for pipeline/shape testing only."
            )
        self.net = build(MoGeModel, backbone)
        if ckpt:
            from .moge_convert import load_moge_weights

            load_moge_weights(self.net, ckpt)
            _LOGGER.info("moge weights loaded from %s", ckpt)
        else:
            init_random_(self.net, seed)
            _LOGGER.warning("MoGe running with RANDOM weights (explicitly allowed) — "
                            "predictions are not meaningful")
        self.net.to(self.device).eval()

    @torch.inference_mode()
    def predict_depth_batch(self, images: np.ndarray, intrinsics) -> list:
        b, h, w = images.shape[:3]
        x = normalised_input(images, token_budget_hw(h, w), self.device)
        with full_fp32():
            out = self.net(x)
        depth = resize(out["depth"], (h, w)).cpu().numpy()
        mask = (resize(out["mask_logit"], (h, w)) > 0).cpu().numpy()
        normal = resize(out["normal"], (h, w)).permute(0, 2, 3, 1)
        normal = normal / torch.clamp(torch.linalg.norm(normal, dim=-1, keepdim=True), min=1e-8)
        normal = normal.cpu().numpy()
        preds = []
        for i in range(b):
            d = depth[i]
            preds.append(PredictedDepth(
                depth=d, mask=mask[i] & np.isfinite(d) & (d > 0), normal=normal[i],
            ))
        return preds

    def predict_depth(self, image, intrinsics) -> PredictedDepth:
        return self.predict_depth_batch(image[None], [intrinsics])[0]
