"""UniDepth-v2 predictor — port of ``gs_init_tpu/mdi/predictors/unidepth.py``.

Camera-conditioned metric depth: the image is resized to about 1,800 ViT
tokens (``jax.image.resize`` bilinear, antialiased when it shrinks), the
intrinsics are rescaled to that resolution and condition the prediction
(without them the network's camera head predicts its own); depth and
confidence are resized back. Float32 with TF32 off, a batch at a time on
``device``; images go to the card as float32, as the JAX package sends them.

Weights: a UniDepth-v2 state dict (``unidepth*<backbone>*``) under
``$GS_TPU_CHECKPOINT_DIR`` or ``~/.cache/gs_init_tpu``, loaded by
``unidepth_convert``. Without one the predictor raises FileNotFoundError
unless ``allow_random_weights`` is set (random weights from ``seed``: for
shape and pipeline runs only).
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ...models.common import build, full_fp32, init_random_, resize
from ...models.unidepth import UniDepthModel
from .interface import PredictedDepth, find_checkpoint
from .moge import normalised_input, token_budget_hw

_LOGGER = logging.getLogger(__name__)


class UniDepthPredictor:
    name = "unidepth"

    def __init__(
        self,
        backbone: str = "vitl",
        checkpoint: Optional[str] = None,
        allow_random_weights: bool = False,
        device: DeviceLike = None,
        seed: int = 0,
    ):
        self.backbone = backbone
        self.name = f"unidepth_{backbone}"
        self.device = resolve_device(device)
        ckpt = checkpoint or find_checkpoint("unidepth", backbone)
        if not ckpt and not allow_random_weights:
            raise FileNotFoundError(
                "No UniDepth checkpoint found. Place a unidepth-v2 torch "
                "state_dict (unidepth_v2_<backbone>*.pt/.pth) under "
                "$GS_TPU_CHECKPOINT_DIR or ~/.cache/gs_init_tpu, or pass "
                "allow_random_weights=True (mdi.allow_random_weights) for "
                "pipeline testing only."
            )
        self.net = build(UniDepthModel, backbone)
        if ckpt:
            from .unidepth_convert import load_unidepth_weights

            load_unidepth_weights(self.net, ckpt)
            _LOGGER.info("unidepth weights loaded from %s", ckpt)
        else:
            init_random_(self.net, seed)
            _LOGGER.warning("UniDepth running with RANDOM weights (explicitly allowed) — "
                            "predictions are not meaningful")
        self.net.to(self.device).eval()

    @torch.inference_mode()
    def predict_depth_batch(self, images: np.ndarray, intrinsics) -> list:
        b, h, w = images.shape[:3]
        nh, nw = token_budget_hw(h, w)
        x = normalised_input(images, (nh, nw), self.device)
        K = None
        if all(it is not None for it in intrinsics):
            K = torch.as_tensor(np.stack([
                np.array([[it.fx * nw / w, 0, it.cx * nw / w],
                          [0, it.fy * nh / h, it.cy * nh / h],
                          [0, 0, 1]], np.float32)
                for it in intrinsics
            ]), device=self.device)
        with full_fp32():
            out = self.net(x, K)
        depth = resize(out["depth"], (h, w)).cpu().numpy()
        conf = resize(out["confidence"], (h, w)).cpu().numpy()
        return [
            PredictedDepth(depth=depth[i], mask=np.isfinite(depth[i]) & (depth[i] > 0),
                           depth_confidence=conf[i])
            for i in range(b)
        ]

    def predict_depth(self, image, intrinsics) -> PredictedDepth:
        return self.predict_depth_batch(image[None], [intrinsics])[0]
