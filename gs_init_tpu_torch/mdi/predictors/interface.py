"""Depth predictor interface — the port's own copy of
``gs_init_tpu/mdi/predictors/interface.py`` (numpy only).

A predictor maps an image [H, W, 3] in [0, 1] and its intrinsics to a depth
map and a validity mask; ``predict_depth_batch`` takes a list of images.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Protocol

import numpy as np


class CameraIntrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float


class PredictedDepth(NamedTuple):
    depth: np.ndarray  # [H, W] metric or relative depth
    mask: np.ndarray  # [H, W] bool validity
    depth_confidence: Optional[np.ndarray] = None  # [H, W]
    normal: Optional[np.ndarray] = None  # [H, W, 3]
    normal_confidence: Optional[np.ndarray] = None


class DepthPredictor(Protocol):
    name: str

    def predict_depth(self, image: np.ndarray, intrinsics: CameraIntrinsics) -> PredictedDepth:
        """image: [H, W, 3] float in [0, 1]."""
        ...

    def predict_depth_batch(self, images: np.ndarray, intrinsics: list) -> list:
        return [self.predict_depth(images[i], intrinsics[i]) for i in range(len(images))]


def find_checkpoint(tag: str, backbone: str) -> Optional[str]:
    """The first file under $GS_TPU_CHECKPOINT_DIR or ~/.cache/gs_init_tpu
    (in sorted order) whose name holds ``tag`` (any case) and ``backbone``."""
    for d in (os.environ.get("GS_TPU_CHECKPOINT_DIR", ""), os.path.expanduser("~/.cache/gs_init_tpu")):
        if d and os.path.isdir(d):
            for n in sorted(os.listdir(d)):
                if tag in n.lower() and backbone in n:
                    return os.path.join(d, n)
    return None


def pick_model(cfg, device=None) -> DepthPredictor:
    """The predictor ``cfg.mdi.predictor`` names, on ``device`` (the card by
    default), with the JAX package's backbone mapping."""
    name = cfg.mdi.predictor
    mdi = cfg.mdi
    if name == "stub":
        from .stub import StubPredictor

        return StubPredictor()
    if name == "depth_anything_v2":
        from .depth_anything_v2 import DepthAnythingV2Predictor

        return DepthAnythingV2Predictor(
            backbone=mdi.backbone, metric=mdi.metric, variant=mdi.metric_variant,
            allow_random_weights=mdi.allow_random_weights, device=device, seed=cfg.seed,
        )
    if name == "metric3d":
        from .metric3d import Metric3DPredictor

        backbone = mdi.backbone
        if backbone.startswith("vit"):
            backbone = {"vits": "small", "vitl": "large", "vitg": "giant"}.get(backbone, "small")
        return Metric3DPredictor(
            backbone=backbone, allow_random_weights=mdi.allow_random_weights,
            device=device, seed=cfg.seed,
        )
    if name == "depth_pro":
        from .apple_depth_pro import AppleDepthProPredictor

        return AppleDepthProPredictor(
            allow_random_weights=mdi.allow_random_weights, device=device, seed=cfg.seed,
        )
    if name in ("moge", "unidepth"):
        backbone = mdi.backbone
        if backbone not in ("vits", "vitb", "vitl", "vitg"):
            backbone = "vitl"  # the reference's default, moge-2-vitl-normal
        if name == "moge":
            from .moge import MoGePredictor as cls
        else:
            from .unidepth import UniDepthPredictor as cls
        return cls(backbone=backbone, allow_random_weights=mdi.allow_random_weights,
                   device=device, seed=cfg.seed)
    raise NotImplementedError(f"unknown predictor {name!r}")
