"""Depth predictor interface — the port's own copy of
``gs_init_tpu/mdi/predictors/interface.py`` (numpy only).

A predictor maps an image [H, W, 3] in [0, 1] and its intrinsics to a depth
map and a validity mask; ``predict_depth_batch`` takes a list of images.
"""
from __future__ import annotations

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


def pick_model(cfg) -> DepthPredictor:
    """The predictor ``cfg.mdi.predictor`` names. Only the stub runs in the
    port; the depth networks need their weights and come in a later slice."""
    name = cfg.mdi.predictor
    if name == "stub":
        from .stub import StubPredictor

        return StubPredictor()
    raise NotImplementedError(
        f"depth predictor {name!r} is not ported to gs_init_tpu_torch yet "
        "(the depth-network slice in ROADMAP.md); use predictor='stub'"
    )
