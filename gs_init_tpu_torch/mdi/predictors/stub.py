"""Stub depth predictor for tests and bring-up — the port's own copy of
``gs_init_tpu/mdi/predictors/stub.py`` (numpy only).

Produces a *relative* depth map from an oracle (for example a synthetic
scene's surface depth) under an affine distortion, so that alignment must
recover the scale and shift; with no oracle, a smooth ramp.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .interface import CameraIntrinsics, PredictedDepth


class StubPredictor:
    name = "stub"

    def __init__(
        self,
        oracle: Optional[Callable[[np.ndarray, CameraIntrinsics], np.ndarray]] = None,
        scale: float = 0.37,
        shift: float = 1.3,
        noise: float = 0.0,
        seed: int = 0,
    ):
        self.oracle = oracle
        self.scale = scale
        self.shift = shift
        self.noise = noise
        self.rng = np.random.default_rng(seed)

    def predict_depth(self, image, intrinsics) -> PredictedDepth:
        h, w = image.shape[:2]
        if self.oracle is not None:
            true_depth = np.asarray(self.oracle(image, intrinsics))
            mask = np.isfinite(true_depth) & (true_depth > 0)
        else:
            yy = np.linspace(1.0, 3.0, h)[:, None]
            xx = np.linspace(0.0, 1.0, w)[None, :]
            true_depth = yy + 0.3 * xx
            mask = np.ones((h, w), bool)
        depth = self.scale * true_depth + self.shift
        if self.noise > 0:
            depth = depth + self.rng.normal(0, self.noise, depth.shape)
        return PredictedDepth(depth=depth.astype(np.float32), mask=mask.astype(bool))

    def predict_depth_batch(self, images, intrinsics):
        return [self.predict_depth(images[i], intrinsics[i]) for i in range(len(images))]
