"""Apple DepthPro predictor — port of
``gs_init_tpu/mdi/predictors/apple_depth_pro.py``.

Metric depth from one image and the focal length ``f_px = (fx + fy) / 2``
of its intrinsics (without them, from the FOV branch when the net has one,
else half the width). The image is resized to ``input_size`` square (1536;
``jax.image.resize`` bilinear, antialiased when it shrinks) and normalised
to [-1, 1]; the net gives canonical inverse depth, resized back to the
image, and the depth is ``1 / clip(inv * W / f_px, 1e-4, 1e4)``, as
HuggingFace's post-processing computes it. Float32 with TF32 off, a batch
at a time on ``device``; images go to the card as float32. With the tracer
on (``trace.py``) each batch is span ``depth_pro.predict``, with CUDA events:
its self time is the resizes, the copy to the host and the conversion.

Weights: the HuggingFace ``apple/DepthPro-hf`` state dict (a file whose
name holds "depth" and "pro") under ``$GS_TPU_CHECKPOINT_DIR``,
``~/.cache/gs_init_tpu`` or ``checkpoints/``, renamed by
``convert_hf_checkpoint``. Without one the predictor raises
FileNotFoundError unless ``allow_random_weights`` is set.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from ... import trace
from ...device import DeviceLike, resolve_device
from ...models.common import build, full_fp32, init_random_, load_checked, resize
from ...models.common import state_dict_from_flax as _from_flax
from ...models.depth_pro import DEPTH_PRO_RENAMES, DEPTH_PRO_TRANSPOSED, DepthProNet
from ...models.vit import VIT_RENAMES, from_hf_dinov2
from .depth_anything_v2 import load_checkpoint_file
from .interface import PredictedDepth

_LOGGER = logging.getLogger(__name__)

_VITS = ("depth_pro.encoder.patch_encoder.model", "depth_pro.encoder.image_encoder.model",
         "fov_model.fov_encoder.model")


def convert_hf_checkpoint(state_dict: dict, depth: int) -> dict:
    """A HuggingFace ``DepthProForDepthEstimation`` state dict (ViTs of
    ``depth`` blocks) renamed to the port's names: each DINOv2 subtree to
    ``DinoViT``'s, everything else as it is."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    out = {k: v for k, v in sd.items() if not k.startswith(_VITS)}
    for prefix in _VITS:
        if f"{prefix}.embeddings.cls_token" in sd:
            out.update(from_hf_dinov2(sd, prefix, prefix, depth))
    return out


def load_depth_pro_state_dict(net: DepthProNet, state_dict: dict):
    return load_checked(net, convert_hf_checkpoint(state_dict, net.vit_depth), "depth_pro")


def state_dict_from_flax(variables: dict) -> dict:
    """The JAX package's ``DepthProNet`` variables -> the port's state dict."""
    return _from_flax(variables, VIT_RENAMES + DEPTH_PRO_RENAMES, DEPTH_PRO_TRANSPOSED)


def _find_ckpt() -> Optional[str]:
    for d in (os.environ.get("GS_TPU_CHECKPOINT_DIR", ""), os.path.expanduser("~/.cache/gs_init_tpu"),
              "checkpoints"):
        if d and os.path.isdir(d):
            for n in sorted(os.listdir(d)):
                if "depth" in n.lower() and "pro" in n.lower():
                    return os.path.join(d, n)
    return None


class AppleDepthProPredictor:
    name = "apple_depth_pro"

    def __init__(
        self,
        checkpoint: Optional[str] = None,
        input_size: int = 1536,
        allow_random_weights: bool = False,
        device: DeviceLike = None,
        seed: int = 0,
        **net_kwargs,
    ):
        self.input_size = input_size
        self.device = resolve_device(device)
        ckpt = checkpoint or _find_ckpt()
        if not ckpt and not allow_random_weights:
            raise FileNotFoundError(
                "No DepthPro checkpoint found. Place the apple/DepthPro-hf "
                "model.safetensors under $GS_TPU_CHECKPOINT_DIR or "
                "~/.cache/gs_init_tpu, or pass allow_random_weights=True."
            )
        self.net = build(DepthProNet, **net_kwargs)
        if ckpt:
            load_depth_pro_state_dict(self.net, load_checkpoint_file(ckpt))
            _LOGGER.info("DepthPro weights loaded from %s", ckpt)
        else:
            init_random_(self.net, seed)
            _LOGGER.warning("DepthPro running with RANDOM weights (explicitly allowed)")
        self.net.to(self.device).eval()

    @trace.spanned("depth_pro.predict")
    @torch.inference_mode()
    def predict_depth_batch(self, images: np.ndarray, intrinsics) -> list:
        b, h, w = images.shape[:3]
        s = self.input_size
        x = torch.as_tensor(np.asarray(images, np.float32), device=self.device).permute(0, 3, 1, 2)
        x = (resize(x, (s, s)) - 0.5) / 0.5
        with full_fp32():
            inv, fov = self.net(x)
        inv = resize(inv, (h, w)).cpu().numpy()
        fov = None if fov is None else fov.cpu().numpy()
        preds = []
        for i in range(b):
            if intrinsics[i] is not None:
                f_px = 0.5 * (float(intrinsics[i].fx) + float(intrinsics[i].fy))
            elif fov is not None:
                f_px = 0.5 * w / np.tan(0.5 * np.deg2rad(float(fov[i])))
            else:
                f_px = 0.5 * w
            d = 1.0 / np.clip(inv[i] * (w / f_px), 1e-4, 1e4)
            preds.append(PredictedDepth(depth=d.astype(np.float32), mask=np.ones_like(d, bool)))
        return preds

    def predict_depth(self, image, intrinsics) -> PredictedDepth:
        return self.predict_depth_batch(image[None], [intrinsics])[0]
