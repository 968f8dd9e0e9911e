"""Depth-Anything-V2 predictor — port of
``gs_init_tpu/mdi/predictors/depth_anything_v2.py``.

vits/b/l/g, metric (Hypersim indoor, VKITTI outdoor: sigmoid * max_depth)
or relative, where the network gives disparity and the depth is
1/(d + 1e-6). Images are resized keeping their ratio so the smaller side is
``input_size`` (518), both sides multiples of 14, with ``jax.image.resize``'s
antialiased bilinear (``models/common.resize``), and the output is resized
back the same way. Float32 with TF32 off, a batch at a time on ``device``.

Weights: the official ``.pth`` (``depth_anything_v2[_metric_{hypersim,
vkitti}]_{backbone}.pth``: the port's parameter names are its own, so it
loads by name) or the HuggingFace ``model.safetensors`` layout
(``depth_anything_v2_{size}_hf.safetensors``, renamed by
``convert_hf_checkpoint``), under ``$GS_TPU_CHECKPOINT_DIR``,
``~/.cache/gs_init_tpu`` or ``checkpoints/``. Without one the predictor
raises FileNotFoundError unless ``allow_random_weights`` is set. The
safetensors format is read here (``read_safetensors``): the card's machine
has no ``safetensors`` package.
"""
from __future__ import annotations

import json
import logging
import os
import struct
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...device import DeviceLike, resolve_device
from ...models.common import build, full_fp32, init_random_, load_checked, resize
from ...models.common import state_dict_from_flax as _from_flax
from ...models.dpt import DPT_CONFIGS, DPT_RENAMES, DPT_TRANSPOSED, DPTHead
from ...models.vit import VIT_CONFIGS, VIT_RENAMES, DinoViT, from_hf_dinov2
from .interface import PredictedDepth

_LOGGER = logging.getLogger(__name__)

_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)

MAX_DEPTH = {"indoor": 20.0, "outdoor": 80.0}


class DepthAnythingV2Net(nn.Module):
    """x [B, 3, H, W] normalised, H and W multiples of 14 -> [B, H, W]."""

    def __init__(self, backbone: str = "vits", metric: bool = False, max_depth: float = 20.0):
        super().__init__()
        v = VIT_CONFIGS[backbone]
        self.pretrained = DinoViT(dim=v["dim"], depth=v["depth"], num_heads=v["num_heads"],
                                  out_layers=v["out_layers"])
        self.depth_head = DPTHead(v["dim"], **DPT_CONFIGS[backbone], metric=metric, max_depth=max_depth)

    def forward(self, x):
        feats, _ = self.pretrained(x)
        return self.depth_head(feats, (x.shape[2] // 14, x.shape[3] // 14))


def _ckpt_candidates(backbone: str, metric: bool, variant: str) -> Optional[str]:
    size = {"vits": "small", "vitb": "base", "vitl": "large", "vitg": "giant"}[backbone]
    names = []
    if metric:
        ds = "hypersim" if variant == "indoor" else "vkitti"
        names.append(f"depth_anything_v2_metric_{ds}_{backbone}.pth")
    names.append(f"depth_anything_v2_{backbone}.pth")
    names.append(f"depth_anything_v2_{size}_hf.safetensors")
    dirs = [os.environ.get("GS_TPU_CHECKPOINT_DIR", ""),
            os.path.expanduser("~/.cache/gs_init_tpu"), "checkpoints"]
    for d in dirs:
        for n in names:
            p = os.path.join(d, n)
            if d and os.path.exists(p):
                return p
    return None


# ------------------------------------------------------------- checkpoints

_ST_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4", "I16": "<i2",
    "I8": "i1", "U8": "u1", "BOOL": "?",
}


def read_safetensors(path: str) -> dict:
    """A ``.safetensors`` file as {name: numpy array}: an 8-byte
    little-endian header length, a JSON header of dtype, shape and byte
    offsets, then the little-endian buffers. BF16 comes out as float32."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        buf = data[start:end]
        if meta["dtype"] == "BF16":
            bits = np.frombuffer(buf, "<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            arr = np.frombuffer(buf, _ST_DTYPES[meta["dtype"]]).copy()
        out[name] = arr.reshape(meta["shape"])
    return out


def load_checkpoint_file(path: str) -> dict:
    """A torch ``.pth`` / ``.pt`` (its ``model`` entry where it has one) or a
    ``.safetensors`` state dict."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("model", sd)


def convert_hf_checkpoint(state_dict: dict, backbone: str) -> dict:
    """A HuggingFace ``DepthAnythingForDepthEstimation`` state dict renamed to
    the official (and the port's) names."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    dh = "depth_head"
    out = from_hf_dinov2(sd, "backbone", "pretrained", VIT_CONFIGS[backbone]["depth"])

    def conv(dst, src):
        for leaf in ("weight", "bias"):
            if f"{src}.{leaf}" in sd:
                out[f"{dst}.{leaf}"] = sd[f"{src}.{leaf}"]

    reassemble = "neck.reassemble_stage.layers"
    for i in range(4):
        conv(f"{dh}.projects.{i}", f"{reassemble}.{i}.projection")
        conv(f"{dh}.scratch.layer{i + 1}_rn", f"neck.convs.{i}")
    for i in (0, 1, 3):
        conv(f"{dh}.resize_layers.{i}", f"{reassemble}.{i}.resize")
    for i, rf in enumerate((4, 3, 2, 1)):
        hb, fb = f"neck.fusion_stage.layers.{i}", f"{dh}.scratch.refinenet{rf}"
        for unit in (1, 2):
            for c in (1, 2):
                conv(f"{fb}.resConfUnit{unit}.conv{c}", f"{hb}.residual_layer{unit}.convolution{c}")
        conv(f"{fb}.out_conv", f"{hb}.projection")
    conv(f"{dh}.scratch.output_conv1", "head.conv1")
    conv(f"{dh}.scratch.output_conv2.0", "head.conv2")
    conv(f"{dh}.scratch.output_conv2.2", "head.conv3")
    return out


def load_dav2_state_dict(net: DepthAnythingV2Net, state_dict: dict, backbone: str):
    """Load an official or a HuggingFace-layout state dict into ``net``."""
    if any(k.startswith("backbone.embeddings") for k in state_dict):
        state_dict = convert_hf_checkpoint(state_dict, backbone)
    return load_checked(net, state_dict, "depth_anything_v2")


def state_dict_from_flax(variables: dict) -> dict:
    """The JAX package's ``DepthAnythingV2Net`` variables -> the port's
    state dict."""
    return _from_flax(variables, VIT_RENAMES + DPT_RENAMES, DPT_TRANSPOSED)


class DepthAnythingV2Predictor:
    name = "depth_anything_v2"

    def __init__(
        self,
        backbone: str = "vits",
        metric: bool = False,
        variant: str = "indoor",
        input_size: int = 518,
        checkpoint: Optional[str] = None,
        allow_random_weights: bool = False,
        device: DeviceLike = None,
        seed: int = 0,
    ):
        self.backbone, self.metric, self.input_size = backbone, metric, input_size
        self.device = resolve_device(device)
        ckpt = checkpoint or _ckpt_candidates(backbone, metric, variant)
        if ckpt is None and not allow_random_weights:
            raise FileNotFoundError(
                "No Depth-Anything-V2 checkpoint found. Place the official "
                "depth_anything_v2[_metric_{hypersim,vkitti}]_<backbone>.pth or "
                "the HuggingFace depth_anything_v2_<size>_hf.safetensors under "
                "$GS_TPU_CHECKPOINT_DIR or ~/.cache/gs_init_tpu, or pass "
                "allow_random_weights=True (mdi.allow_random_weights) for "
                "pipeline/shape testing only."
            )
        self.net = build(DepthAnythingV2Net, backbone, metric, MAX_DEPTH[variant])
        if ckpt is not None:
            load_dav2_state_dict(self.net, load_checkpoint_file(ckpt), backbone)
            _LOGGER.info("loaded DA-V2 checkpoint %s", ckpt)
        else:
            init_random_(self.net, seed)
            _LOGGER.warning(
                "Depth-Anything-V2 running with RANDOM weights (explicitly "
                "allowed) — predictions are not meaningful"
            )
        self.net.to(self.device).eval()

    def _net_size(self, h, w):
        # Keep the ratio: the smaller side -> input_size, both multiples of 14.
        scale = self.input_size / min(h, w)
        nh = max(round(h * scale / 14) * 14, 14)
        nw = max(round(w * scale / 14) * 14, 14)
        return nh, nw

    @torch.inference_mode()
    def _forward(self, imgs_u8: np.ndarray, nh: int, nw: int) -> np.ndarray:
        h, w = imgs_u8.shape[1:3]
        dev = self.device
        x = torch.from_numpy(imgs_u8).to(dev).permute(0, 3, 1, 2).float() * (1.0 / 255.0)
        x = resize(x, (nh, nw))
        x = (x - torch.as_tensor(_MEAN, device=dev).view(1, 3, 1, 1)) / torch.as_tensor(
            _STD, device=dev).view(1, 3, 1, 1)
        with full_fp32():
            out = self.net(x)
        return resize(out, (h, w)).cpu().numpy()

    def predict_depth_batch(self, images: np.ndarray, intrinsics) -> list:
        b, h, w = images.shape[:3]
        nh, nw = self._net_size(h, w)
        if images.dtype != np.uint8:
            images = np.clip(np.asarray(images, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)
        out = self._forward(np.ascontiguousarray(images), nh, nw)
        preds = []
        for i in range(b):
            d = out[i]
            if not self.metric:
                # Relative models give disparity: depth = 1/(d + 1e-6).
                mask = d > 1e-4
                d = 1.0 / (d + 1e-6)
            else:
                mask = d > 0
            preds.append(PredictedDepth(depth=d.astype(np.float32), mask=mask))
        return preds

    def predict_depth(self, image, intrinsics) -> PredictedDepth:
        return self.predict_depth_batch(image[None], [intrinsics])[0]
