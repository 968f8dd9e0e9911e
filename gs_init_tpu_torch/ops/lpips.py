"""LPIPS perceptual metric over AlexNet features — port of
``gs_init_tpu/ops/lpips.py``.

The weights come from a local file only. ``_find_weights`` looks in
``$GS_TPU_CHECKPOINT_DIR``, ``~/.cache/gs_init_tpu`` and ``./checkpoints``
for a file named ``lpips_alex*`` or ``alexnet*`` ending in ``.npz``,
``.pth`` or ``.pt``, and reads any of three layouts:

  - the npz of ``scripts/convert_lpips.py`` (``conv{i}_w`` HWIO,
    ``conv{i}_b``, optional ``lin{i}``);
  - the official ``lpips_alex.pth`` bundle (``net.slice{k}.{layer}.*`` and
    ``lin{i}.model.1.weight``);
  - a torchvision ``alexnet-*.pth`` state dict (``features.{layer}.*``).

Without the five ``lin{i}`` calibration vectors the distance is the mean
over channels of the squared unit-normalised feature difference, as the
JAX package computes it (it ranks degradations, its absolute values are not
the official ones). ``lpips_available()`` gates the Runner's LPIPS.

Plain ``F.conv2d`` / ``F.max_pool2d`` in full float32 (TF32 off).
"""
from __future__ import annotations

import functools
import logging
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.common import full_fp32

_LOGGER = logging.getLogger(__name__)

# AlexNet's feature extractor: (out_ch, kernel, stride, pad, pool_before).
_ALEX_LAYERS = [
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)
_TV_IDX = [0, 3, 6, 8, 10]  # torchvision's features.{i} of the five convs


def _find_weights() -> Optional[str]:
    for d in [
        os.environ.get("GS_TPU_CHECKPOINT_DIR", ""),
        os.path.expanduser("~/.cache/gs_init_tpu"),
        "checkpoints",
    ]:
        if not d or not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if name.startswith(("lpips_alex", "alexnet")) and name.endswith((".npz", ".pth", ".pt")):
                return os.path.join(d, name)
    return None


def lpips_available() -> bool:
    return _find_weights() is not None


Params = Tuple[List[Tuple[torch.Tensor, torch.Tensor]], Optional[List[torch.Tensor]]]


def read_weights(path: str) -> Params:
    """(convs [(weight OIHW, bias)] x 5, lins [ch] x 5 or None) from any of
    the three layouts, as CPU float32 tensors."""
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    if path.endswith(".npz"):
        with np.load(path) as data:
            convs = [(f32(data[f"conv{i}_w"].transpose(3, 2, 0, 1)), f32(data[f"conv{i}_b"]))
                     for i in range(5)]
            lins = ([f32(data[f"lin{i}"]).reshape(-1) for i in range(5)]
                    if all(f"lin{i}" in data.files for i in range(5)) else None)
        if lins is None:
            _LOGGER.warning("LPIPS npz has no linear calibration; using unit weights")
        return convs, lins
    sd = torch.load(path, map_location="cpu", weights_only=True)
    convs, lins = [], []
    if "features.0.weight" in sd:  # torchvision alexnet
        convs = [(sd[f"features.{i}.weight"].float(), sd[f"features.{i}.bias"].float()) for i in _TV_IDX]
        lins = None
    else:  # the LPIPS bundle
        for k, layer in enumerate(_TV_IDX):
            for key in (f"net.slice{k + 1}.{layer}.weight", f"net.features.{layer}.weight"):
                if key in sd:
                    convs.append((sd[key].float(), sd[key.replace("weight", "bias")].float()))
                    break
        for i in range(5):
            for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
                if key in sd:
                    lins.append(sd[key].float()[:, :, 0, 0].reshape(-1))
                    break
        if len(convs) != 5:
            raise ValueError(f"unrecognized LPIPS checkpoint layout: {path}")
        if len(lins) != 5:
            lins = None
    if lins is None:
        _LOGGER.warning(
            "LPIPS linear calibration missing; using unit weights (relative comparisons remain valid)"
        )
    return convs, lins


@functools.lru_cache(maxsize=4)
def _load_params(path: str, mtime_ns: int, device: str) -> Params:
    convs, lins = read_weights(path)
    dev = torch.device(device)
    return ([(w.to(dev), b.to(dev)) for w, b in convs],
            None if lins is None else [v.to(dev) for v in lins])


def _alex_features(x: torch.Tensor, convs) -> List[torch.Tensor]:
    """x: [B, 3, H, W] in [-1, 1] -> the five ReLU feature maps."""
    dev = x.device
    x = (x - torch.as_tensor(_SHIFT, device=dev).view(1, 3, 1, 1)) / torch.as_tensor(
        _SCALE, device=dev).view(1, 3, 1, 1)
    feats = []
    for (w, b), (_, _, s, p, pool) in zip(convs, _ALEX_LAYERS):
        if pool:
            x = F.max_pool2d(x, 3, 2)
        x = F.relu(F.conv2d(x, w, b, stride=s, padding=p))
        feats.append(x)
    return feats


@torch.no_grad()
def lpips(img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """LPIPS distance between [B, H, W, 3] images in [0, 1] (mapped to
    [-1, 1] first, as LPIPS's normalize=True does); a 0-d tensor, the mean
    over the batch. Runs where the images are."""
    path = _find_weights()
    if path is None:
        raise FileNotFoundError("no AlexNet/LPIPS weights found (set GS_TPU_CHECKPOINT_DIR)")
    convs, lins = _load_params(path, os.stat(path).st_mtime_ns, str(img0.device))
    to_nchw = lambda x: (x.float() * 2.0 - 1.0).permute(0, 3, 1, 2)
    with full_fp32():
        f0 = _alex_features(to_nchw(img0), convs)
        f1 = _alex_features(to_nchw(img1), convs)
        total = 0.0
        for i, (a, b) in enumerate(zip(f0, f1)):
            a = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=1e-10)
            b = b / torch.clamp(torch.linalg.vector_norm(b, dim=1, keepdim=True), min=1e-10)
            d = (a - b) ** 2
            if lins is not None:
                d = torch.einsum("bchw,c->bhw", d, lins[i])
            else:
                d = d.mean(dim=1)
            total = total + d.mean(dim=(1, 2))
    return total.mean()
