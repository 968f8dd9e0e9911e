"""Metric3D v2 weights for the port — counterpart of
``gs_init_tpu/mdi/predictors/metric3d_convert.py``.

The port's ``Metric3DNet`` carries the official checkpoint's parameter
names (``encoder.`` the DINOv2-reg ViT, ``decoder.`` RAFTDepthNormalDPT5),
so loading a checkpoint is a key normalisation and a checked load:
optional ``module.`` / ``model.`` wrappers and the ``depth_model.`` prefix
are dropped, chunked ViT blocks ``encoder.blocks.0.{i}`` become
``encoder.blocks.{i}``, and a ``model_state_dict`` entry is unwrapped.
Every parameter of the network must be present with its shape, or the load
raises ValueError; keys the network does not read are ignored.

``state_dict_from_flax`` carries the JAX package's flax variables for
``Metric3DNet`` across into the port (the tests run both packages on the
same random weights that way).
"""
from __future__ import annotations

import re

from ...models.common import load_checked, state_dict_from_flax as _from_flax
from ...models.raft_dpt import RAFT_RENAMES, RAFT_TRANSPOSED
from ...models.vit import VIT_RENAMES
from .depth_anything_v2 import load_checkpoint_file


def normalize_keys(state_dict: dict) -> dict:
    out = {}
    for k, v in state_dict.items():
        k = re.sub(r"^(module\.)+", "", k)
        if k.startswith("model."):
            k = k[len("model."):]
        if k.startswith("depth_model."):
            k = k[len("depth_model."):]
        k = re.sub(r"^encoder\.blocks\.0\.(\d+)\.", r"encoder.blocks.\1.", k)
        out[k] = v
    return out


def load_metric3d_state_dict(net, state_dict: dict):
    """Load an official-layout state dict into a ``Metric3DNet``."""
    if "model_state_dict" in state_dict:
        state_dict = state_dict["model_state_dict"]
    return load_checked(net, normalize_keys(state_dict), "metric3d")


def load_metric3d_weights(net, path: str):
    """Load a checkpoint file (.pth / .pt / .safetensors) into ``net``."""
    return load_metric3d_state_dict(net, load_checkpoint_file(path))


def state_dict_from_flax(variables: dict) -> dict:
    """The JAX package's ``Metric3DNet`` variables -> the port's state dict."""
    return _from_flax(variables, VIT_RENAMES + RAFT_RENAMES, RAFT_TRANSPOSED)
