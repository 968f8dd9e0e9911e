"""UniDepth-v2 weights for the port — counterpart of
``gs_init_tpu/mdi/predictors/unidepth_convert.py``.

The checkpoint layout is the one the JAX converter reads (``encoder.``
DINOv2, ``camera_head.{0,2}``, ``projects.{i}``, ``ray_projs.{i}``,
``refine.{j}.{rcu1,rcu2}.conv{1,2}`` and ``refine.{j}.out_conv``,
``out.{0,2}``); one ``model.`` / ``module.`` prefix is dropped and the
residual units renamed to the port's ``resConfUnit{1,2}``. Every parameter
must be present with its shape (ValueError otherwise). Official release
weights may spell keys differently: this module is the one place to map
them.
"""
from __future__ import annotations

import re

from ...models.common import load_checked, state_dict_from_flax as _from_flax
from ...models.unidepth import UNIDEPTH_RENAMES
from ...models.vit import VIT_RENAMES
from .depth_anything_v2 import load_checkpoint_file


def load_unidepth_state_dict(net, state_dict: dict):
    sd = {}
    for k, v in state_dict.items():
        k = re.sub(r"^(model|module)\.", "", k)
        sd[re.sub(r"^refine\.(\d)\.rcu(\d)\.", r"refine.\1.resConfUnit\2.", k)] = v
    return load_checked(net, sd, "unidepth")


def load_unidepth_weights(net, path: str):
    return load_unidepth_state_dict(net, load_checkpoint_file(path))


def state_dict_from_flax(variables: dict) -> dict:
    """The JAX package's ``UniDepthModel`` variables -> the port's state dict."""
    return _from_flax(variables, VIT_RENAMES + UNIDEPTH_RENAMES)
