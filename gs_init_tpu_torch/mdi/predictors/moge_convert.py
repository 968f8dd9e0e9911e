"""MoGe-2 weights for the port — counterpart of
``gs_init_tpu/mdi/predictors/moge_convert.py``.

The port's ``MoGeModel`` carries the key layout the JAX converter reads
(``encoder.`` DINOv2, ``head.projects.{i}``, ``head.upsample.{i}``,
``head.res.{i}.{j}.conv{1,2}``, ``head.out.{0,2}``, ``scale_head.{0,2}``),
so a checkpoint loads by name after one ``model.`` or ``module.`` prefix
is dropped; every parameter must be present with its shape (ValueError
otherwise). Official release weights may spell keys differently: this
module is the one place to map them.
"""
from __future__ import annotations

import re

from ...models.common import load_checked, state_dict_from_flax as _from_flax
from ...models.moge import MOGE_RENAMES
from ...models.vit import VIT_RENAMES
from .depth_anything_v2 import load_checkpoint_file


def load_moge_state_dict(net, state_dict: dict):
    sd = {re.sub(r"^(model|module)\.", "", k): v for k, v in state_dict.items()}
    return load_checked(net, sd, "moge")


def load_moge_weights(net, path: str):
    return load_moge_state_dict(net, load_checkpoint_file(path))


def state_dict_from_flax(variables: dict) -> dict:
    """The JAX package's ``MoGeModel`` variables -> the port's state dict."""
    return _from_flax(variables, VIT_RENAMES + MOGE_RENAMES)
