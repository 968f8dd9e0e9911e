"""Per-parameter Adam for the gaussian buffers — port of
``gs_init_tpu/engine/optim.py``.

Batch-size corrections as the reference: lr * sqrt(BS), betas ** BS,
eps / sqrt(BS); the means learning rate is scaled by the scene scale and
decays by gamma = 0.01 ** (1 / max_steps) per step. Moments are plain
buffers so densification can zero the moments of relocated slots. The
update runs in place on the parameter and moment buffers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from .params import GaussianParams, params_from_numpy


@dataclass
class AdamState:
    mu: GaussianParams
    nu: GaussianParams
    count: int


@dataclass(frozen=True)
class AdamConfig:
    lrs: Dict[str, float]  # per-leaf base learning rates
    b1: float
    b2: float
    eps: float
    means_decay_gamma: float


def make_adam_config(cfg, scene_scale: float, batch_size: int = 1) -> AdamConfig:
    bs = batch_size * max(cfg.data_parallel, 1)
    s = math.sqrt(bs)
    lrs = dict(
        means=cfg.means_lr * scene_scale * s,
        quats=cfg.quats_lr * s,
        scales=cfg.scales_lr * s,
        opacities=cfg.opacities_lr * s,
        sh0=cfg.sh0_lr * s,
        shN=cfg.shN_lr * s,
    )
    return AdamConfig(
        lrs=lrs,
        b1=0.9**bs,
        b2=0.999**bs,
        eps=1e-15 / s,
        means_decay_gamma=0.01 ** (1.0 / max(cfg.max_steps, 1)),
    )


def init_adam_state(params: GaussianParams) -> AdamState:
    return AdamState(
        mu=params.map(torch.zeros_like), nu=params.map(torch.zeros_like), count=0
    )


def adam_from_numpy(mu: dict, nu: dict, count, device) -> AdamState:
    """AdamState from numpy leaves (e.g. the JAX AdamState's)."""
    return AdamState(
        mu=params_from_numpy(mu, device),
        nu=params_from_numpy(nu, device),
        count=int(np.asarray(count)),
    )


@torch.no_grad()
def adam_update(
    params: GaussianParams,
    grads: GaussianParams,
    state: AdamState,
    acfg: AdamConfig,
    step: int,
) -> AdamState:
    """One Adam step, in place on ``params`` and the moments; returns the
    state with its count advanced. Same f32 arithmetic as the JAX update:
    p -= lr * (m / bc1) / (sqrt(v / bc2) + eps)."""
    count = state.count + 1
    bc1 = 1.0 - np.float32(acfg.b1) ** np.float32(count)
    bc2 = 1.0 - np.float32(acfg.b2) ** np.float32(count)
    means_scale = float(np.float32(acfg.means_decay_gamma) ** np.float32(step))
    for name, p in params.items():
        g = getattr(grads, name)
        m = getattr(state.mu, name)
        v = getattr(state.nu, name)
        m.mul_(acfg.b1).add_(g * (1 - acfg.b1))
        v.mul_(acfg.b2).add_(g * (1 - acfg.b2) * g)
        lr = acfg.lrs[name] * (means_scale if name == "means" else 1.0)
        p.sub_(lr * (m / float(bc1)) / (torch.sqrt(v / float(bc2)) + acfg.eps))
    return AdamState(mu=state.mu, nu=state.nu, count=count)
