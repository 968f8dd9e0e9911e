"""Per-parameter Adam for the gaussian buffers — port of
``gs_init_tpu/engine/optim.py``.

Batch-size corrections as the reference: lr * sqrt(BS), betas ** BS,
eps / sqrt(BS); the means learning rate is scaled by the scene scale and
decays by gamma = 0.01 ** (1 / max_steps) per step. Moments are plain
buffers so densification can zero the moments of relocated slots. The
update runs in place on the parameter and moment buffers.

``simple_adam_*`` is the AdamW-style update of the auxiliary groups (pose
deltas, appearance embeddings and MLP, bilateral grids): one learning rate
over a tensor or a dataclass of tensors, weight decay added to the gradient.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields, is_dataclass, replace
from typing import Dict, List

import numpy as np
import torch

from .params import GaussianParams, params_from_numpy


@dataclass
class AdamState:
    mu: GaussianParams
    nu: GaussianParams
    count: int


@dataclass
class SimpleAdamState:
    """Adam state of an auxiliary group: moments shaped like its params."""

    mu: object
    nu: object
    count: int


def tensor_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tensor or a dataclass of tensors, in field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if is_dataclass(tree):
        return [getattr(tree, f.name) for f in fields(tree)]
    raise TypeError(f"expected a tensor or a dataclass of tensors, got {type(tree).__name__}")


def tree_map(fn, tree):
    """``fn`` over a tensor or each field of a dataclass of tensors."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return replace(tree, **{f.name: fn(getattr(tree, f.name)) for f in fields(tree)})


def simple_adam_init(params) -> SimpleAdamState:
    return SimpleAdamState(
        mu=tree_map(torch.zeros_like, params), nu=tree_map(torch.zeros_like, params), count=0
    )


@torch.no_grad()
def simple_adam_update(
    params,
    grads,
    state: SimpleAdamState,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> SimpleAdamState:
    """AdamW-style step in place on ``params`` and the moments; returns the
    state with its count advanced. f32 arithmetic as the JAX update:
    g += wd * p; p -= lr * (m / bc1) / (sqrt(v / bc2) + eps)."""
    count = state.count + 1
    bc1 = float(1.0 - np.float32(b1) ** np.float32(count))
    bc2 = float(1.0 - np.float32(b2) ** np.float32(count))
    lr = float(np.float32(lr))
    for p, g, m, v in zip(*(tensor_leaves(x) for x in (params, grads, state.mu, state.nu))):
        if weight_decay:
            g = g + weight_decay * p
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * (1 - b2) * g)
        p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
    return SimpleAdamState(mu=state.mu, nu=state.nu, count=count)


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
