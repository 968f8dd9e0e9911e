"""Default densification strategy (grow / split / prune) on capacity
buffers — port of ``gs_init_tpu/engine/strategy/default.py``.

Same decision rules as gsplat's DefaultStrategy; new gaussians go into free
slots of the fixed buffers (candidates beyond the free slots are dropped)
and the alive mask flips. ``refine`` takes its split noise as tensors so a
caller can draw it (or hand over the JAX package's draws for parity).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ... import trace
from ...config import DefaultStrategyConfig
from ...ops.projection import quat_to_rotmat
from ..optim import AdamState
from ..params import GaussianState


@dataclass
class DefaultStrategyState:
    grad2d: torch.Tensor  # [CAP] accumulated screen-grad norms
    count: torch.Tensor  # [CAP] visibility counts
    radii_max: torch.Tensor  # [CAP] max radius / max(width, height)


def init_state(capacity: int, device=None) -> DefaultStrategyState:
    z = lambda: torch.zeros((capacity,), dtype=torch.float32, device=device)
    return DefaultStrategyState(grad2d=z(), count=z(), radii_max=z())


def strategy_from_numpy(grad2d, count, radii_max, device) -> DefaultStrategyState:
    """DefaultStrategyState from numpy leaves (e.g. the JAX state's)."""
    t = lambda x: torch.as_tensor(np.array(x), device=device).float()
    return DefaultStrategyState(grad2d=t(grad2d), count=t(count), radii_max=t(radii_max))


@torch.no_grad()
def update_state(
    state: DefaultStrategyState,
    means2d_grads: torch.Tensor,  # [C, CAP, 2]
    radii: torch.Tensor,  # [C, CAP] int32
    width: int,
    height: int,
) -> DefaultStrategyState:
    """Accumulate densification statistics (in place). Pixel grads are
    scaled by [W/2, H/2] times the camera count, as gsplat does."""
    c = means2d_grads.shape[0]
    scale = torch.tensor(
        [width * c / 2.0, height * c / 2.0], dtype=torch.float32, device=means2d_grads.device
    )
    norms = torch.linalg.norm(means2d_grads * scale, dim=-1)
    visible = radii > 0
    state.grad2d += torch.where(visible, norms, 0.0).sum(0)
    state.count += visible.sum(0).float()
    torch.maximum(
        state.radii_max,
        radii.amax(0).float() / float(max(width, height)),
        out=state.radii_max,
    )
    return state


def _alloc_slots(alive: torch.Tensor, cand: torch.Tensor):
    """Assign a free slot to each candidate; returns (dst, ok)."""
    cap = alive.shape[0]
    free_idx = torch.argsort(alive.to(torch.int8), stable=True)  # dead slots first
    n_free = cap - alive.sum()
    rank = torch.cumsum(cand.long(), 0) - 1
    ok = cand & (rank < n_free)
    dst = free_idx[rank.clamp(0, cap - 1)]
    return dst, ok


def split_noise(capacity: int, generator: torch.Generator, device=None):
    """The two [CAP, 3] standard-normal draws ``refine`` uses for splits."""
    eps1 = torch.randn((capacity, 3), generator=generator, device=device)
    eps2 = torch.randn((capacity, 3), generator=generator, device=device)
    return eps1, eps2


@trace.spanned("strategy.refine")
@torch.no_grad()
def refine(
    gstate: GaussianState,
    adam: AdamState,
    sstate: DefaultStrategyState,
    eps1: torch.Tensor,  # [CAP, 3] split noise for the original slot
    eps2: torch.Tensor,  # [CAP, 3] split noise for the new twin
    scene_scale: float,
    cfg: DefaultStrategyConfig,
    step: int,
):
    """Grow (duplicate / split) then prune. Returns (gstate, adam, new
    strategy state, stats); the buffers are updated in place. ``stats``
    holds 0-d device tensors, as the JAX package counts them: the
    candidates to duplicate (``n_dup``) and to split (``n_split``), granted
    a slot or not, and the slots the prune test flags (``n_pruned``), dead
    ones included. The tracer counts what changed: ``strategy.grown``, the
    new gaussians, and ``strategy.pruned``, the alive ones pruned."""
    params, alive = gstate.params, gstate.alive
    cap = alive.shape[0]
    dev = alive.device

    grads = sstate.grad2d / torch.clamp(sstate.count, min=1.0)
    is_high = grads > cfg.grow_grad2d
    scale_max = torch.exp(params.scales).amax(-1)
    is_small = scale_max <= cfg.grow_scale3d * scene_scale
    is_dup = alive & is_high & is_small
    is_split = alive & is_high & ~is_small
    if cfg.refine_scale2d_stop_iter > 0:
        scale2d_on = step < cfg.refine_scale2d_stop_iter
        is_split = is_split | (alive & scale2d_on & (sstate.radii_max > cfg.grow_scale2d))
        is_dup = is_dup & ~is_split

    cand = is_dup | is_split
    dst, ok = _alloc_slots(alive, cand)

    rot = quat_to_rotmat(params.quats)
    sigma = torch.exp(params.scales)
    samp1 = params.means + torch.einsum("nij,nj->ni", rot, eps1 * sigma)
    samp2 = params.means + torch.einsum("nij,nj->ni", rot, eps2 * sigma)
    split_scales = params.scales - math.log(1.6)

    new_vals = {name: v.clone() for name, v in params.items()}
    new_vals["means"] = torch.where(is_split[:, None], samp2, params.means)
    new_vals["scales"] = torch.where(is_split[:, None], split_scales, params.scales)
    if cfg.revised_opacity:
        o = torch.sigmoid(params.opacities)
        rev = torch.clamp(1.0 - torch.sqrt(torch.clamp(1.0 - o, min=0.0)), 1e-7, 1 - 1e-7)
        new_vals["opacities"] = torch.where(
            is_dup, torch.log(rev) - torch.log1p(-rev), new_vals["opacities"]
        )

    src = torch.nonzero(ok).flatten()
    trace.count("strategy.grown", src.shape[0])
    d = dst[src]
    for name, buf in params.items():
        buf[d] = new_vals[name][src]
    params.means.copy_(torch.where(is_split[:, None], samp1, params.means))
    params.scales.copy_(torch.where(is_split[:, None], split_scales, params.scales))
    alive[d] = True

    for moments in (adam.mu, adam.nu):
        for _, m in moments.items():
            m[d] = 0.0
            m[is_split] = 0.0

    opa = torch.sigmoid(params.opacities)
    prune = opa < cfg.prune_opa
    is_too_big = scale_max > cfg.prune_scale3d * scene_scale
    if cfg.refine_scale2d_stop_iter > 0:
        is_too_big = is_too_big | (
            (step < cfg.refine_scale2d_stop_iter) & (sstate.radii_max > cfg.prune_scale2d)
        )
    prune = prune | (is_too_big & (step > cfg.reset_every))
    if trace.enabled():
        trace.count_device("strategy.pruned", (alive & prune).sum())
    alive &= ~prune

    stats = dict(n_dup=is_dup.sum(), n_split=is_split.sum(), n_pruned=prune.sum())
    return gstate, adam, init_state(cap, dev), stats


@trace.spanned("strategy.reset_opacities")
@torch.no_grad()
def reset_opacities(gstate: GaussianState, adam: AdamState, cfg: DefaultStrategyConfig):
    """Clamp opacities to 2 * prune_opa (logit) and zero their moments."""
    value = math.log(2 * cfg.prune_opa / (1 - 2 * cfg.prune_opa))
    gstate.params.opacities.clamp_(max=value)
    adam.mu.opacities.zero_()
    adam.nu.opacities.zero_()
    return gstate, adam
