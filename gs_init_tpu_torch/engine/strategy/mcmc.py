"""MCMC densification strategy: relocation and stochastic position noise —
port of ``gs_init_tpu/engine/strategy/mcmc.py`` (3DGS as MCMC, Kheradmand
et al., arXiv 2404.09591).

Dead (near-transparent) gaussians move to samples of live ones drawn with
probability proportional to opacity, with the paper's opacity and scale
corrections (eq. 9) so the rendered distribution is kept; every step a
covariance-shaped noise term scaled by the means learning rate moves the
near-transparent ones. On the capacity buffers the receivers are the dead
slots plus a 5%-growth tranche of free slots (bounded by ``cap_max`` and
the capacity). The buffers update in place.

The randomness comes in as tensors, so a caller can hand over the JAX
package's draws: ``refine`` takes the [CAP] categorical draws,
``add_noise`` the [CAP, 3] normals. ``draw_targets`` and ``noise_eps``
draw them on the device with no host sync.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ...config import MCMCStrategyConfig
from ...ops.projection import quat_to_rotmat
from ..optim import AdamState
from ..params import GaussianState

_N_MAX = 51  # the binomial table bound of 3DGS-MCMC


def _log_binom(n: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return torch.lgamma(n + 1.0) - torch.lgamma(i + 1.0) - torch.lgamma(n - i + 1.0)


def relocation_params(opacity: torch.Tensor, n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """New (opacity, scale factor) when a gaussian is split into n samples.

    opacity: [K] post-sigmoid; n: [K] sample counts >= 1. Eq. 9 of
    3DGS-MCMC as an alternating binomial sum over i <= 51 in float32, as the
    JAX package computes it (it cancels badly for large n; kept, so results
    match the reference)."""
    n = torch.clamp(n.float(), 1.0, float(_N_MAX))
    new_o = 1.0 - torch.pow(1.0 - opacity, 1.0 / n)
    i = torch.arange(1, _N_MAX + 1, dtype=torch.float32, device=opacity.device)
    sign = torch.where(i % 2 == 1, 1.0, -1.0)
    log_terms = _log_binom(n[:, None], i[None, :]) + i[None, :] * torch.log(
        torch.clamp(new_o[:, None], min=1e-12)
    )
    terms = sign[None, :] / torch.sqrt(i)[None, :] * torch.exp(log_terms)
    terms = torch.where(i[None, :] <= n[:, None], terms, 0.0)
    denom = torch.sum(terms, dim=1)
    factor = opacity / torch.clamp(denom, min=1e-12)
    return new_o, factor


def live_mask(gstate: GaussianState, cfg: MCMCStrategyConfig):
    """(post-sigmoid opacities, dead mask, live mask)."""
    opa = torch.sigmoid(gstate.params.opacities)
    dead = gstate.alive & (opa < cfg.min_opacity)
    return opa, dead, gstate.alive & ~dead


def draw_targets(opa: torch.Tensor, live: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """[CAP] slots drawn with probability proportional to opacity among the
    live ones, on the device, no host sync. With no live gaussian every
    draw is slot 0, as JAX's categorical over all -inf logits gives."""
    cap = opa.shape[0]
    any_live = live.any()
    weights = torch.where(any_live, opa * live, torch.ones_like(opa))
    targets = torch.multinomial(weights, cap, replacement=True, generator=generator)
    return torch.where(any_live, targets, torch.zeros_like(targets))


def noise_eps(capacity: int, generator: torch.Generator) -> torch.Tensor:
    """The [CAP, 3] standard normals ``add_noise`` uses."""
    return torch.randn((capacity, 3), generator=generator, device=generator.device)


@torch.no_grad()
def refine(
    gstate: GaussianState,
    adam: AdamState,
    sstate,
    targets: torch.Tensor,  # [CAP] int: a live slot drawn for every slot
    cfg: MCMCStrategyConfig,
):
    """Relocate dead gaussians and add new ones (5% growth up to cap_max),
    in place. Returns (gstate, adam, sstate)."""
    params, alive = gstate.params, gstate.alive
    cap = alive.shape[0]
    opa, dead, live = live_mask(gstate, cfg)

    # Growth tranche: +5% of the current count, bounded by cap_max and capacity.
    n_alive = alive.sum(dtype=torch.int32)
    target_n = torch.clamp((n_alive.float() * 1.05).int(), max=min(cfg.cap_max, cap))
    free = ~alive
    add_rank = torch.cumsum(free.int(), 0) - 1
    add_mask = free & (add_rank < torch.clamp(target_n - n_alive, min=0))

    recv = dead | add_mask
    sent = torch.where(recv, targets, cap)  # cap: the sentinel of non-receivers
    extra = torch.zeros(cap + 1, dtype=torch.int32, device=alive.device)
    extra.scatter_add_(0, sent, torch.ones_like(sent, dtype=torch.int32))
    extra = extra[:cap]

    new_o, factor = relocation_params(opa, 1.0 + extra.float())
    touched = (extra > 0) & live
    # The targets' new opacity and scale first; the receivers then copy the
    # updated rows (receivers are never targets: they are dead or free).
    params.opacities.copy_(torch.where(
        touched,
        torch.log(torch.clamp(new_o, min=1e-9) / torch.clamp(1.0 - new_o, min=1e-9)),
        params.opacities,
    ))
    params.scales.copy_(torch.where(
        touched[:, None], params.scales + torch.log(torch.clamp(factor, min=1e-12))[:, None],
        params.scales,
    ))
    t = torch.clamp(targets, 0, cap - 1)
    for _, leaf in params.items():
        mask = recv.reshape((cap,) + (1,) * (leaf.dim() - 1))
        leaf.copy_(torch.where(mask, leaf[t], leaf))
    alive |= add_mask

    # Zero the Adam moments of every touched slot (receivers and split targets).
    zero = recv | touched
    for moments in (adam.mu, adam.nu):
        for _, m in moments.items():
            m.masked_fill_(zero.reshape((cap,) + (1,) * (m.dim() - 1)), 0.0)
    return gstate, adam, sstate


def relocate(gstate: GaussianState, adam: AdamState, sstate, generator: torch.Generator,
             cfg: MCMCStrategyConfig):
    """``refine`` with targets drawn by ``draw_targets`` (the Runner's call)."""
    opa, _, live = live_mask(gstate, cfg)
    return refine(gstate, adam, sstate, draw_targets(opa, live, generator), cfg)


@torch.no_grad()
def add_noise(gstate: GaussianState, eps: torch.Tensor, lr: float, cfg: MCMCStrategyConfig):
    """Covariance-shaped positional noise on near-transparent gaussians, in
    place: means += noise_lr * lr * sigmoid gate * R diag(s^2) R^T eps (the
    full covariance, not a Cholesky sample). Only alive slots move."""
    params, alive = gstate.params, gstate.alive
    opa = torch.sigmoid(params.opacities)
    gate = torch.sigmoid(-100.0 * (opa - 1.0 + 0.995))
    rot = quat_to_rotmat(params.quats)
    s2 = torch.exp(2.0 * params.scales)
    sample = torch.einsum("nij,nj->ni", rot, s2 * torch.einsum("nji,nj->ni", rot, eps))
    noise = cfg.noise_lr * lr * gate[:, None] * sample
    params.means.copy_(torch.where(alive[:, None], params.means + noise, params.means))
    return gstate
