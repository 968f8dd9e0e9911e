"""RANSAC / MSAC scale and shift alignment, every hypothesis in one batch —
port of ``gs_init_tpu/mdi/alignment/ransac.py``.

All ``num_hyp`` hypotheses are fitted and scored as one [HYP, M] pass, then
three locally optimised refits (least squares on the inlier set) start from
the best one. Loss semantics are the reference's:
  dists = (s pred + t - gt)^2
  RANSAC loss = #(dists >= thresh); MSAC loss = sum(min(dists, thresh)).
Hypotheses and refits with s <= 0 are rejected: a monocular depth is
positively correlated with true depth, so a non-positive scale is always a
degenerate fit. If every hypothesis is rejected, the median ratio gives the
scale (shift 0).

The hypotheses' sample indices [HYP, S] may be passed in (the tests rebuild
the JAX package's draws); otherwise they are drawn with a
``torch.Generator``, uniformly among the valid entries with replacement,
which is what ``jax.random.categorical`` over 0/-inf logits does. Nothing
here waits for the device.
"""
from __future__ import annotations

from typing import Optional

import torch

from .lstsqrs import weighted_scale_shift


def sample_hypotheses(
    valid: torch.Tensor, num_hyp: int, sample_size: int, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """[num_hyp, sample_size] indices drawn uniformly among the valid
    entries, with replacement (index 0 when there are none)."""
    counts = torch.cumsum(valid.to(torch.int64), 0)
    n_valid = counts[-1]
    u = torch.rand((num_hyp, sample_size), generator=generator, device=valid.device)
    # The k-th valid entry (k from 0) is the first index whose count is k + 1.
    k = torch.minimum((u * n_valid).to(torch.int64), (n_valid - 1).clamp(min=0))
    idx = torch.searchsorted(counts, k + 1)
    return torch.where(n_valid > 0, idx, torch.zeros_like(idx))


def _masked_median(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The lower median over the valid entries."""
    n = valid.sum()
    s = torch.sort(torch.where(valid, x, torch.full_like(x, float("inf")))).values
    return s[(n - 1).clamp(min=0) // 2]


def _loss(d2: torch.Tensor, valid: torch.Tensor, inlier_threshold: float, msac: bool) -> torch.Tensor:
    if msac:
        return torch.clamp(d2, max=inlier_threshold).sum(-1)
    return (valid & (d2 >= inlier_threshold)).sum(-1).float()


def ransac_scale_shift(
    pred: torch.Tensor,  # [M] predicted depths at correspondences (padded)
    gt: torch.Tensor,  # [M] SfM depths
    valid: torch.Tensor,  # [M] bool (padding = False)
    idx: Optional[torch.Tensor] = None,  # [num_hyp, sample_size] sample indices
    generator: Optional[torch.Generator] = None,  # draws idx when it is None
    inlier_threshold: float = 0.01,
    num_hyp: int = 2500,
    sample_size: int = 4,
    msac: bool = False,
    lo_iters: int = 3,
):
    """Returns (s, t, inlier_mask [M]) as tensors."""
    if idx is None:
        idx = sample_hypotheses(valid, num_hyp, sample_size, generator)
    sp, sg = pred[idx], gt[idx]
    s_h, t_h = weighted_scale_shift(sp, sg, torch.ones_like(sp))  # [HYP]

    zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
    dists = (s_h[:, None] * pred[None, :] + t_h[:, None] - gt[None, :]) ** 2
    dists = torch.where(valid[None, :], dists, zero)  # padding never counts
    losses = _loss(dists, valid[None, :], inlier_threshold, msac)
    losses = torch.where(s_h > 0.0, losses, torch.full_like(losses, float("inf")))
    best = torch.argmin(losses)  # the first minimum, as jnp.argmin
    s, t, best_loss = s_h[best], t_h[best], losses[best]

    for _ in range(lo_iters):
        inl = valid & ((s * pred + t - gt) ** 2 < inlier_threshold)
        s2, t2 = weighted_scale_shift(pred, gt, inl.float())
        d2 = torch.where(valid, (s2 * pred + t2 - gt) ** 2, zero)
        l2 = _loss(d2, valid, inlier_threshold, msac)
        better = (l2 < best_loss) & (s2 > 0.0)
        # Accept-only: best_loss stays the loss of the (s, t) held, so a
        # rejected refit cannot tighten the bound against a later one.
        s, t, best_loss = (
            torch.where(better, s2, s), torch.where(better, t2, t), torch.where(better, l2, best_loss)
        )

    # Every hypothesis had s <= 0: the median ratio instead of an inverted fit.
    s_med = torch.clamp(
        _masked_median(gt, valid) / torch.clamp(_masked_median(pred, valid), min=1e-12), min=1e-12
    )
    fallback = s <= 0.0
    s = torch.where(fallback, s_med, s)
    t = torch.where(fallback, zero, t)
    inliers = valid & ((s * pred + t - gt) ** 2 < inlier_threshold)
    return s, t, inliers
