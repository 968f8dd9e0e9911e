"""One training step — port of ``gs_init_tpu/engine/train_step.py``.

Forward (projection, SH colours, binning, tile compositor), loss
(1 - lambda) L1 + lambda (1 - SSIM) plus the optional sparse disparity loss
and opacity / scale regularisers, backward through the compositor's CUDA
kernel, Adam in place, and the densification statistics from the
``means2d_dummy`` gradients (or the absgrad tap; the MCMC strategy reads
none, so it keeps none). PyTorch runs eagerly, so ``make_train_step`` only
closes over the configuration; the step reads ``cfg.pair_capacity`` on
every call, which lets the Runner retune it. The step's first call on a
CUDA device runs the scan probe kernel once (``ops.rasterize.check_scan``),
where the JAX step resolves ``_scan_mode``. ``StepFrame`` is the setup
before the render and the updates after the backward, which the sharded
steps (``parallel/shard.py``) share.

Optional groups, each one more optimiser group (``AuxParams``):
- pose optimisation (``cfg.pose_opt``): per-image SE3 deltas on camtoworld;
- appearance optimisation (``cfg.app_opt``): embedding + feature MLP colours
  in place of SH (sh0 is the base colour logit);
- the bilateral grid (``cfg.use_bilateral_grid``): per-view colour affines
  on the render and a TV loss.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .. import trace
from ..config import MCMCStrategyConfig
from ..ops.projection import view_directions
from ..ops.rasterize import check_scan
from ..ops.render import rasterize
from ..ops.sh import num_sh_bases
from ..ops.ssim import ssim
from .appearance import appearance_colors, apply_pose_deltas, slice_bilateral_grid, total_variation_loss
from .optim import (
    AdamConfig,
    AdamState,
    SimpleAdamState,
    adam_update,
    simple_adam_init,
    simple_adam_update,
)
from .params import PARAM_NAMES, AuxParams, GaussianParams, GaussianState, aux_from_leaves, aux_leaves
from .strategy import default as default_strategy

# The step's phases: the boundary each ends at (the step's ``mark``) and
# its span, in order.
STEP_PHASES = {
    "setup": "train_step.setup",
    "render": "train_step.render",
    "loss": "train_step.loss",
    "backward": "train_step.backward",
    "adam": "optim.adam",
    "aux": "train_step.aux",
    "stats": "train_step.stats",
}


@dataclass
class Batch:
    camtoworlds: torch.Tensor  # [B, 4, 4]
    Ks: torch.Tensor  # [B, 3, 3]
    pixels: torch.Tensor  # [B, H, W, 3] float in [0, 1]
    image_ids: torch.Tensor  # [B] int
    depth_points: Optional[torch.Tensor] = None  # [B, M, 2] pixel coords
    depth_values: Optional[torch.Tensor] = None  # [B, M] SfM depths (0 = pad)
    sampling_mask: Optional[torch.Tensor] = None  # [B, H, W, 1] float


@dataclass
class AuxOptState:
    pose: Optional[SimpleAdamState] = None
    app: Optional[SimpleAdamState] = None
    grids: Optional[SimpleAdamState] = None


def init_aux_opt(aux: AuxParams) -> AuxOptState:
    init = lambda x: None if x is None else simple_adam_init(x)
    return AuxOptState(pose=init(aux.pose), app=init(aux.app), grids=init(aux.grids))


def sh_coeff_mask(step: int, sh_degree: int, interval: int, device=None) -> torch.Tensor:
    """[K-1] mask of active shN coefficients (+1 degree per interval)."""
    n_active = (min(step // interval, sh_degree) + 1) ** 2
    idx = torch.arange(1, num_sh_bases(sh_degree), device=device)
    return (idx < n_active).float()


def sh_basis_mask(cfg, step: int, device=None) -> torch.Tensor:
    """[K] mask of the SH bases that colour the render at ``step``."""
    return torch.cat([
        torch.ones((1,), device=device),
        sh_coeff_mask(step, cfg.sh_degree, cfg.sh_degree_interval, device),
    ])


def background(cfg, bkgd: Optional[torch.Tensor], c: int, device) -> Optional[torch.Tensor]:
    """The background [C, 3] of ``c`` cameras: the caller's random draw
    ``bkgd`` (``cfg.random_bkgd``), the configured colour, or None."""
    if cfg.random_bkgd:
        if bkgd is None:
            raise ValueError("cfg.random_bkgd needs the random background bkgd [B, 3]")
        return bkgd
    if cfg.background_color is not None:
        return torch.tensor(cfg.background_color, dtype=torch.float32, device=device)[None].repeat(c, 1)
    return None


def image_loss(cfg, la: AuxParams, batch: Batch, rendered, alpha, depth, depth_count=None):
    """The loss of a render, regularisers aside: the sampling mask
    (masked-out pixels keep their values but pass no gradient), the
    bilateral grid, (1 - lambda) L1 + lambda (1 - SSIM), the sparse
    disparity loss and the grids' TV loss. ``rendered`` [B, H, W, 3] has
    its background, ``alpha`` is [B, H, W, 1], ``depth`` [B, H, W] the
    expected depth (read with ``cfg.depth_loss``). The disparity loss is
    its sum over ``depth_count(valid)``, by default the batch's count of
    valid points (at least 1). Returns (loss, l1, ssim, masked alpha)."""
    if batch.sampling_mask is not None:
        m = batch.sampling_mask.to(rendered.dtype)
        rendered = rendered * m + rendered.detach() * (1 - m)
        alpha = alpha * m + alpha.detach() * (1 - m)
    if cfg.use_bilateral_grid and la.grids is not None:
        rendered = slice_bilateral_grid(la.grids, rendered, batch.image_ids)
    pixels = batch.pixels
    l1 = torch.mean(torch.abs(rendered - pixels))
    ssim_val = ssim(rendered, pixels)
    loss = (1.0 - cfg.ssim_lambda) * l1 + cfg.ssim_lambda * (1.0 - ssim_val)
    if cfg.depth_loss and batch.depth_points is not None:
        pts = batch.depth_points.long()
        b_idx = torch.arange(depth.shape[0], device=depth.device)[:, None]
        sampled = depth[b_idx, pts[..., 1], pts[..., 0]]
        valid = batch.depth_values > 0
        disp = torch.where(valid, 1.0 / torch.clamp(sampled, min=1e-6), 0.0)
        disp_gt = torch.where(valid, 1.0 / torch.clamp(batch.depth_values, min=1e-6), 0.0)
        nvalid = torch.clamp(valid.sum(), min=1) if depth_count is None else depth_count(valid)
        loss = loss + cfg.depth_lambda * (torch.abs(disp - disp_gt).sum() / nvalid)
    if cfg.use_bilateral_grid and la.grids is not None:
        loss = loss + cfg.tv_lambda * total_variation_loss(la.grids)
    return loss, l1, ssim_val, alpha


def regulariser_loss(cfg, alive, opacities, scales, mean=torch.mean):
    """The opacity and scale regularisers: ``mean`` over the capacity of
    the alive gaussians' |opacity| and |scale| (the sharded steps pass a
    mean over every gaussian shard); 0.0 when both are off."""
    loss = 0.0
    if cfg.opacity_reg > 0.0:
        loss = loss + cfg.opacity_reg * mean(torch.where(alive, torch.abs(opacities), 0.0))
    if cfg.scale_reg > 0.0:
        loss = loss + cfg.scale_reg * mean(torch.where(alive[:, None], torch.abs(scales), 0.0))
    return loss


@dataclass
class Frame:
    """One step's inputs to its render, the leaves with gradients on
    (``StepFrame.setup``)."""

    lp: GaussianParams  # the gaussian leaves
    la: AuxParams  # the aux groups' leaves
    dummy: torch.Tensor  # [C, N, 2] zeros: the means2d tap
    pair_dummy: Optional[torch.Tensor]  # [C*M, 2] zeros: the absgrad tap, or None
    scales: torch.Tensor  # activated
    opacities: torch.Tensor  # activated
    viewmats: torch.Tensor  # [C, 4, 4] world->camera, the pose deltas applied
    bkgd: Optional[torch.Tensor]  # [C, 3]
    colors: torch.Tensor  # SH coefficients [N, K, 3] (with sh_degree) or colours [C, N, 3]
    sh_degree: Optional[int]
    sh_mask: Optional[torch.Tensor]  # [K] the SH schedule

    def gradients(self, loss, taps):
        """The gradients of ``loss``: (the gaussian leaves' in ``PARAM_NAMES``
        order, the ``taps``', the aux leaves'), zeros where a leaf takes none
        (shN when the appearance MLP replaces SH colours)."""
        inputs = [getattr(self.lp, k) for k in PARAM_NAMES] + taps + aux_leaves(self.la)
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
        n = len(PARAM_NAMES)
        return grads[:n], grads[n:n + len(taps)], grads[n + len(taps):]


class StepFrame:
    """What the one-card step and the sharded steps (``parallel/shard.py``)
    share around their renders: the setup (``setup``) and the updates after
    the backward (``update``). Each step function holds one."""

    def __init__(self, cfg, acfg: AdamConfig, width: int, height: int):
        self.cfg, self.acfg, self.width, self.height = cfg, acfg, width, height
        self.use_absgrad = bool(getattr(cfg.strategy, "absgrad", False))
        # MCMC relocation reads no screen-space statistics, so none are kept.
        self.track_stats = not isinstance(cfg.strategy, MCMCStrategyConfig)
        self.scan_checked = False

    def setup(self, gstate: GaussianState, aux: AuxParams, batch: Batch, step: int,
              bkgd: Optional[torch.Tensor], pair_tap: Optional[int], app_rows: Optional[slice] = None) -> Frame:
        """The leaves with gradients on, the activation, the cameras, the
        background and the colours' input. ``pair_tap``: the gaussians per
        camera of the absgrad tap (None for none); ``app_rows``: the rows
        of the appearance features that ``gstate`` holds (None for all)."""
        cfg = self.cfg
        p = gstate.params
        dev = p.means.device
        if dev.type == "cuda" and not self.scan_checked:
            # The JAX step resolves its scan lowering (_scan_mode) when it
            # is first traced; the port checks its scan kernel here.
            check_scan(dev)
            self.scan_checked = True
        c = batch.pixels.shape[0]
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        lp = GaussianParams(**leaves)
        aux_in = [x.detach().requires_grad_(True) for x in aux_leaves(aux)]
        la = aux_from_leaves(aux, aux_in)
        dummy = torch.zeros((c, p.capacity, 2), device=dev, requires_grad=True)
        pair_dummy = None if pair_tap is None else torch.zeros((c * pair_tap, 2), device=dev, requires_grad=True)

        scales, opacities = lp.activated()
        c2w = batch.camtoworlds
        if cfg.pose_opt and la.pose is not None:
            c2w = apply_pose_deltas(c2w, la.pose, batch.image_ids)
        viewmats = torch.linalg.inv(c2w)
        bkgd = background(cfg, bkgd, c, dev)
        if cfg.app_opt and la.app is not None:
            # The appearance MLP's embedding and feature residuals on the
            # base colour logit sh0.
            app = la.app if app_rows is None else dataclasses.replace(la.app, features=la.app.features[app_rows])
            active_deg = min(step // cfg.sh_degree_interval, cfg.sh_degree)
            dirs = view_directions(lp.means, c2w)
            resid = appearance_colors(app, batch.image_ids, dirs, active_deg, cfg.sh_degree)
            colors = torch.sigmoid(resid + lp.sh0[None, :, 0, :])
            sh_degree, sh_mask = None, None
        else:
            colors = lp.sh_coeffs()
            sh_degree = cfg.sh_degree
            sh_mask = sh_basis_mask(cfg, step, dev)
        return Frame(lp, la, dummy, pair_dummy, scales, opacities, viewmats, bkgd, colors, sh_degree, sh_mask)

    def update(self, p: GaussianParams, grads, adam: AdamState, aux: AuxParams, aux_opt: AuxOptState,
               agrads, sstate, stats, radii, step: int, mark):
        """Adam on the gaussians (``grads`` in ``PARAM_NAMES`` order) and on
        the enabled aux groups (``agrads`` in ``aux_leaves`` order: the pose
        deltas at the means' decayed rate, the appearance MLP, the bilateral
        grid at 2e-3), and the densification statistics from ``stats``
        [C, N, 2] and ``radii`` [C, N] (when kept), in place, each phase
        ended by its ``mark``. Returns (adam, aux_opt, sstate)."""
        cfg = self.cfg
        agrads = aux_from_leaves(aux, agrads)
        adam = adam_update(p, GaussianParams(**dict(zip(PARAM_NAMES, grads))), adam, self.acfg, step)
        mark("adam")
        decay = np.float32(self.acfg.means_decay_gamma) ** np.float32(step)
        if aux.pose is not None:
            aux_opt.pose = simple_adam_update(aux.pose, agrads.pose, aux_opt.pose,
                                              lr=np.float32(cfg.pose_opt_lr) * decay, weight_decay=cfg.pose_opt_reg)
        if aux.app is not None:
            aux_opt.app = simple_adam_update(aux.app, agrads.app, aux_opt.app, lr=cfg.app_opt_lr,
                                             weight_decay=cfg.app_opt_reg)
        if aux.grids is not None:
            aux_opt.grids = simple_adam_update(aux.grids, agrads.grids, aux_opt.grids, lr=2e-3)
        mark("aux")
        if self.track_stats:
            sstate = default_strategy.update_state(sstate, stats, radii, self.width, self.height)
        mark("stats")
        return adam, aux_opt, sstate


def make_train_step(cfg, acfg: AdamConfig, width: int, height: int):
    """Build ``train_step(gstate, adam, sstate, aux, aux_opt, batch, step,
    bkgd=None, mark=None) -> (gstate, adam, sstate, aux, aux_opt, metrics)``.

    ``aux`` holds the enabled optional groups (``AuxParams()`` for none) and
    ``aux_opt`` their Adam states (``init_aux_opt(aux)``). ``bkgd`` [B, 3]
    is the random background when ``cfg.random_bkgd`` (the caller draws
    it). ``mark(name)``, when given, is called at each phase boundary
    (``chip_smoke.py`` records CUDA events there); with the tracer on, each
    phase is a span (``STEP_PHASES``) and the whole call is ``train_step``.
    The gaussian buffers, the aux groups, their Adam moments and the
    strategy statistics update in place. Metrics stay on the device (no
    host sync)."""
    frame = StepFrame(cfg, acfg, width, height)
    rasterize_kw = dict(
        near_plane=cfg.near_plane,
        far_plane=cfg.far_plane,
        rasterize_mode="antialiased" if cfg.antialiased else "classic",
        camera_model=cfg.camera_model,
        tile_size=cfg.tile_size,
        chunk_size=cfg.chunk_size,
        impl=cfg.rasterizer_impl,
        render_mode="RGB+ED" if cfg.depth_loss else "RGB",
    )

    @trace.spanned("train_step")
    def train_step(
        gstate: GaussianState,
        adam: AdamState,
        sstate,
        aux: AuxParams,
        aux_opt: AuxOptState,
        batch: Batch,
        step: int,
        bkgd: Optional[torch.Tensor] = None,
        mark: Optional[Callable[[str], None]] = None,
    ):
        mark = trace.phases(STEP_PHASES, mark)
        p = gstate.params
        alive = gstate.alive
        f = frame.setup(gstate, aux, batch, step, bkgd, p.capacity if frame.use_absgrad else None)
        mark("setup")
        render, alpha, info = rasterize(
            f.lp.means, f.lp.quats, f.scales, f.opacities, f.colors, f.viewmats,
            batch.Ks, width, height,
            sh_degree=f.sh_degree, sh_mask=f.sh_mask, backgrounds=f.bkgd,
            alive=alive, means2d_dummy=f.dummy, pair_dummy=f.pair_dummy,
            pair_capacity=cfg.pair_capacity, **rasterize_kw,
        )
        mark("render")
        loss, l1, ssim_val, alpha = image_loss(
            cfg, f.la, batch, render[..., :3], alpha, render[..., 3] if cfg.depth_loss else None
        )
        loss = loss + regulariser_loss(cfg, alive, f.opacities, f.scales)
        mark("loss")

        # Per-pair absolute gradients come from the compositor's absgrad
        # tap; the dense oracle (impl="xla") has none, and the statistics
        # fall back to the screen-space gradients, as in the JAX package.
        absgrad = f.pair_dummy is not None and info.binning is not None
        grads, taps, agrads = f.gradients(loss, [f.dummy] + ([f.pair_dummy] if absgrad else []))
        mark("backward")
        stats = taps[1].reshape(batch.pixels.shape[0], -1, 2) if absgrad else taps[0]
        adam, aux_opt, sstate = frame.update(
            p, grads, adam, aux, aux_opt, agrads, sstate, stats, info.radii, step, mark
        )
        metrics = dict(
            loss=loss.detach(),
            l1=l1.detach(),
            ssim=ssim_val.detach(),
            overflow=info.overflow,
            alpha_mean=alpha.detach().mean(),
            pairs=(
                info.binning.tile_starts[-1] if info.binning is not None
                else torch.zeros((), dtype=torch.int32, device=p.means.device)
            ),
        )
        return gstate, adam, sstate, aux, aux_opt, metrics

    return train_step
