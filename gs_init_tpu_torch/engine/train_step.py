"""One training step — port of ``gs_init_tpu/engine/train_step.py`` for the
default path.

Forward (projection, SH colours, binning, tile compositor), loss
(1 - lambda) L1 + lambda (1 - SSIM) plus the optional sparse disparity loss
and opacity / scale regularisers, backward through the compositor's CUDA
kernel, Adam in place, and the densification statistics from the
``means2d_dummy`` gradients (or the absgrad tap). PyTorch runs eagerly, so
``make_train_step`` only closes over the configuration; the step reads
``cfg.pair_capacity`` on every call, which lets the Runner grow it. The
step's first call on a CUDA device runs the scan probe kernel once
(``ops.rasterize.check_scan``), where the JAX step resolves ``_scan_mode``.

Pose optimisation, appearance embeddings and the bilateral grid raise
NotImplementedError (a later slice of the port).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..ops.rasterize import check_scan
from ..ops.render import rasterize
from ..ops.sh import num_sh_bases
from ..ops.ssim import ssim
from .optim import AdamConfig, AdamState, adam_update
from .params import PARAM_NAMES, GaussianParams, GaussianState
from .strategy import default as default_strategy


@dataclass
class Batch:
    camtoworlds: torch.Tensor  # [B, 4, 4]
    Ks: torch.Tensor  # [B, 3, 3]
    pixels: torch.Tensor  # [B, H, W, 3] float in [0, 1]
    image_ids: torch.Tensor  # [B] int
    depth_points: Optional[torch.Tensor] = None  # [B, M, 2] pixel coords
    depth_values: Optional[torch.Tensor] = None  # [B, M] SfM depths (0 = pad)
    sampling_mask: Optional[torch.Tensor] = None  # [B, H, W, 1] float


def sh_coeff_mask(step: int, sh_degree: int, interval: int, device=None) -> torch.Tensor:
    """[K-1] mask of active shN coefficients (+1 degree per interval)."""
    n_active = (min(step // interval, sh_degree) + 1) ** 2
    idx = torch.arange(1, num_sh_bases(sh_degree), device=device)
    return (idx < n_active).float()


def make_train_step(cfg, acfg: AdamConfig, width: int, height: int):
    """Build ``train_step(gstate, adam, sstate, batch, step, bkgd=None,
    mark=None) -> (gstate, adam, sstate, metrics)``.

    ``bkgd`` [B, 3] is the random background when ``cfg.random_bkgd`` (the
    caller draws it). ``mark(name)``, when given, is called at each phase
    boundary (``chip_smoke.py`` records CUDA events there). The gaussian
    buffers, Adam moments and strategy statistics update in place. Metrics
    stay on the device (no host sync)."""
    if cfg.pose_opt or cfg.app_opt or cfg.use_bilateral_grid:
        raise NotImplementedError(
            "pose / appearance / bilateral-grid optimisation is not ported to "
            "gs_init_tpu_torch yet (the MCMC/aux slice in ROADMAP.md)"
        )
    use_absgrad = bool(getattr(cfg.strategy, "absgrad", False))
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
    scan_checked = False

    def train_step(
        gstate: GaussianState,
        adam: AdamState,
        sstate,
        batch: Batch,
        step: int,
        bkgd: Optional[torch.Tensor] = None,
        mark: Optional[Callable[[str], None]] = None,
    ):
        nonlocal scan_checked
        mark = mark or (lambda name: None)
        p = gstate.params
        alive = gstate.alive
        dev = p.means.device
        if dev.type == "cuda" and not scan_checked:
            # The JAX step resolves its scan lowering (_scan_mode) when it
            # is first traced; the port checks its scan kernel here.
            check_scan(dev)
            scan_checked = True
        c = batch.pixels.shape[0]
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        lp = GaussianParams(**leaves)
        dummy = torch.zeros((c, p.capacity, 2), device=dev, requires_grad=True)
        pair_dummy = (
            torch.zeros((c * p.capacity, 2), device=dev, requires_grad=True)
            if use_absgrad
            else None
        )

        scales, opacities = lp.activated()
        viewmats = torch.linalg.inv(batch.camtoworlds)
        if cfg.random_bkgd:
            if bkgd is None:
                raise ValueError("cfg.random_bkgd needs the random background bkgd [B, 3]")
        elif cfg.background_color is not None:
            bkgd = torch.tensor(cfg.background_color, dtype=torch.float32, device=dev)
            bkgd = bkgd[None].repeat(c, 1)
        else:
            bkgd = None
        sh_mask = torch.cat(
            [
                torch.ones((1,), device=dev),
                sh_coeff_mask(step, cfg.sh_degree, cfg.sh_degree_interval, dev),
            ]
        )
        mark("setup")
        render, alpha, info = rasterize(
            lp.means, lp.quats, scales, opacities, lp.sh_coeffs(), viewmats,
            batch.Ks, width, height,
            sh_degree=cfg.sh_degree, sh_mask=sh_mask, backgrounds=bkgd,
            alive=alive, means2d_dummy=dummy, pair_dummy=pair_dummy,
            pair_capacity=cfg.pair_capacity, **rasterize_kw,
        )
        mark("render")
        rendered = render[..., :3]
        if batch.sampling_mask is not None:
            # Masked-out pixels keep their values but pass no gradient.
            m = batch.sampling_mask.to(rendered.dtype)
            rendered = rendered * m + rendered.detach() * (1 - m)
            alpha = alpha * m + alpha.detach() * (1 - m)
        pixels = batch.pixels
        l1 = torch.mean(torch.abs(rendered - pixels))
        ssim_val = ssim(rendered, pixels)
        loss = (1.0 - cfg.ssim_lambda) * l1 + cfg.ssim_lambda * (1.0 - ssim_val)
        if cfg.depth_loss and batch.depth_points is not None:
            depth = render[..., 3]
            pts = batch.depth_points.long()
            b_idx = torch.arange(depth.shape[0], device=dev)[:, None]
            sampled = depth[b_idx, pts[..., 1], pts[..., 0]]
            valid = batch.depth_values > 0
            disp = torch.where(valid, 1.0 / torch.clamp(sampled, min=1e-6), 0.0)
            disp_gt = torch.where(valid, 1.0 / torch.clamp(batch.depth_values, min=1e-6), 0.0)
            nvalid = torch.clamp(valid.sum(), min=1)
            loss = loss + cfg.depth_lambda * (torch.abs(disp - disp_gt).sum() / nvalid)
        if cfg.opacity_reg > 0.0:
            loss = loss + cfg.opacity_reg * torch.mean(
                torch.where(alive, torch.abs(opacities), 0.0)
            )
        if cfg.scale_reg > 0.0:
            loss = loss + cfg.scale_reg * torch.mean(
                torch.where(alive[:, None], torch.abs(scales), 0.0)
            )
        mark("loss")

        inputs = [leaves[k] for k in PARAM_NAMES] + [dummy]
        if pair_dummy is not None:
            inputs.append(pair_dummy)
        grads = torch.autograd.grad(loss, inputs)
        mark("backward")
        adam = adam_update(
            p, GaussianParams(**dict(zip(PARAM_NAMES, grads[:6]))), adam, acfg, step
        )
        mark("adam")
        stats_grads = grads[7].reshape(c, -1, 2) if use_absgrad else grads[6]
        sstate = default_strategy.update_state(sstate, stats_grads, info.radii, width, height)
        mark("stats")
        metrics = dict(
            loss=loss.detach(),
            l1=l1.detach(),
            ssim=ssim_val.detach(),
            overflow=info.overflow,
            alpha_mean=alpha.detach().mean(),
            pairs=info.binning.tile_starts[-1],
        )
        return gstate, adam, sstate, metrics

    return train_step
