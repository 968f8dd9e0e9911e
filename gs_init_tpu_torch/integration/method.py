"""Benchmark-harness integration (a nerfbaselines-style Method) — port of
``gs_init_tpu/integration/method.py``.

A thin adapter around the port's Runner:

- ``get_info`` / ``setup_train`` / ``train_iteration`` / ``save`` /
  ``render``: the nerfbaselines Method protocol;
- ``config_overrides`` go through the CLI's dot-path setter (typed casts);
- a checkpoint restores the whole training state, the parser's
  normalisation transform included (it lives in the npz);
- ``export_demo``: a viewer-standard splat PLY in the dataset's original
  frame, with appearance colours baked in under ``app_opt``;
- ``optimize_embedding``: test-time fit of one appearance embedding (128
  Adam steps through the rasterizer's backward, ``torch.autograd``).

The Method runs on the card unless ``device="cpu"``. Registration with
nerfbaselines is gated on the package being importable.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import apply_overrides
from ..engine.appearance import appearance_colors
from ..engine.params import SH0_C, num_alive
from ..engine.runner import Runner
from ..ops.projection import view_directions
from ..ops.render import rasterize
from ..trainer import build_presets
from ..utils.ply import write_ply_splats


def _rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """One 3x3 rotation -> a wxyz quaternion (Shepperd's method)."""
    t = np.trace(R)
    if t > 0:
        r = np.sqrt(1.0 + t)
        return np.array([0.5 * r, (R[2, 1] - R[1, 2]) / (2 * r), (R[0, 2] - R[2, 0]) / (2 * r),
                         (R[1, 0] - R[0, 1]) / (2 * r)])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    r = np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k])
    q = np.zeros(4)
    q[1 + i] = 0.5 * r
    q[0] = (R[k, j] - R[j, k]) / (2 * r)
    q[1 + j] = (R[j, i] + R[i, j]) / (2 * r)
    q[1 + k] = (R[k, i] + R[i, k]) / (2 * r)
    return q


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product a*b; a [4] broadcast over b [N, 4] (wxyz)."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    return np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=1)


DATASET_PRESETS: Dict[str, Dict[str, str]] = {
    # Random init over a white background.
    "blender": {"init_type": "random", "background_color": "(1.0,1.0,1.0)"},
    "phototourism": {"app_opt": "true", "max_steps": "100000"},
}


class GsInitTpuMethod:
    """Train / eval adapter around the Runner with a stable external API."""

    def __init__(
        self,
        data_dir: Optional[str] = None,
        checkpoint: Optional[str] = None,
        preset: str = "default",
        config_overrides: Optional[Dict[str, str]] = None,
        dataset_kind: Optional[str] = None,
        device=None,
    ):
        cfg = build_presets()[preset]
        if dataset_kind and dataset_kind in DATASET_PRESETS:
            apply_overrides(cfg, DATASET_PRESETS[dataset_kind])
        if data_dir:
            cfg.data_dir = data_dir
        if config_overrides:
            apply_overrides(cfg, {k: str(v) for k, v in config_overrides.items()})
        cfg.adjust_steps()
        self.cfg = cfg
        self.runner = Runner(cfg, device=device)
        self.step = 0
        if checkpoint:
            self.step = self.runner.load(checkpoint)

    # ------------------------------------------------------------- protocol

    def get_info(self) -> Dict[str, Any]:
        return dict(
            name="gs-init-tpu",
            num_iterations=self.cfg.max_steps,
            loaded_step=self.step,
            num_gaussians=num_alive(self.runner.gstate),
            supported_camera_models=["pinhole", "ortho", "fisheye"],
        )

    def setup_train(self):
        self.runner.setup_train()
        return self

    def train_iteration(self, step: int) -> Dict[str, float]:
        metrics = self.runner.train_iteration(step)
        self.step = step
        return {k: float(v) for k, v in metrics.items()}

    def save(self, path: Optional[str] = None) -> str:
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        out = self.runner.save(self.step)
        if path and path != out:
            shutil.copy(out, path)
            out = path
        return out

    def render(self, camtoworld: np.ndarray, K: np.ndarray, width: int, height: int) -> Dict[str, np.ndarray]:
        color, alpha, depth = self.runner.render(camtoworld, K, width, height, render_mode="RGB+ED")
        return dict(color=color, accumulation=alpha, depth=depth)

    def export_demo(self, path: str, *, options: Optional[dict] = None) -> str:
        """A viewer-standard 3DGS splat .ply in the dataset's original
        (un-normalised) world frame. Under ``app_opt`` the appearance is
        baked into SH0 for one embedding (``options["embedding"]``, else
        image 0's) and one viewing direction (from
        ``options["camera_center"]``)."""
        options = options or {}
        runner, cfg = self.runner, self.cfg
        p = runner.gstate.params
        alive = runner.gstate.alive
        n = lambda x: x.detach()[alive].cpu().numpy()
        means, log_scales, opac_logit = n(p.means), n(p.scales), n(p.opacities)
        quats = n(p.quats)
        quats = quats / np.maximum(np.linalg.norm(quats, axis=-1, keepdims=True), 1e-12)

        app = runner.aux.app
        if cfg.app_opt and app is not None:
            logging.warning(
                "export_demo: baking appearance for a single embedding and viewing direction "
                "(no view-dependent demo with app_opt)"
            )
            dev = runner.device
            center = torch.as_tensor(np.asarray(options.get("camera_center", [1.0, 0.0, 0.0]), np.float32),
                                     device=dev)
            if options.get("embedding") is not None:
                app = dataclasses.replace(
                    app, embeds=torch.tensor(np.asarray(options["embedding"], np.float32), device=dev)[None]
                )
            app = dataclasses.replace(app, features=app.features[alive])
            means_t = p.means.detach()[alive]
            with torch.no_grad():
                resid = appearance_colors(app, torch.zeros(1, dtype=torch.long, device=dev),
                                          (means_t - center)[None], cfg.sh_degree, cfg.sh_degree)
                colors = torch.sigmoid(resid[0] + p.sh0.detach()[alive][:, 0, :])
            sh0 = ((colors.cpu().numpy() - 0.5) / SH0_C)[:, None, :]
            shN = np.zeros((means.shape[0], p.shN.shape[1], 3), np.float32)
        else:
            sh0, shN = n(p.sh0), n(p.shN)

        transform = getattr(runner.parser, "transform", None)
        if transform is not None:
            # Undo the world normalisation: x_orig = T^-1 x_norm (a similarity
            # of uniform scale s); log-scales shift by log(s), rotations
            # compose with R(T^-1).
            tinv = np.linalg.inv(np.asarray(transform, np.float64))
            M = tinv[:3, :3]
            s = float(np.cbrt(np.linalg.det(M)))
            means = (means @ M.T + tinv[:3, 3]).astype(np.float32)
            log_scales = (log_scales + np.log(s)).astype(np.float32)
            quats = _quat_mul(_rotmat_to_quat(M / s), quats).astype(np.float32)

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        write_ply_splats(path, means, log_scales, quats, opac_logit, sh0, shN)
        return path

    # -------------------------------------------------- test-time embedding

    def optimize_embedding(
        self,
        image: np.ndarray,  # [H, W, 3] float
        camtoworld: np.ndarray,
        K: np.ndarray,
        n_steps: Optional[int] = None,
        lr: Optional[float] = None,
    ) -> np.ndarray:
        """Fit a fresh appearance embedding to a held-out view by Adam
        (``cfg.app_test_opt_steps`` steps at ``cfg.app_test_opt_lr`` unless
        given) through the rasterizer's backward. Requires ``app_opt``."""
        if n_steps is None:
            n_steps = getattr(self.cfg, "app_test_opt_steps", 128)
        if lr is None:
            lr = getattr(self.cfg, "app_test_opt_lr", 0.1)
        runner, cfg = self.runner, self.cfg
        app = runner.aux.app
        if app is None:
            raise RuntimeError("optimize_embedding requires app_opt=true")
        dev = runner.device
        h, w = image.shape[:2]
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        params = runner.gstate.params.map(lambda x: x.detach())
        scales, opac = params.activated()
        viewmat = torch.linalg.inv(t(camtoworld))[None]
        Kt = t(K)[None]
        target = t(image)[None]
        dirs = view_directions(params.means, t(camtoworld)[None])
        image_ids = torch.zeros(1, dtype=torch.long, device=dev)

        embed = torch.zeros(app.embeds.shape[-1], device=dev)
        m = torch.zeros_like(embed)
        v = torch.zeros_like(embed)
        for i in range(n_steps):
            e = embed.clone().requires_grad_(True)
            resid = appearance_colors(dataclasses.replace(app, embeds=e[None]), image_ids, dirs,
                                      cfg.sh_degree, cfg.sh_degree)
            colors = torch.sigmoid(resid + params.sh0[None, :, 0, :])
            render, _, _ = rasterize(
                params.means, params.quats, scales, opac, colors, viewmat, Kt, w, h,
                alive=runner.gstate.alive, impl=cfg.rasterizer_impl, pair_capacity=cfg.pair_capacity,
            )
            (g,) = torch.autograd.grad(torch.mean((render - target) ** 2), e)
            with torch.no_grad():
                m = 0.9 * m + 0.1 * g
                v = 0.999 * v + 0.001 * g * g
                mh = m / (1 - 0.9 ** (i + 1))
                vh = v / (1 - 0.999 ** (i + 1))
                embed = embed - lr * mh / (torch.sqrt(vh) + 1e-8)
        return embed.cpu().numpy()


def register_with_nerfbaselines():  # pragma: no cover - optional dependency
    """Register the method spec when nerfbaselines is installed."""
    try:
        from nerfbaselines import register
    except ImportError:
        return False
    register({
        "id": "gs-init-tpu-torch",
        "method_class": f"{__name__}:GsInitTpuMethod",
        "conda": {"environment_name": "gs_init_tpu_torch", "python_version": "3.12"},
        "metadata": {
            "name": "gs-init-tpu-torch",
            "description": "3DGS with monocular depth init, PyTorch and CUDA",
        },
        "presets": DATASET_PRESETS,
    })
    return True
