"""Synthetic gaussian scene fixture — port of the default-path parts of
``gs_init_tpu/datasets/synthetic.py``.

Ground-truth gaussians rendered by the port's own ``rasterize`` (the tile
compositor, so the CUDA kernels on the card) become the training images; a
training run must be able to recover them. ``write_colmap_scene`` puts the
scene on disk as a COLMAP dataset so the whole data layer is exercised.
The surface-depth fixtures of the JAX version serve the mdi slice and
arrive with it.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.render import rasterize
from . import colmap_io as cio
from .png import write_png


class SyntheticScene(NamedTuple):
    points: np.ndarray  # [N, 3] gt gaussian means
    rgbs: np.ndarray  # [N, 3]
    images: np.ndarray  # [C, H, W, 3]
    camtoworlds: np.ndarray  # [C, 4, 4]
    Ks: np.ndarray  # [C, 3, 3]
    width: int
    height: int
    scene_scale: float
    depths: np.ndarray  # [C, H, W] expected depth
    alphas: np.ndarray  # [C, H, W]


def look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """OpenCV-convention camera-to-world (+z forward, +y down)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    return c2w


@torch.no_grad()
def render_views(
    means, quats, scales, opacities, rgbs, camtoworlds, Ks, width, height,
    device=None, tile_size: int = 16,
):
    """Render each view with the tile compositor; returns numpy
    (images [C,H,W,3] clipped to [0, 1], alphas [C,H,W], depths [C,H,W])."""
    dev = resolve_device(device)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    g = [t(x) for x in (means, quats, scales, opacities, rgbs)]
    images, alphas, depths = [], [], []
    for c2w, K in zip(camtoworlds, Ks):
        viewmat = torch.linalg.inv(t(c2w))[None]
        cap = 1 << 16
        while True:
            render, alpha, info = rasterize(
                *g, viewmat, t(K)[None], width, height, render_mode="RGB+ED",
                tile_size=tile_size, pair_capacity=cap,
            )
            if int(info.overflow) == 0:
                break
            cap *= 4
        images.append(render[0, ..., :3].clamp(0.0, 1.0).cpu().numpy())
        alphas.append(alpha[0, ..., 0].cpu().numpy())
        depths.append(render[0, ..., 3].cpu().numpy())
    return np.stack(images), np.stack(alphas), np.stack(depths)


def make_scene(
    seed: int = 0,
    n_gaussians: int = 96,
    n_cams: int = 12,
    width: int = 64,
    height: int = 48,
    radius: float = 3.0,
    device=None,
) -> SyntheticScene:
    """Random gaussians in a box seen by a ring of look-at cameras."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.8, 0.8, (n_gaussians, 3))
    rgbs = rng.uniform(0.1, 0.9, (n_gaussians, 3))
    quats = rng.normal(size=(n_gaussians, 4))
    scales = rng.uniform(0.04, 0.15, (n_gaussians, 3))
    opac = rng.uniform(0.5, 0.95, n_gaussians)
    c2ws = []
    for i in range(n_cams):
        a = 2 * np.pi * i / n_cams
        eye = np.array([radius * np.cos(a), 0.6 * np.sin(2 * a), radius * np.sin(a)])
        c2ws.append(look_at(eye, np.zeros(3)))
    c2ws = np.stack(c2ws)
    f = 0.9 * width
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float64)
    Ks = np.tile(K, (n_cams, 1, 1))
    images, alphas, depths = render_views(
        pts, quats, scales, opac, rgbs, c2ws, Ks, width, height, device=device
    )
    return SyntheticScene(
        points=pts.astype(np.float32),
        rgbs=rgbs.astype(np.float32),
        images=images,
        camtoworlds=c2ws.astype(np.float32),
        Ks=Ks.astype(np.float32),
        width=width,
        height=height,
        scene_scale=float(radius),
        depths=depths.astype(np.float32),
        alphas=alphas.astype(np.float32),
    )


def write_colmap_scene(out_dir: str, scene: SyntheticScene, n_points: int = 64) -> str:
    """Write the scene as a COLMAP dataset (images/ + sparse/0 binary model)
    whose SfM points are the first ``n_points`` gaussian means; returns the
    dataset directory."""
    data_dir = os.path.join(str(out_dir), "scene")
    img_dir = os.path.join(data_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    k0 = scene.Ks[0]
    cameras = {
        1: cio.ColmapCamera(
            1, "PINHOLE", scene.width, scene.height,
            np.array([k0[0, 0], k0[1, 1], k0[0, 2], k0[1, 2]], np.float64),
        )
    }
    pts = scene.points[:n_points].astype(np.float64)
    ids = np.arange(1, len(pts) + 1, dtype=np.int64)
    images = {}
    for i, c2w in enumerate(scene.camtoworlds):
        w2c = np.linalg.inv(c2w.astype(np.float64))
        name = f"img_{i:03d}.png"
        write_png(os.path.join(img_dir, name), (scene.images[i] * 255).astype(np.uint8))
        cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
        pix = (cam[:, :2] / cam[:, 2:3]) @ k0[:2, :2].T + k0[:2, 2]
        ok = (
            (cam[:, 2] > 0)
            & (pix[:, 0] >= 0)
            & (pix[:, 0] < scene.width)
            & (pix[:, 1] >= 0)
            & (pix[:, 1] < scene.height)
        )
        sel = np.where(ok)[0][:40]
        images[i + 1] = cio.ColmapImage(
            i + 1, cio.rotmat_to_qvec(w2c[:3, :3]), w2c[:3, 3], 1, name, pix[sel], ids[sel]
        )
    rec = cio.ColmapReconstruction(
        cameras=cameras,
        images=images,
        points_xyz=pts,
        points_rgb=(scene.rgbs[:n_points] * 255).astype(np.uint8),
        points_err=np.full(len(pts), 0.5),
        point_ids=ids,
    )
    cio.write_reconstruction_bin(os.path.join(data_dir, "sparse/0"), rec)
    return data_dir
