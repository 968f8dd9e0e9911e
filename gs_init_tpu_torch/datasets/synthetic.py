"""Synthetic gaussian scene fixture — port of
``gs_init_tpu/datasets/synthetic.py``.

Ground-truth gaussians rendered by the port become the training images; a
training run must be able to recover them. ``make_scene`` renders with the
tile compositor (the CUDA kernels on the card). ``make_clustered_scene``
renders with the dense oracle (``ops/rasterize_ref.py``), as the JAX
version does, and adds the surface depth that a monocular depth network
would predict (``render_surface_depth``). ``write_colmap_scene`` puts a
scene on disk as a COLMAP dataset so the whole data layer is exercised.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.projection import project_gaussians
from ..ops.rasterize_ref import alpha_at, depth_order, padded_pixel_chunks, rasterize_reference
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
    # Depth of the dominant (largest compositing weight) gaussian per pixel:
    # the visible surface a monocular depth network predicts. The expected
    # depth blends a foreground gaussian with what lies behind it, which
    # corrupts depth-to-SfM correspondences; depth oracles use this field.
    surface_depths: Optional[np.ndarray] = None  # [C, H, W]


@torch.no_grad()
def render_surface_depth(proj, width: int, height: int) -> np.ndarray:
    """Per-pixel depth of the gaussian with the largest compositing weight,
    [C, H, W] (0 where nothing covers the pixel)."""
    npix = width * height
    chunks = padded_pixel_chunks(width, height, min(2048, npix), proj.means2d.device)
    out = []
    for ci in range(proj.means2d.shape[0]):
        valid = proj.radii[ci] > 0
        order = depth_order(proj.depths[ci], valid)
        means2d, conics = proj.means2d[ci][order], proj.conics[ci][order]
        opac, depths = proj.opacities[ci][order], proj.depths[ci][order]
        rows = []
        for pix in chunks:
            alpha = alpha_at(means2d, conics, opac, valid[order], pix)
            log1m = torch.log1p(-alpha)
            w = alpha * torch.exp(torch.cumsum(log1m, dim=0) - log1m)
            rows.append(depths[torch.argmax(w, dim=0)])
        out.append(torch.cat(rows)[:npix].reshape(height, width))
    return torch.stack(out).cpu().numpy()


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
    (images [C,H,W,3] clipped to [0, 1], alphas [C,H,W], depths [C,H,W],
    the expected depth). The pair table carries over from view to view and
    a view that overflows it is rendered again with a table of at least
    its demand, so a scene of millions of gaussians re-renders a few views,
    not every one."""
    dev = resolve_device(device)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    g = [t(x) for x in (means, quats, scales, opacities, rgbs)]
    images, alphas, depths = [], [], []
    cap = 1 << 16
    for c2w, K in zip(camtoworlds, Ks):
        viewmat = torch.linalg.inv(t(c2w))[None]
        while True:
            render, alpha, info = rasterize(
                *g, viewmat, t(K)[None], width, height, render_mode="RGB+ED",
                tile_size=tile_size, pair_capacity=cap,
            )
            overflow = int(info.overflow)
            if overflow == 0:
                break
            demand = int(info.binning.tile_starts[-1]) + overflow
            cap = max(4 * cap, 1 << (demand - 1).bit_length())
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


def make_clustered_scene(
    seed: int = 0,
    n_fg: int = 900,
    n_bg: int = 2600,
    n_cams: int = 28,
    width: int = 480,
    height: int = 360,
    radius: float = 3.0,
    device=None,
) -> SyntheticScene:
    """A scene whose SfM coverage is clustered, the case monocular-depth
    init exists for: a compact textured foreground ball (the first ``n_fg``
    points; write them as the SfM points with ``n_points <= n_fg``) inside
    a wall-and-ground background of larger gaussians that every camera sees
    behind it and that has no SfM points. Rendered with the dense oracle."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    fg = rng.normal(0, 0.35, (n_fg, 3))
    fg_rgb = rng.uniform(0.05, 0.95, (n_fg, 3))
    fg_scales = rng.uniform(0.02, 0.07, (n_fg, 3))
    n_wall = int(n_bg * 0.7)
    ang = rng.uniform(0, 2 * np.pi, n_wall)
    r_wall = rng.uniform(5.5, 7.0, n_wall)
    wall = np.stack(
        [r_wall * np.cos(ang), rng.uniform(-2.2, 2.2, n_wall), r_wall * np.sin(ang)], axis=-1
    )
    n_gnd = n_bg - n_wall
    gr = np.sqrt(rng.uniform(0.15, 1.0, n_gnd)) * 6.5
    ga = rng.uniform(0, 2 * np.pi, n_gnd)
    ground = np.stack(
        [gr * np.cos(ga), np.full(n_gnd, 2.3) + rng.normal(0, 0.05, n_gnd), gr * np.sin(ga)],
        axis=-1,
    )
    bg = np.concatenate([wall, ground])
    bg_rgb = rng.uniform(0.1, 0.9, (n_bg, 3))
    bg_scales = rng.uniform(0.12, 0.35, (n_bg, 3))

    pts = np.concatenate([fg, bg])
    rgbs = np.concatenate([fg_rgb, bg_rgb])
    scales = np.concatenate([fg_scales, bg_scales])
    n = n_fg + n_bg
    quats = rng.normal(size=(n, 4))
    opac = rng.uniform(0.55, 0.95, n)

    c2ws = []
    for i in range(n_cams):
        a = 2 * np.pi * i / n_cams
        eye = np.array([radius * np.cos(a), -0.4 + 0.5 * np.sin(2 * a), radius * np.sin(a)])
        c2ws.append(look_at(eye, np.zeros(3)))
    c2ws = np.stack(c2ws)
    f = 0.85 * width
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float64)
    Ks = np.tile(K, (n_cams, 1, 1))

    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    with torch.no_grad():
        proj = project_gaussians(
            t(pts), t(quats), t(scales), t(opac), t(np.linalg.inv(c2ws)), t(Ks), width, height
        )
        colors = t(rgbs)[None].expand(n_cams, n, 3)
        images, alphas, depth_acc = rasterize_reference(proj, colors, width, height)
        images = images.clamp(0.0, 1.0).cpu().numpy()
        alphas = alphas.cpu().numpy()
        depths = depth_acc.cpu().numpy() / np.maximum(alphas, 1e-8)
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
        surface_depths=render_surface_depth(proj, width, height).astype(np.float32),
    )


def write_colmap_scene(out_dir: str, scene: SyntheticScene, n_points: int = 64) -> str:
    """Write the scene as a COLMAP dataset (images/ + sparse/0 binary model)
    whose SfM points are the first ``n_points`` gaussian means; returns the
    dataset directory. With ``scene.surface_depths`` an image observes only
    the points it sees (within 5% of the surface depth at their pixel), as
    real SfM registers only visible features."""
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
        if scene.surface_depths is not None:
            xi = np.clip(pix[:, 0].astype(np.int64), 0, scene.width - 1)
            yi = np.clip(pix[:, 1].astype(np.int64), 0, scene.height - 1)
            surf = scene.surface_depths[i][yi, xi]
            ok = ok & (np.abs(cam[:, 2] - surf) < 0.05 * np.maximum(surf, 1e-6))
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
