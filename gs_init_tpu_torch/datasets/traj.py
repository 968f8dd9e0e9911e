"""Camera trajectories for trajectory renders — the port's own copy of
``gs_init_tpu/datasets/traj.py`` (numpy and scipy).

A smooth spline through the training cameras, ellipse paths (z-up and
y-up) and a spiral; consumed by ``Runner.render_traj``.
"""
from __future__ import annotations

import numpy as np

from .synthetic import look_at


def generate_interpolated_path(
    camtoworlds: np.ndarray, n_interp: int = 6, spline_degree: int = 5
) -> np.ndarray:
    """Smooth spline through camera positions + look-at targets. [M,4,4]."""
    from scipy.interpolate import splev, splprep

    pos = camtoworlds[:, :3, 3]
    fwd = camtoworlds[:, :3, 2]
    targets = pos + fwd  # one unit along the view direction
    n = len(camtoworlds)
    k = min(spline_degree, n - 1)
    u_fine = np.linspace(0, 1, n_interp * n)

    def fit(x):
        tck, _ = splprep(x.T, s=0.0, k=k)
        return np.stack(splev(u_fine, tck), axis=-1)

    pos_f = fit(pos)
    tgt_f = fit(targets)
    ups = -camtoworlds[:, :3, 1]
    up_mean = ups.mean(axis=0)
    return np.stack(
        [look_at(p, t, up=-up_mean) for p, t in zip(pos_f, tgt_f)]
    ).astype(np.float32)


def generate_ellipse_path_z(
    camtoworlds: np.ndarray, n_frames: int = 120, variation: float = 0.0,
    phase: float = 0.0,
) -> np.ndarray:
    """Elliptical path in the xy plane at median camera height (z-up)."""
    pos = camtoworlds[:, :3, 3]
    center = pos.mean(axis=0)
    rad = np.percentile(np.abs(pos[:, :2] - center[:2]), 90, axis=0)
    zvar = variation * np.std(pos[:, 2])
    t = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    z = np.median(pos[:, 2]) + zvar * np.sin(2 * t + phase * 2 * np.pi)
    eye = np.stack(
        [center[0] + rad[0] * np.cos(t), center[1] + rad[1] * np.sin(t), z], -1
    )
    target = np.array([center[0], center[1], np.median(pos[:, 2])])
    return np.stack([look_at(e, target, up=(0, 0, 1)) for e in eye]).astype(
        np.float32
    )


def generate_ellipse_path_y(
    camtoworlds: np.ndarray, n_frames: int = 120, variation: float = 0.0,
    phase: float = 0.0,
) -> np.ndarray:
    """Elliptical path in the xz plane (y-up scenes)."""
    pos = camtoworlds[:, :3, 3]
    center = pos.mean(axis=0)
    rad = np.percentile(np.abs(pos[:, [0, 2]] - center[[0, 2]]), 90, axis=0)
    yvar = variation * np.std(pos[:, 1])
    t = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    y = np.median(pos[:, 1]) + yvar * np.sin(2 * t + phase * 2 * np.pi)
    eye = np.stack(
        [center[0] + rad[0] * np.cos(t), y, center[2] + rad[1] * np.sin(t)], -1
    )
    target = np.array([center[0], np.median(pos[:, 1]), center[2]])
    return np.stack([look_at(e, target) for e in eye]).astype(np.float32)


def generate_spiral_path(
    camtoworlds: np.ndarray,
    n_frames: int = 120,
    n_rots: int = 2,
    zrate: float = 0.5,
    radius_frac: float = 0.4,
) -> np.ndarray:
    """Spiral around the mean camera pose (llff-style)."""
    pos = camtoworlds[:, :3, 3]
    center = pos.mean(axis=0)
    radius = radius_frac * np.median(np.linalg.norm(pos - center, axis=-1))
    fwd_mean = camtoworlds[:, :3, 2].mean(axis=0)
    target = center + fwd_mean
    t = np.linspace(0, 2 * np.pi * n_rots, n_frames)
    eye = center + radius * np.stack(
        [np.cos(t), np.sin(t), np.sin(t * zrate) * 0.5], -1
    )
    up_mean = (-camtoworlds[:, :3, 1]).mean(axis=0)
    return np.stack([look_at(e, target, up=-up_mean) for e in eye]).astype(
        np.float32
    )


def get_path(name: str, camtoworlds: np.ndarray, n_frames: int = 120):
    if name == "interp":
        return generate_interpolated_path(
            camtoworlds, n_interp=max(1, n_frames // max(len(camtoworlds), 1))
        )
    if name == "ellipse_z":
        return generate_ellipse_path_z(camtoworlds, n_frames)
    if name == "ellipse_y":
        return generate_ellipse_path_y(camtoworlds, n_frames)
    if name == "spiral":
        return generate_spiral_path(camtoworlds, n_frames)
    raise ValueError(f"unknown trajectory {name!r}")
