"""World-space normalization — same math as the reference's normalize.py
(datasets/normalize.py:4-130): camera-up alignment + focus recentering +
median-distance rescale, then optional PCA principal-axes alignment.
All host-side numpy (runs once at parse time).
"""
from __future__ import annotations

import numpy as np


def similarity_from_cameras(c2w: np.ndarray, strict_scaling: bool = False):
    """Similarity transform aligning average camera up with +z and centering
    the camera focus point. c2w: [N, 4, 4]. Returns T [4, 4] (with scale)."""
    t = c2w[:, :3, 3]
    r = c2w[:, :3, :3]

    # (1) rotate up vector (-y of camera frame) to world +z
    ups = -r[:, :3, 1]
    world_up = np.mean(ups, axis=0)
    world_up /= np.linalg.norm(world_up)
    up_camspace = np.array([0.0, 0.0, 1.0])
    c = (world_up * up_camspace).sum()
    cross = np.cross(world_up, up_camspace)
    skew = np.array(
        [
            [0.0, -cross[2], cross[1]],
            [cross[2], 0.0, -cross[0]],
            [-cross[1], cross[0], 0.0],
        ]
    )
    if c > -1:
        r_align = np.eye(3) + skew + (skew @ skew) * 1 / (1 + c)
    else:
        r_align = np.array([[-1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, -1.0]])

    r = r_align @ r
    fwds = np.sum(r * np.array([0.0, 0.0, 1.0]), axis=-1)
    t = (r_align @ t[..., None])[..., 0]

    # (2) recenter: nearest point to all camera rays (median of per-camera
    # closest approach to the z axis)
    nearest = t + (fwds * -t).sum(-1)[:, None] * fwds
    translate = -np.median(nearest, axis=0)
    transform = np.eye(4)
    transform[:3, 3] = translate
    transform[:3, :3] = r_align

    # (3) rescale by camera distance
    scale_fn = np.max if strict_scaling else np.median
    scale = 1.0 / scale_fn(np.linalg.norm(t + translate, axis=-1))
    transform[:3, :] *= scale
    return transform


def align_principal_axes(points: np.ndarray) -> np.ndarray:
    """Rotation aligning the point cloud's principal axes with xyz, keeping
    a right-handed frame with +z up (largest-eigenvalue axis last)."""
    centroid = np.median(points, axis=0)
    centered = points - centroid
    cov = centered.T @ centered / len(centered)
    eigvals, eigvecs = np.linalg.eigh(cov)
    # eigh returns ascending; we want major axes first => reverse.
    order = eigvals.argsort()[::-1]
    eigvecs = eigvecs[:, order]
    if np.linalg.det(eigvecs) < 0:
        eigvecs[:, 0] *= -1
    rot = eigvecs.T
    transform = np.eye(4)
    transform[:3, :3] = rot
    transform[:3, 3] = -rot @ centroid
    return transform


def transform_points(matrix: np.ndarray, points: np.ndarray) -> np.ndarray:
    return points @ matrix[:3, :3].T + matrix[:3, 3]


def transform_cameras(matrix: np.ndarray, c2w: np.ndarray):
    """Apply a (possibly scaled) similarity to camera-to-world matrices.
    Returns (new_c2w, scene_scale_factor)."""
    out = matrix @ c2w
    # Remove scale from the rotation block, push it into translation.
    scaling = np.linalg.norm(out[:, :3, 0], axis=-1)
    out[:, :3, :3] = out[:, :3, :3] / scaling[:, None, None]
    return out
