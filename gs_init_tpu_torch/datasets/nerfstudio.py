"""Nerfstudio-format dataset loader (transforms.json) — the port's own copy
of ``gs_init_tpu/datasets/nerfstudio.py`` (numpy only).

Parses a ``transforms.json`` (per-frame file_path and transform_matrix in
the OpenGL convention, shared or per-frame intrinsics), converts poses to
the OpenCV convention, takes SfM points from an adjacent COLMAP model when
there is one, and exposes the Parser surface. ``open_dataset`` picks this
loader or the COLMAP Parser by what the directory holds.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .colmap_io import read_reconstruction
from .normalize import (
    align_principal_axes,
    similarity_from_cameras,
    transform_cameras,
    transform_points,
)
from .parser import ParsedImage, Parser

# OpenGL (nerfstudio) -> OpenCV camera axes: flip y and z.
_GL2CV = np.diag([1.0, -1.0, -1.0, 1.0])


class NerfstudioParser(Parser):
    """Parser over a transforms.json scene (does NOT call Parser.__init__)."""

    def __init__(
        self,
        data_dir: str,
        factor: int = 1,
        normalize: bool = True,
        test_every: int = 8,
        transforms_name: str = "transforms.json",
    ):
        self.data_dir = data_dir
        self.factor = factor
        self.test_every = test_every

        with open(os.path.join(data_dir, transforms_name)) as f:
            meta = json.load(f)

        def intr(frame):
            g = lambda k, d=None: frame.get(k, meta.get(k, d))
            fx, fy = g("fl_x"), g("fl_y")
            cx, cy = g("cx"), g("cy")
            w, h = int(g("w")), int(g("h"))
            K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
            return K, w, h

        self.images = []
        c2ws = []
        for frame in sorted(meta["frames"], key=lambda fr: fr["file_path"]):
            rel = frame["file_path"]
            path = os.path.join(data_dir, rel)
            if not os.path.exists(path):
                continue
            K, w, h = intr(frame)
            c2w = np.asarray(frame["transform_matrix"], np.float64) @ _GL2CV
            if factor > 1:
                K = K.copy()
                K[:2] /= factor
                w, h = w // factor, h // factor
            c2ws.append(c2w)
            self.images.append(
                ParsedImage(
                    name=os.path.basename(rel),
                    path=path,
                    camtoworld=c2w,
                    K=K,
                    camera_id=0,
                    width=w,
                    height=h,
                )
            )
        if not self.images:
            raise FileNotFoundError(f"no frames found under {data_dir}")

        # SfM points: adjacent COLMAP model if present (ScanNet++ layout).
        self.points = np.zeros((0, 3), np.float32)
        self.points_rgb = np.zeros((0, 3), np.float32)
        self.points_err = np.zeros((0,), np.float32)
        self.point_indices = {}
        for cand in ["colmap/sparse/0", "colmap", "sparse/0", "sparse"]:
            p = os.path.join(data_dir, cand)
            if os.path.exists(os.path.join(p, "points3D.bin")) or os.path.exists(
                os.path.join(p, "points3D.txt")
            ):
                rec = read_reconstruction(p)
                self.points = rec.points_xyz.astype(np.float32)
                self.points_rgb = rec.points_rgb.astype(np.float32) / 255.0
                self.points_err = rec.points_err.astype(np.float32)
                id_to_idx = {int(pid): i for i, pid in enumerate(rec.point_ids)}
                for im in rec.images.values():
                    idx = np.array(
                        [
                            id_to_idx[int(q)]
                            for q in im.point3D_ids
                            if int(q) >= 0 and int(q) in id_to_idx
                        ],
                        np.int64,
                    )
                    self.point_indices[os.path.basename(im.name)] = idx
                break
        self._dist = None
        self._model = "pinhole"

        c2ws = np.stack(c2ws)
        self.transform = np.eye(4)
        if normalize:
            t1 = similarity_from_cameras(c2ws)
            c2ws = transform_cameras(t1, c2ws)
            if len(self.points):
                pts = transform_points(t1, self.points)
                t2 = align_principal_axes(pts)
                c2ws = transform_cameras(t2, c2ws)
                self.points = transform_points(t2, pts).astype(np.float32)
                self.transform = t2 @ t1
            else:
                self.transform = t1
        for i, pim in enumerate(self.images):
            pim.camtoworld = c2ws[i]

        centers = c2ws[:, :3, 3]
        d = np.linalg.norm(centers - centers.mean(axis=0), axis=-1)
        self.scene_scale = float(d.max()) * 1.1 if len(centers) > 1 else 1.0


def open_dataset(data_dir: str, **kw) -> Parser:
    """Auto-detect COLMAP vs nerfstudio layout."""
    if os.path.exists(os.path.join(data_dir, "transforms.json")):
        return NerfstudioParser(data_dir, **kw)
    return Parser(data_dir, **kw)
