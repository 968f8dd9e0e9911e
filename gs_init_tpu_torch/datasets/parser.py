"""COLMAP scene parser + train/val dataset — the port's own copy of
``gs_init_tpu/datasets/parser.py`` (numpy only).

Factor-suffixed image dirs, K rescaled to the on-disk image size, optional
world normalisation, undistortion for distorted models (needs ``cv2``),
per-image SfM point indices, scene scale, the test_every split and sparse
SfM depth targets. Images are read with imageio or PIL when installed,
else by the minimal PNG decoder in ``png.py``.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .colmap_io import ColmapReconstruction, qvec_to_rotmat, read_reconstruction
from .normalize import (
    align_principal_axes,
    similarity_from_cameras,
    transform_cameras,
    transform_points,
)
from .png import read_png


def _imread(path: str) -> np.ndarray:
    try:
        import imageio.v2 as imageio
    except ImportError:
        imageio = None
    if imageio is not None:
        img = imageio.imread(path)
    elif path.lower().endswith(".png"):
        img = read_png(path)
    else:
        from PIL import Image

        with Image.open(path) as pil:
            img = np.asarray(pil)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3]


@dataclass
class ParsedImage:
    name: str
    path: str
    camtoworld: np.ndarray  # [4, 4]
    K: np.ndarray  # [3, 3] (rescaled to actual image size)
    camera_id: int
    width: int
    height: int


class Parser:
    """Parses a COLMAP scene directory (data_dir/sparse/0 + images[_factor])."""

    def __init__(self, data_dir: str, factor: int = 1, normalize: bool = True, test_every: int = 8):
        self.data_dir = data_dir
        self.factor = factor
        self.test_every = test_every
        sparse = None
        for cand in ["sparse/0", "sparse", "colmap/sparse/0", "colmap/sparse"]:
            p = os.path.join(data_dir, cand)
            if os.path.exists(os.path.join(p, "cameras.bin")) or os.path.exists(
                os.path.join(p, "cameras.txt")
            ):
                sparse = p
                break
        if sparse is None:
            raise FileNotFoundError(f"no COLMAP sparse model under {data_dir}")
        rec: ColmapReconstruction = read_reconstruction(sparse)

        img_dir = os.path.join(data_dir, "images" if factor == 1 else f"images_{factor}")
        if not os.path.isdir(img_dir):
            img_dir = os.path.join(data_dir, "images")
        self.image_dir = img_dir
        images = sorted(rec.images.values(), key=lambda im: im.name)
        id_to_idx = {int(pid): i for i, pid in enumerate(rec.point_ids)}
        self.points = rec.points_xyz.astype(np.float32)
        self.points_rgb = rec.points_rgb.astype(np.float32) / 255.0
        self.points_err = rec.points_err.astype(np.float32)

        self.images: List[ParsedImage] = []
        self.point_indices: Dict[str, np.ndarray] = {}
        self._dist, self._model = None, "pinhole"
        c2ws = []
        for im in images:
            cam = rec.cameras[im.camera_id]
            path = os.path.join(img_dir, im.name)
            if not os.path.exists(path):
                continue
            ah, aw = _imread(path).shape[:2]
            K, dist, model = _camera_matrix(cam)
            K = K.copy()
            K[0] *= aw / cam.width
            K[1] *= ah / cam.height
            w2c = np.eye(4)
            w2c[:3, :3] = qvec_to_rotmat(im.qvec)
            w2c[:3, 3] = im.tvec
            c2w = np.linalg.inv(w2c)
            c2ws.append(c2w)
            self.images.append(
                ParsedImage(
                    name=im.name, path=path, camtoworld=c2w, K=K,
                    camera_id=im.camera_id, width=aw, height=ah,
                )
            )
            self.point_indices[im.name] = np.array(
                [id_to_idx[int(p)] for p in im.point3D_ids if int(p) >= 0 and int(p) in id_to_idx],
                np.int64,
            )
            self._dist, self._model = dist, model
        if not self.images:
            raise FileNotFoundError(f"no images found under {img_dir}")

        c2ws = np.stack(c2ws)
        self.transform = np.eye(4)
        if normalize:
            t1 = similarity_from_cameras(c2ws)
            c2ws = transform_cameras(t1, c2ws)
            pts = transform_points(t1, self.points)
            t2 = align_principal_axes(pts)
            c2ws = transform_cameras(t2, c2ws)
            self.points = transform_points(t2, pts).astype(np.float32)
            self.transform = t2 @ t1
        for i, pim in enumerate(self.images):
            pim.camtoworld = c2ws[i]
        centers = c2ws[:, :3, 3]
        dists = np.linalg.norm(centers - centers.mean(axis=0), axis=-1)
        self.scene_scale = float(dists.max()) * 1.1

    @property
    def num_images(self) -> int:
        return len(self.images)

    def split_indices(self, split: str) -> np.ndarray:
        idx = np.arange(self.num_images)
        if self.test_every <= 0:
            return idx
        if split == "train":
            return idx[idx % self.test_every != 0]
        return idx[idx % self.test_every == 0]


def _camera_matrix(cam):
    """K, distortion coefficients and model family for a COLMAP camera."""
    p = cam.params
    if cam.model == "SIMPLE_PINHOLE":
        return np.array([[p[0], 0, p[1]], [0, p[0], p[2]], [0, 0, 1.0]]), None, "pinhole"
    if cam.model == "PINHOLE":
        return np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]]), None, "pinhole"
    if cam.model == "SIMPLE_RADIAL":
        K = np.array([[p[0], 0, p[1]], [0, p[0], p[2]], [0, 0, 1.0]])
        return K, np.array([p[3], 0, 0, 0]), "pinhole"
    if cam.model == "RADIAL":
        K = np.array([[p[0], 0, p[1]], [0, p[0], p[2]], [0, 0, 1.0]])
        return K, np.array([p[3], p[4], 0, 0]), "pinhole"
    if cam.model == "OPENCV":
        K = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]])
        return K, np.array(p[4:8]), "pinhole"
    if cam.model == "OPENCV_FISHEYE":
        K = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]])
        return K, np.array(p[4:8]), "fisheye"
    raise ValueError(f"unsupported camera model {cam.model}")


class Dataset:
    """Index-based dataset over a Parser split. Images are decoded on first
    use (undistorted when the camera model has distortion) and kept as
    uint8 within a byte budget (``cache_bytes``, 0 for none); ``patch_size``
    crops a random square with the principal-point shift, at offsets drawn
    from ``rng`` (a numpy RandomState; numpy's global one when None, as the
    JAX package draws them)."""

    def __init__(
        self,
        parser: Parser,
        split: str = "train",
        patch_size: Optional[int] = None,
        load_depths: bool = False,
        cache_bytes: int = 0,
        rng: Optional[np.random.RandomState] = None,
    ):
        self.parser = parser
        self.indices = parser.split_indices(split)
        self.patch_size = patch_size
        self.load_depths = load_depths
        self._rng = rng if rng is not None else np.random
        # The prefetch thread and the train loop both read the cache.
        self._cache_budget = int(cache_bytes)
        self._cache_used = 0
        self._img_cache: Dict[int, tuple] = {}
        self._cache_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.indices)

    def _undistort(self, img: np.ndarray, pim: ParsedImage):
        dist = self.parser._dist
        if dist is None or not np.any(dist):
            return img, pim.K
        import cv2

        if self.parser._model == "fisheye":
            K = cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(
                pim.K, dist, (pim.width, pim.height), np.eye(3), balance=0.0
            )
            m1, m2 = cv2.fisheye.initUndistortRectifyMap(
                pim.K, dist, np.eye(3), K, (pim.width, pim.height), cv2.CV_32FC1
            )
        else:
            K, _ = cv2.getOptimalNewCameraMatrix(pim.K, dist, (pim.width, pim.height), 0)
            m1, m2 = cv2.initUndistortRectifyMap(
                pim.K, dist, None, K, (pim.width, pim.height), cv2.CV_32FC1
            )
        return cv2.remap(img, m1, m2, cv2.INTER_LINEAR), K

    def _load(self, i: int, pim: ParsedImage):
        """(float32 image in [0, 1], K) after undistortion; cached as uint8."""
        with self._cache_lock:
            hit = self._img_cache.get(i)
        if hit is not None:
            img8, K = hit
            return img8.astype(np.float32) / 255.0, K
        img = _imread(pim.path).astype(np.float32) / 255.0
        img, K = self._undistort(img, pim)
        if self._cache_budget > 0:
            img8 = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
            with self._cache_lock:
                if i not in self._img_cache and self._cache_used + img8.nbytes <= self._cache_budget:
                    self._img_cache[i] = (img8, K)
                    self._cache_used += img8.nbytes
        return img, K

    def __getitem__(self, i: int) -> dict:
        pim = self.parser.images[int(self.indices[i])]
        img, K = self._load(i, pim)
        if self.patch_size:
            # Every item must have the same crop size (batches stack), so an
            # image smaller than the patch is a configuration error.
            p = self.patch_size
            if img.shape[0] < p or img.shape[1] < p:
                raise ValueError(
                    f"patch_size={p} exceeds image {pim.name} "
                    f"({img.shape[1]}x{img.shape[0]}); lower patch_size or data_factor"
                )
            y0 = self._rng.randint(0, img.shape[0] - p + 1)
            x0 = self._rng.randint(0, img.shape[1] - p + 1)
            img = img[y0 : y0 + p, x0 : x0 + p]
            K = np.array(K, copy=True)
            K[0, 2] -= x0
            K[1, 2] -= y0
        out = dict(
            K=np.asarray(K, np.float32),
            camtoworld=pim.camtoworld.astype(np.float32),
            image=img,
            image_id=int(self.indices[i]),
            image_name=pim.name,
        )
        if self.load_depths:
            idx = self.parser.point_indices.get(pim.name, np.empty(0, np.int64))
            pts = self.parser.points[idx]
            w2c = np.linalg.inv(pim.camtoworld)
            cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
            z = cam[:, 2]
            uv = cam[:, :2] / np.maximum(z[:, None], 1e-8)
            pix = uv @ K[:2, :2].T + K[:2, 2]
            ok = (
                (z > 0)
                & (pix[:, 0] >= 0)
                & (pix[:, 0] < img.shape[1])
                & (pix[:, 1] >= 0)
                & (pix[:, 1] < img.shape[0])
            )
            out["depth_points"] = pix[ok].astype(np.float32)
            out["depth_values"] = z[ok].astype(np.float32)
        return out
