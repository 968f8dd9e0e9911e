"""COLMAP sparse-reconstruction IO — self-contained numpy reader/writer.

Replaces the reference's pycolmap dependency (datasets/colmap.py:29-327)
with a direct parser of COLMAP's documented binary/text formats
(cameras/images/points3D). The writer exists for tests (synthetic COLMAP
scenes on disk) and for exporting.

Format reference: COLMAP src/colmap/scene/reconstruction_io.cc (public
documentation of the .bin layout).
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # model-specific


@dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # [4] (w, x, y, z) world->cam rotation
    tvec: np.ndarray  # [3] world->cam translation
    camera_id: int
    name: str
    xys: np.ndarray  # [M, 2] keypoints
    point3D_ids: np.ndarray  # [M] int64 (-1 = no 3D point)


@dataclass
class ColmapReconstruction:
    cameras: Dict[int, ColmapCamera]
    images: Dict[int, ColmapImage]
    points_xyz: np.ndarray  # [P, 3] float64
    points_rgb: np.ndarray  # [P, 3] uint8
    points_err: np.ndarray  # [P]
    point_ids: np.ndarray  # [P] int64 original COLMAP ids


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat_to_qvec(r: np.ndarray) -> np.ndarray:
    t = np.trace(r)
    if t > 0:
        w = np.sqrt(1 + t) / 2
        x = (r[2, 1] - r[1, 2]) / (4 * w)
        y = (r[0, 2] - r[2, 0]) / (4 * w)
        z = (r[1, 0] - r[0, 1]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1 + r[i, i] - r[j, j] - r[k, k], 1e-12)) * 2
        q = np.zeros(4)
        q[1 + i] = s / 4
        q[0] = (r[k, j] - r[j, k]) / s
        q[1 + j] = (r[j, i] + r[i, j]) / s
        q[1 + k] = (r[k, i] + r[i, k]) / s
        return q
    return np.array([w, x, y, z])


# ---------------------------------------------------------------- binary read


def _read(fmt, f):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read("<Q", f)
        for _ in range(num):
            cid, model_id, w, h = _read("<iiQQ", f)
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f"<{np_}d", f))
            out[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return out


def read_images_bin(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read("<Q", f)
        for _ in range(num):
            iid = _read("<i", f)[0]
            qvec = np.array(_read("<4d", f))
            tvec = np.array(_read("<3d", f))
            cam_id = _read("<i", f)[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (m,) = _read("<Q", f)
            data = np.frombuffer(f.read(24 * m), dtype=np.float64).reshape(m, 3)
            xys = data[:, :2].copy()
            p3d = data[:, 2].view(np.int64).copy()
            out[iid] = ColmapImage(
                iid, qvec, tvec, cam_id, name.decode("utf-8"), xys, p3d
            )
    return out


def read_points3d_bin(path: str):
    with open(path, "rb") as f:
        (num,) = _read("<Q", f)
        ids = np.empty(num, np.int64)
        xyz = np.empty((num, 3), np.float64)
        rgb = np.empty((num, 3), np.uint8)
        err = np.empty(num, np.float64)
        for i in range(num):
            (ids[i],) = _read("<q", f)
            xyz[i] = _read("<3d", f)
            rgb[i] = _read("<3B", f)
            (err[i],) = _read("<d", f)
            (tlen,) = _read("<Q", f)
            f.seek(8 * tlen, 1)
    return ids, xyz, rgb, err


# ------------------------------------------------------------------ text read


def read_cameras_txt(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            cid, model, w, h = int(parts[0]), parts[1], int(parts[2]), int(parts[3])
            out[cid] = ColmapCamera(
                cid, model, w, h, np.array([float(p) for p in parts[4:]])
            )
    return out


def read_images_txt(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        lines = [l for l in f if not l.startswith("#") and l.strip()]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        iid = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        pts = lines[i + 1].split()
        m = len(pts) // 3
        xys = np.array(
            [[float(pts[3 * j]), float(pts[3 * j + 1])] for j in range(m)]
        ).reshape(m, 2)
        p3d = np.array([int(pts[3 * j + 2]) for j in range(m)], np.int64)
        out[iid] = ColmapImage(iid, qvec, tvec, cam_id, name, xys, p3d)
    return out


def read_points3d_txt(path: str):
    ids, xyz, rgb, err = [], [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            p = line.split()
            ids.append(int(p[0]))
            xyz.append([float(p[1]), float(p[2]), float(p[3])])
            rgb.append([int(p[4]), int(p[5]), int(p[6])])
            err.append(float(p[7]))
    return (
        np.array(ids, np.int64),
        np.array(xyz, np.float64),
        np.array(rgb, np.uint8),
        np.array(err, np.float64),
    )


# -------------------------------------------------------------------- loading


def read_reconstruction(sparse_dir: str) -> ColmapReconstruction:
    """Load a COLMAP sparse model from a directory (bin preferred)."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_bin(os.path.join(sparse_dir, "images.bin"))
        ids, xyz, rgb, err = read_points3d_bin(
            os.path.join(sparse_dir, "points3D.bin")
        )
    elif os.path.exists(os.path.join(sparse_dir, "cameras.txt")):
        cams = read_cameras_txt(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_txt(os.path.join(sparse_dir, "images.txt"))
        ids, xyz, rgb, err = read_points3d_txt(
            os.path.join(sparse_dir, "points3D.txt")
        )
    else:
        raise FileNotFoundError(f"no COLMAP model in {sparse_dir}")
    return ColmapReconstruction(
        cameras=cams,
        images=imgs,
        points_xyz=xyz,
        points_rgb=rgb,
        points_err=err,
        point_ids=ids,
    )


# -------------------------------------------------------------------- writing


def write_reconstruction_bin(
    sparse_dir: str, rec: ColmapReconstruction
) -> None:
    os.makedirs(sparse_dir, exist_ok=True)
    with open(os.path.join(sparse_dir, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(rec.cameras)))
        for c in rec.cameras.values():
            f.write(
                struct.pack("<iiQQ", c.camera_id, MODEL_IDS[c.model], c.width, c.height)
            )
            f.write(struct.pack(f"<{len(c.params)}d", *c.params))
    with open(os.path.join(sparse_dir, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(rec.images)))
        for im in rec.images.values():
            f.write(struct.pack("<i", im.image_id))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            m = len(im.xys)
            f.write(struct.pack("<Q", m))
            data = np.empty((m, 3), np.float64)
            data[:, :2] = im.xys
            data[:, 2] = im.point3D_ids.view(np.float64) if im.point3D_ids.dtype == np.float64 else np.asarray(im.point3D_ids, np.int64).view(np.float64)
            f.write(data.tobytes())
    with open(os.path.join(sparse_dir, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(rec.point_ids)))
        for i in range(len(rec.point_ids)):
            f.write(struct.pack("<q", int(rec.point_ids[i])))
            f.write(struct.pack("<3d", *rec.points_xyz[i]))
            f.write(struct.pack("<3B", *rec.points_rgb[i]))
            f.write(struct.pack("<d", float(rec.points_err[i])))
            f.write(struct.pack("<Q", 0))  # empty track
