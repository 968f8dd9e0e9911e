"""PLY point-cloud and gaussian-splat IO (numpy) — the port's own copy of
``gs_init_tpu/utils/ply.py``, with the same byte layouts, so either package
reads the other's files.

Binary little-endian writer and reader for xyz+rgb clouds, and the standard
3DGS splat layout (x, y, z, nx, ny, nz, f_dc_*, f_rest_*, opacity, scale_*,
rot_*) that common 3DGS viewers read.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def write_ply_points(
    path: str,
    points: np.ndarray,  # [N, 3]
    colors: Optional[np.ndarray] = None,  # [N, 3] float [0,1] or uint8
    sigma_outlier_filter: Optional[float] = None,
) -> None:
    points = np.asarray(points, np.float32)
    if sigma_outlier_filter is not None:
        # Drop points further than k sigma from the centroid (reference
        # point_cloud_export.py outlier filter).
        d = np.linalg.norm(points - points.mean(axis=0), axis=-1)
        keep = d <= d.mean() + sigma_outlier_filter * d.std()
        points = points[keep]
        if colors is not None:
            colors = np.asarray(colors)[keep]
    n = len(points)
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        hdr += [f"property float {a}" for a in "xyz"]
        if has_color:
            hdr += [f"property uchar {c}" for c in ("red", "green", "blue")]
        hdr += ["end_header", ""]
        f.write("\n".join(hdr).encode())
        if has_color:
            rec = np.zeros(
                n,
                dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)],
            )
            rec["xyz"] = points
            rec["rgb"] = colors
            f.write(rec.tobytes())
        else:
            f.write(points.astype("<f4").tobytes())


def read_ply_points(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    with open(path, "rb") as f:
        props = []
        n = 0
        fmt = None
        while True:
            line = f.readline().decode().strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property"):
                _, tp, name = line.split()
                props.append((name, tp))
            elif line == "end_header":
                break
        tpmap = {"float": "<f4", "uchar": "u1", "double": "<f8", "int": "<i4"}
        if fmt == "binary_little_endian":
            dtype = np.dtype([(name, tpmap[tp]) for name, tp in props])
            rec = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype)
        else:
            rows = np.loadtxt(f, max_rows=n).reshape(n, len(props))
            rec = {name: rows[:, i] for i, (name, _) in enumerate(props)}
    xyz = np.stack([np.asarray(rec["x"]), np.asarray(rec["y"]), np.asarray(rec["z"])], -1).astype(
        np.float32
    )
    names = [p[0] for p in props]
    rgb = None
    if "red" in names:
        rgb = np.stack(
            [np.asarray(rec["red"]), np.asarray(rec["green"]), np.asarray(rec["blue"])], -1
        ).astype(np.float32)
        if rgb.max() > 1.0:
            rgb /= 255.0
    return xyz, rgb


def write_ply_splats(
    path: str,
    means: np.ndarray,  # [N, 3]
    scales: np.ndarray,  # [N, 3] log-scale
    quats: np.ndarray,  # [N, 4]
    opacities: np.ndarray,  # [N] logit
    sh0: np.ndarray,  # [N, 1, 3]
    shN: np.ndarray,  # [N, K-1, 3]
) -> None:
    """Standard 3DGS splat PLY (viewer-compatible), logit/log-space values."""
    n = means.shape[0]
    k_rest = shN.shape[1]
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(3 * k_rest)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    cols = [
        means.astype(np.float32),
        np.zeros((n, 3), np.float32),
        sh0.reshape(n, 3).astype(np.float32),
        # 3DGS PLY stores f_rest channel-major: [3, K-1] flattened.
        np.transpose(shN, (0, 2, 1)).reshape(n, 3 * k_rest).astype(np.float32),
        opacities.reshape(n, 1).astype(np.float32),
        scales.astype(np.float32),
        quats.astype(np.float32),
    ]
    data = np.concatenate(cols, axis=1)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        hdr += [f"property float {nm}" for nm in names]
        hdr += ["end_header", ""]
        f.write("\n".join(hdr).encode())
        f.write(data.astype("<f4").tobytes())


def read_ply_splats(path: str):
    """Read a 3DGS splat PLY back into (means, scales, quats, opac, sh0, shN)."""
    with open(path, "rb") as f:
        names = []
        n = 0
        while True:
            line = f.readline().decode().strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property"):
                names.append(line.split()[-1])
            elif line == "end_header":
                break
        data = np.frombuffer(f.read(4 * len(names) * n), dtype="<f4").reshape(
            n, len(names)
        )
    col = {nm: i for i, nm in enumerate(names)}
    means = data[:, [col["x"], col["y"], col["z"]]]
    sh0 = data[:, [col["f_dc_0"], col["f_dc_1"], col["f_dc_2"]]][:, None, :]
    k_rest = sum(1 for nm in names if nm.startswith("f_rest_")) // 3
    if k_rest:
        rest = data[:, [col[f"f_rest_{i}"] for i in range(3 * k_rest)]]
        shN = np.transpose(rest.reshape(n, 3, k_rest), (0, 2, 1))
    else:
        shN = np.zeros((n, 0, 3), np.float32)
    opac = data[:, col["opacity"]]
    scales = data[:, [col["scale_0"], col["scale_1"], col["scale_2"]]]
    quats = data[:, [col[f"rot_{i}"] for i in range(4)]]
    return means, scales, quats, opac, sh0, shN
