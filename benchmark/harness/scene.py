"""The benchmark's scene: analytic surfaces ray-cast in plain torch, written as
a COLMAP model with PNG images that the port's own parser reads.

The layout follows the Mip-NeRF 360 *garden* capture at ``data_factor`` 4 as
the configuration gives it: a ring of cameras around a textured foreground
(spheres that carry the SfM points), inside a wall and over a ground that no
SfM point covers. The geometry and the cameras are the same for every seed, so
every seed gives the same sizes; the seed draws the textures and the SfM
points. Nothing of the port renders or writes these inputs.

``scene(cfg, seed, device)`` returns a ``Scene``; ``ensure_on_disk`` writes
it under ``benchmark/.cache/scene/<config>-<seed>/`` unless that directory is
already complete, and deletes any other scene there first (one at most).
"""
from __future__ import annotations

import os
import shutil
import struct
import zlib
from dataclasses import dataclass

import numpy as np
import torch

CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache", "scene")


@dataclass
class Scene:
    width: int
    height: int
    c2w: torch.Tensor  # [C, 4, 4] float64, OpenCV convention
    K: torch.Tensor  # [3, 3] float64
    spheres: torch.Tensor  # [S, 4] centre xyz, radius
    wall_r: float
    wall_top: float
    ground_y: float
    tex: dict  # per surface kind: frequencies [3, T, 3], phases [3, T], base [3]
    sfm_xyz: np.ndarray  # [P, 3] float64
    sfm_rgb: np.ndarray  # [P, 3] uint8
    names: list
    device: torch.device

    @property
    def n_cams(self) -> int:
        return self.c2w.shape[0]


def look_at(eye, target, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """OpenCV camera-to-world (+z forward, +y down)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(np.asarray(up, np.float64), fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    return c2w


def _texture_params(rng, n_terms):
    # Log-uniform spatial frequencies (2 to 80 rad per metre): texture from a
    # metre down to about a pixel of the far wall.
    mags = np.exp(rng.uniform(np.log(2.0), np.log(80.0), (3, n_terms)))
    dirs = rng.normal(size=(3, n_terms, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dict(freq=dirs * mags[..., None], phase=rng.uniform(0, 2 * np.pi, (3, n_terms)),
                base=rng.uniform(0.3, 0.7, 3))


def scene(sc: dict, seed: int, device) -> Scene:
    """The scene of the configuration's ``scene`` group under ``seed``."""
    dev = torch.device(device)
    layout = np.random.default_rng(sc["layout_seed"])  # the same for every seed
    centres = layout.uniform(-1.0, 1.0, (sc["spheres"], 3)) * [1.0, 0.5, 1.0]
    spheres = np.concatenate([centres, np.full((sc["spheres"], 1), sc["sphere_radius"])], 1)
    n = sc["cameras"]
    c2w = []
    for i in range(n):
        a = 2 * np.pi * i / n
        eye = np.array([sc["ring_radius"] * np.cos(a), -0.4 + 0.5 * np.sin(2 * a), sc["ring_radius"] * np.sin(a)])
        c2w.append(look_at(eye, np.zeros(3)))
    w, h = sc["width"], sc["height"]
    f = sc["focal_factor"] * w
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    rng = np.random.default_rng(seed)
    tex = {k: _texture_params(rng, sc["texture_terms"]) for k in ("sphere", "wall", "ground")}
    # SfM points: uniform on the spheres' surfaces.
    p = sc["sfm_points"]
    d = rng.normal(size=(p, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    which = rng.integers(0, sc["spheres"], p)
    sfm = spheres[which, :3] + d * spheres[which, 3:4]
    s = Scene(
        width=w, height=h, c2w=torch.as_tensor(np.stack(c2w), device=dev), K=torch.as_tensor(K, device=dev),
        spheres=torch.as_tensor(spheres, device=dev), wall_r=sc["wall_radius"], wall_top=sc["wall_top"],
        ground_y=sc["ground_y"], tex={k: {n_: torch.as_tensor(v, device=dev) for n_, v in t.items()}
                                      for k, t in tex.items()},
        sfm_xyz=sfm, sfm_rgb=np.zeros((p, 3), np.uint8), names=[f"frame_{i:04d}.png" for i in range(n)],
        device=dev,
    )
    kind = torch.zeros(p, dtype=torch.long, device=dev)
    s.sfm_rgb = to_u8(shade(s, torch.as_tensor(sfm, device=dev), kind)).cpu().numpy()
    return s


def shade(s: Scene, pts: torch.Tensor, kind: torch.Tensor) -> torch.Tensor:
    """Colour [N, 3] in [0, 1] of world points on surface kind 0 (spheres),
    1 (wall) or 2 (ground); float64."""
    out = torch.zeros(pts.shape, dtype=torch.float64, device=pts.device)
    for k, name in enumerate(("sphere", "wall", "ground")):
        t = s.tex[name]
        arg = torch.einsum("nd,ctd->nct", pts, t["freq"]) + t["phase"][None]
        col = t["base"][None] + (0.4 / t["freq"].shape[1] ** 0.5) * torch.sin(arg).sum(-1)
        out = torch.where((kind == k)[:, None], col, out)
    return out.clamp(0.0, 1.0)


def to_u8(rgb: torch.Tensor) -> torch.Tensor:
    return torch.round(rgb * 255.0).to(torch.uint8)


@torch.no_grad()
def cast(s: Scene, cam: int):
    """Ray-cast one camera: (image uint8 [H, W, 3], z-depth float32 [H, W],
    NaN where a ray meets nothing)."""
    dev = s.device
    ys, xs = torch.meshgrid(torch.arange(s.height, device=dev, dtype=torch.float64) + 0.5,
                            torch.arange(s.width, device=dev, dtype=torch.float64) + 0.5, indexing="ij")
    K, c2w = s.K, s.c2w[cam]
    dcam = torch.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], torch.ones_like(xs)], -1)
    d = dcam.reshape(-1, 3) @ c2w[:3, :3].T  # unnormalised: t is the camera z-depth
    o = c2w[:3, 3]
    inf = torch.full((d.shape[0],), float("inf"), dtype=torch.float64, device=dev)
    best, kind = inf.clone(), torch.full_like(inf, -1, dtype=torch.long)
    for c in s.spheres:  # |o + t d - c|^2 = r^2, nearest positive root
        oc = o - c[:3]
        a = (d * d).sum(-1)
        b = 2 * (d @ oc)
        disc = b * b - 4 * a * (oc @ oc - c[3] ** 2)
        t = (-b - torch.sqrt(disc.clamp(min=0))) / (2 * a)
        t = torch.where((disc > 0) & (t > 0), t, inf)
        kind = torch.where(t < best, 0, kind)
        best = torch.minimum(best, t)
    # The wall: the cylinder x^2 + z^2 = R^2 seen from inside, above the ground.
    a = d[:, 0] ** 2 + d[:, 2] ** 2
    b = 2 * (o[0] * d[:, 0] + o[2] * d[:, 2])
    cc = o[0] ** 2 + o[2] ** 2 - s.wall_r ** 2
    t = (-b + torch.sqrt((b * b - 4 * a * cc).clamp(min=0))) / (2 * a).clamp(min=1e-30)
    y = o[1] + t * d[:, 1]
    t = torch.where((t > 0) & (y >= s.wall_top) & (y <= s.ground_y), t, inf)
    kind = torch.where(t < best, 1, kind)
    best = torch.minimum(best, t)
    # The ground: the plane y = ground_y (y down) inside the wall.
    t = (s.ground_y - o[1]) / torch.where(d[:, 1].abs() > 1e-12, d[:, 1], 1e-12)
    p = o + t[:, None] * d
    t = torch.where((t > 0) & (p[:, 0] ** 2 + p[:, 2] ** 2 <= s.wall_r ** 2), t, inf)
    kind = torch.where(t < best, 2, kind)
    best = torch.minimum(best, t)
    hit = torch.isfinite(best)
    pts = o + torch.where(hit, best, 0.0)[:, None] * d
    rgb = torch.where(hit[:, None], shade(s, pts, kind), 0.0)
    img = to_u8(rgb).reshape(s.height, s.width, 3)
    depth = torch.where(hit, best, float("nan")).reshape(s.height, s.width).float()
    return img, depth


def w2c_qt(c2w: np.ndarray):
    w2c = np.linalg.inv(c2w)
    r = w2c[:3, :3]
    # Rotation matrix -> (w, x, y, z), the largest-component branch.
    tr = np.trace(r)
    if tr > 0:
        s = 2 * np.sqrt(tr + 1)
        q = [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2 * np.sqrt(1 + r[i, i] - r[j, j] - r[k, k])
        q = [0.0] * 4
        q[0] = (r[k, j] - r[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (r[j, i] + r[i, j]) / s
        q[1 + k] = (r[k, i] + r[i, k]) / s
    return np.asarray(q), w2c[:3, 3]


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of a uint8 [H, W, 3] image: filter 0 rows, one stored IDAT.
    The textures hardly compress (3.06 MB at level 1 against
    3.27 stored at 1296x840), and a stored file takes a tenth of the time to
    write and a third to read."""
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    return b"".join([b"\x89PNG\r\n\x1a\n", chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
                     chunk(b"IDAT", zlib.compress(raw, 0)), chunk(b"IEND", b"")])


@torch.no_grad()
def observations(s: Scene, cam: int, depth: torch.Tensor, rtol: float):
    """The SfM points that camera ``cam`` sees: (their pixel xy [M, 2], their
    indices [M]); a point counts where its depth is within ``rtol`` of the
    ray-cast depth at its pixel."""
    pts = torch.as_tensor(s.sfm_xyz, device=s.device)
    w2c = torch.linalg.inv(s.c2w[cam])
    cam_p = pts @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam_p[:, 2]
    uv = cam_p[:, :2] / z[:, None] * torch.stack([s.K[0, 0], s.K[1, 1]]) + torch.stack([s.K[0, 2], s.K[1, 2]])
    ok = (z > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < s.width) & (uv[:, 1] >= 0) & (uv[:, 1] < s.height)
    xi = uv[:, 0].clamp(0, s.width - 1).long()
    yi = uv[:, 1].clamp(0, s.height - 1).long()
    surf = depth[yi, xi].double()
    ok &= (z - surf).abs() <= rtol * surf
    idx = torch.nonzero(ok).flatten()
    return uv[idx].cpu().numpy(), idx.cpu().numpy()


def ensure_on_disk(s: Scene, sc: dict, key: str) -> str:
    """The scene as a COLMAP directory (``images_<factor>/`` PNGs and
    ``sparse/0`` binaries), written unless already complete. Returns it."""
    root = os.path.join(CACHE, key)
    if os.path.exists(os.path.join(root, "complete")):
        return root
    if os.path.isdir(CACHE):
        for other in os.listdir(CACHE):  # one scene at most
            shutil.rmtree(os.path.join(CACHE, other), ignore_errors=True)
    tmp = root + ".partial"
    factor = sc["data_factor"]
    img_dir = os.path.join(tmp, f"images_{factor}")
    sparse = os.path.join(tmp, "sparse", "0")
    os.makedirs(img_dir)
    os.makedirs(sparse)
    K = s.K.cpu().numpy() * factor  # the full-resolution camera, as COLMAP holds it
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, s.width * factor, s.height * factor))  # PINHOLE
        f.write(struct.pack("<4d", K[0, 0], K[1, 1], K[0, 2], K[1, 2]))
    with open(os.path.join(sparse, "images.bin"), "wb") as fi:
        fi.write(struct.pack("<Q", s.n_cams))
        for i in range(s.n_cams):
            img, depth = cast(s, i)
            with open(os.path.join(img_dir, s.names[i]), "wb") as f:
                f.write(encode_png(img.cpu().numpy()))
            uv, idx = observations(s, i, depth, sc["sfm_visible_rtol"])
            q, t = w2c_qt(s.c2w[i].cpu().numpy())
            fi.write(struct.pack("<i4d3di", i + 1, *q, *t, 1) + s.names[i].encode() + b"\x00")
            rec = np.zeros((len(idx), 3), np.float64)
            rec[:, :2] = uv * factor
            rec[:, 2] = idx.astype(np.int64).view(np.float64)
            fi.write(struct.pack("<Q", len(idx)) + rec.tobytes())
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(s.sfm_xyz)))
        for i, (p, c) in enumerate(zip(s.sfm_xyz, s.sfm_rgb)):
            f.write(struct.pack("<q3d3Bd", i, *p, *c, 0.5) + struct.pack("<Q", 0))
    open(os.path.join(tmp, "complete"), "w").close()
    os.rename(tmp, root)
    return root
