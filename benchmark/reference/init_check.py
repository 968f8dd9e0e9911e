"""The check of an init cell, on a sample of the window's images drawn from the
seed.

- ``depth_gap``: the program's predicted depth against the reference
  network's (``depthnet/``, the benchmark's own weights, float32 with TF32
  off) on the same image: the largest absolute gap over the largest
  reference depth;
- ``align_gap``: the reference's alignment (``mdi/``: RANSAC with the same
  generator, seeded as the port seeds it and advanced by the images before
  it in its call) run on the program's depth, against the program's scale
  and shift: the largest gap of the aligned depth over its largest value;
- ``mask_mismatch``: pixels whose kept-or-not differs between the program's
  unprojection mask and the reference's;
- ``points_gap``: the image's unprojected points in the program's returned
  cloud against the reference's, over the camera ring's radius in the
  normalised world;
- ``rgb_gap``: their colours against the scene's own pixels there.

The alignment follows the program's own depth: a random network's depth
makes RANSAC's choice among near-equal hypotheses flip on rounding, so the
depth is checked by itself first. With ``control="tf32"`` the reference
network with TF32 matmuls and convolutions stands in for the program's
depth.
"""
from __future__ import annotations

import numpy as np
import torch

from ..harness import scene as S
from . import cameras as C
from .depthnet import metric3d as M
from .mdi import points_from_depth as P
from .train_check import scene_cameras


def sfm_normalised(scn):
    """The SfM points in the normalised world, float32, as the parser holds them."""
    c2w = scn.c2w.cpu().numpy().astype(np.float64)
    pts = scn.sfm_xyz.astype(np.float32)
    t1 = C.similarity_from_cameras(c2w)
    pts = C.transform_points(t1, pts)
    t2 = C.align_principal_axes(pts)
    return C.transform_points(t2, pts).astype(np.float32)


def reference_net(backbone, sd, dev):
    with torch.device("meta"):
        net = M.Metric3DNet(backbone)
    net = net.to_empty(device=dev)
    net.load_state_dict(sd)
    return net.eval()


def check(limits, bounds, config, scn, got, sd, pseed, dev, n_train, control=None):
    sc, st = config["scene"], config["settings"]
    c2w, K, _, _ = scene_cameras(scn, sc)
    sfm = sfm_normalised(scn)
    observed = [S.observations(scn, i, S.cast(scn, i)[1], sc["sfm_visible_rtol"])[1] for i in range(scn.n_cams)]
    m_pad = max(max(len(o) for o in observed), 1)
    train_cams = [i for i in range(scn.n_cams) if i % sc["test_every"]]
    backbone = {"vits": "small", "vitl": "large", "vitg": "giant"}.get(st["mdi.backbone"], st["mdi.backbone"])
    net = reference_net(backbone, sd, dev)
    T = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x), dtype=dt, device=dev)
    gaps = dict(depth_gap=0.0, align_gap=0.0, mask_mismatch=0.0, points_gap=0.0, rgb_gap=0.0)
    radius = float(np.linalg.norm(c2w[:, :3, 3], axis=-1).max())
    for pos, positions, first, pts, rgb in got["chunks"]:
        for k, p in enumerate(positions):
            if pos + k not in got["sample"]:
                continue
            cam = train_cams[p]
            img = S.cast(scn, cam)[0].cpu().numpy()
            d_ref, _ = M.predict(net, dev, img[None], [float(K[0, 0])])
            d_got, m_got = got["depth"][pos + k]
            if control == "tf32":
                prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
                d_c, m_c = M.predict(net, dev, img[None], [float(K[0, 0])], fp32=False)
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
                d_got, m_got = d_c[0].cpu().numpy(), m_c[0].cpu().numpy()
            d_ref = d_ref[0]
            gaps["depth_gap"] = max(gaps["depth_gap"],
                                    float((T(d_got) - d_ref).abs().max() / d_ref.abs().max().clamp(min=1e-30)))
            # The alignment and unprojection of the program's own depth.
            gen = torch.Generator(device=dev).manual_seed(pseed)
            shape = (st["mdi.alignment.ransac.max_iterations"], st["mdi.alignment.ransac.sample_size"])
            for _ in range(k):  # the images before it in its call drew one set of hypotheses each
                torch.rand(shape, generator=gen, device=dev)
            idx = observed[cam]
            pts_sfm = np.zeros((m_pad, 3), np.float32)
            valid = np.zeros((m_pad,), bool)
            pts_sfm[:len(idx)] = sfm[idx]
            valid[:len(idx)] = True
            ref = P.points_from_depth(
                T(d_got), T(m_got, torch.bool), T(c2w[cam]), T(K), T(pts_sfm), T(valid, torch.bool),
                generator=gen, width=scn.width, height=scn.height,
                align_method=st["mdi.alignment.method"], ransac_iters=shape[0],
                ransac_threshold=st["mdi.alignment.ransac.inlier_threshold"], sample_size=shape[1],
                subsample_method=st["mdi.subsampling.method"], subsample_factor=st["mdi.subsampling.factor"],
                use_sfm_density_mask=st["mdi.subsampling.sfm_mask.enabled"],
            )
            calls = got["calls"][first:first + len(positions)]
            mine = calls[k]
            dd = T(d_got)
            a_ref = ref.scale * dd + ref.shift
            gaps["align_gap"] = max(gaps["align_gap"], float(
                ((mine.scale * dd + mine.shift) - a_ref).abs().max() / a_ref.abs().max().clamp(min=1e-30)))
            gaps["mask_mismatch"] = max(gaps["mask_mismatch"], float((mine.mask != ref.mask).sum()))
            kept = [float(c.valid_sfm_fraction) >= st["mdi.alignment.min_valid_sfm_fraction"] for c in calls]
            if not kept[k]:
                continue
            at = sum(int(c.mask.sum()) for c, ok in zip(calls[:k], kept[:k]) if ok)
            n = int(ref.mask.sum())
            got_pts = T(pts[at:at + n])
            got_rgb = T(rgb[at:at + n])
            want_pts = ref.pts_world[ref.mask]
            want_rgb = T(img.reshape(-1, 3)[ref.mask.cpu().numpy()].astype(np.float32) / 255.0)
            if got_pts.shape != want_pts.shape:
                gaps["points_gap"] = gaps["rgb_gap"] = float("inf")
                continue
            gaps["points_gap"] = max(gaps["points_gap"], float((got_pts - want_pts).abs().max()) / radius)
            gaps["rgb_gap"] = max(gaps["rgb_gap"], float((got_rgb - want_rgb).abs().max()))
    for name, v in gaps.items():
        limits.add(name, v, bounds[name])


def calibration(config, scn, got, sd, dev, n_train) -> dict:
    """The control's depth gap on the sampled images: the reference network
    with TF32 matmuls and convolutions against the float32 one."""
    sc, st = config["scene"], config["settings"]
    _, K, _, _ = scene_cameras(scn, sc)
    train_cams = [i for i in range(scn.n_cams) if i % sc["test_every"]]
    backbone = {"vits": "small", "vitl": "large", "vitg": "giant"}.get(st["mdi.backbone"], st["mdi.backbone"])
    net = reference_net(backbone, sd, dev)
    gap = 0.0
    for pos, positions, _, _, _ in got["chunks"]:
        for k, p in enumerate(positions):
            if pos + k not in got["sample"]:
                continue
            img = S.cast(scn, train_cams[p])[0].cpu().numpy()[None]
            d_ref, _ = M.predict(net, dev, img, [float(K[0, 0])])
            prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            d_c, _ = M.predict(net, dev, img, [float(K[0, 0])], fp32=False)
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
            gap = max(gap, float((d_c - d_ref).abs().max() / d_ref.abs().max().clamp(min=1e-30)))
    return dict(control_tf32=dict(depth_gap=gap))
