"""The check of an init cell whose depth comes from the stub predictor, on a
sample of the window's images drawn from the seed: the reference's RANSAC
(the same generator, seeded as the port seeds it and advanced by the images
before it in its call), masks and unprojection (``mdi/``) on the program's
depth, against the program's

- ``align_gap``: aligned depth (the largest gap over its largest value);
- ``mask_mismatch``: kept pixels;
- ``points_gap``: points in the returned cloud (over the camera ring's
  radius in the normalised world);
- ``rgb_gap``: their colours against the scene's own pixels;

each exact. The stub's depth itself is the configuration's affine map of the
scene's ray-cast depth, which the harness hands the port.
"""
from __future__ import annotations

import numpy as np
import torch

from ..harness import scene as S
from .init_check import sfm_normalised
from .mdi import points_from_depth as P
from .train_check import scene_cameras

GAPS = ("align_gap", "mask_mismatch", "points_gap", "rgb_gap")


@torch.inference_mode()
def check(limits, bounds, config, scn, got, pseed, dev):
    sc, st = config["scene"], config["settings"]
    c2w, K, _, _ = scene_cameras(scn, sc)
    sfm = sfm_normalised(scn)
    observed = [S.observations(scn, i, S.cast(scn, i)[1], sc["sfm_visible_rtol"])[1] for i in range(scn.n_cams)]
    m_pad = max(max(len(o) for o in observed), 1)
    train_cams = [i for i in range(scn.n_cams) if i % sc["test_every"]]
    T = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x), dtype=dt, device=dev)
    gaps = {k: 0.0 for k in GAPS}
    radius = float(np.linalg.norm(c2w[:, :3, 3], axis=-1).max())
    shape = (st["mdi.alignment.ransac.max_iterations"], st["mdi.alignment.ransac.sample_size"])
    for pos in got["sample"]:
        im = got["images"][pos]
        call = got["calls"][im["call"]]
        cam = train_cams[im["position"]]
        img = S.cast(scn, cam)[0].cpu().numpy()
        k = im["index"]  # the image's place in its call
        gen = torch.Generator(device=dev).manual_seed(pseed)
        for _ in range(k):  # the images before it in its call drew one set of hypotheses each
            torch.rand(shape, generator=gen, device=dev)
        idx = observed[cam]
        pts_sfm = np.zeros((m_pad, 3), np.float32)
        valid = np.zeros((m_pad,), bool)
        pts_sfm[:len(idx)] = sfm[idx]
        valid[:len(idx)] = True
        d = im["depth"]  # the program's tensors, on the device
        ref = P.points_from_depth(
            d, im["mask"], T(c2w[cam]), T(K), T(pts_sfm), T(valid, torch.bool),
            generator=gen, width=scn.width, height=scn.height, align_method=st["mdi.alignment.method"],
            ransac_iters=shape[0], ransac_threshold=st["mdi.alignment.ransac.inlier_threshold"],
            sample_size=shape[1], subsample_method=st["mdi.subsampling.method"],
            subsample_factor=st["mdi.subsampling.factor"],
            use_sfm_density_mask=st["mdi.subsampling.sfm_mask.enabled"],
        )
        mine = im["out"]
        a_ref = ref.scale * d + ref.shift
        a_got = mine.scale * d + mine.shift
        # The stub's depth is NaN where a ray meets nothing: NaN against NaN
        # is no gap, NaN against a number is.
        diff = torch.where(torch.isnan(a_got) & torch.isnan(a_ref), 0.0, (a_got - a_ref).abs())
        gaps["align_gap"] = max(gaps["align_gap"], float(
            diff.max() / torch.nan_to_num(a_ref, nan=0.0).abs().max().clamp(min=1e-30)))
        gaps["mask_mismatch"] = max(gaps["mask_mismatch"], float((mine.mask != ref.mask).sum()))
        kept = float(ref.valid_sfm_fraction) >= st["mdi.alignment.min_valid_sfm_fraction"]
        if kept != (float(mine.valid_sfm_fraction) >= st["mdi.alignment.min_valid_sfm_fraction"]):
            gaps["points_gap"] = gaps["rgb_gap"] = float("inf")
            continue
        if not kept:
            continue
        at = sum(int(n) for q, n in call["order"] if q < pos)
        n = int(ref.mask.sum())
        got_pts, got_rgb = T(call["pts"][at:at + n]), T(call["rgb"][at:at + n])
        if got_pts.shape[0] != n:
            gaps["points_gap"] = gaps["rgb_gap"] = float("inf")
            continue
        if n == 0:
            continue
        want_rgb = T(img.reshape(-1, 3)[ref.mask.cpu().numpy()].astype(np.float32) / 255.0)
        gaps["points_gap"] = max(gaps["points_gap"], float((got_pts - ref.pts_world[ref.mask]).abs().max()) / radius)
        gaps["rgb_gap"] = max(gaps["rgb_gap"], float((got_rgb - want_rgb).abs().max()))
    for name, v in gaps.items():
        limits.add(name, v, bounds[name])
