"""The check of an init cell with Depth Pro as the depth network, on a sample
of the window's images drawn from the seed. For each sampled image:

- ``inv_gap``: the head's pre-activation (its last convolution's output,
  before the final ReLU, [1536, 1536]) of the program against the plain
  reference's (``depthnet/depth_pro.py``, the benchmark's own weights,
  float32 with TF32 off) on the same image: the largest absolute gap over
  the largest reference value. The inverse depth itself is the ReLU of it,
  so a pixel the ReLU zeroes compares nothing there;
- ``depth_gap``: the program's depth against the reference's, the largest
  gap over the largest reference depth, as ``init_check.py``'s;
- ``align_gap``, ``mask_mismatch``, ``points_gap``, ``rgb_gap``: the
  reference's alignment, masks and unprojection run on the program's depth
  against the program's, exactly, as ``init_check.py``'s.

Also printed on standard error: the share of the reference's pixels the
final ReLU zeroes, and the share of its depth held at the clip.

With ``control="tf32"`` the reference with TF32 matmuls and convolutions
stands in for the program's pre-activation and depth. ``calibrate`` also
returns the readings the limits are set from: the control's, and planted
faults' in the reference's place (``merge_no_crop``: the crop grids merged
with no overlap cropped, merge padding 0; ``hooks_swapped``: the block-5 and
block-11 features exchanged on their way to the neck).
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..harness import scene as S
from .depthnet import depth_pro as R
from .init_check import sfm_normalised
from .mdi import points_from_depth as P
from .train_check import scene_cameras

NETWORK_GAPS = ("inv_gap", "depth_gap")
EXACT = ("align_gap", "mask_mismatch", "points_gap", "rgb_gap")


def rel_gap(got, ref) -> float:
    return float((torch.as_tensor(got, device=ref.device).float() - ref).abs().max()
                 / ref.abs().max().clamp(min=1e-30))


def faulted(net, kind):
    """Undo with the returned function."""
    if kind == "merge_no_crop":
        saved = net.merge_padding_value
        net.merge_padding_value = 0
        return lambda: setattr(net, "merge_padding_value", saved)
    saved = net.hook_ids
    net.hook_ids = saved[::-1]
    return lambda: setattr(net, "hook_ids", saved)


@torch.no_grad()
def check(limits, bounds, config, scn, got, sd, pseed, dev, control=None, calibrate=False):
    """Adds the cell's numbers to ``limits``; returns the calibration
    readings when ``calibrate``."""
    sc, st = config["scene"], config["settings"]
    c2w, K, _, _ = scene_cameras(scn, sc)
    sfm = sfm_normalised(scn)
    observed = [S.observations(scn, i, S.cast(scn, i)[1], sc["sfm_visible_rtol"])[1] for i in range(scn.n_cams)]
    m_pad = max(max(len(o) for o in observed), 1)
    train_cams = [i for i in range(scn.n_cams) if i % sc["test_every"]]
    group = config["depth_pro"]
    net = R.reference_net(sd, dev, R.widths_of(group))
    size = group["input_size"]
    f_px = 0.5 * (float(K[0, 0]) + float(K[1, 1]))
    T = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x), dtype=dt, device=dev)
    gaps = {k: 0.0 for k in NETWORK_GAPS + EXACT}
    cal = dict(control_tf32={k: 0.0 for k in NETWORK_GAPS},
               faults={f: {k: 0.0 for k in NETWORK_GAPS} for f in ("merge_no_crop", "hooks_swapped")})
    radius = float(np.linalg.norm(c2w[:, :3, 3], axis=-1).max())
    up = lambda name, v, d=gaps: d.__setitem__(name, max(d[name], float(v)))
    for pos, positions, first, pts, rgb in got["chunks"]:
        for k, p in enumerate(positions):
            if pos + k not in got["sample"]:
                continue
            cam = train_cams[p]
            img = S.cast(scn, cam)[0].cpu().numpy()
            d_ref, inv_ref, pre_ref = R.predict(net, img, f_px, dev, size)
            d_got, m_got = got["depth"][pos + k]
            pre_got = got["pre"][pos + k]
            u = inv_ref * (scn.width / f_px)
            print(f"depth_pro image {pos + k}: relu_zeroed {float((pre_ref <= 0).float().mean())!r} "
                  f"at_clip {float(((u <= R.CLIP[0]) | (u >= R.CLIP[1])).float().mean())!r}", file=sys.stderr)
            if control == "tf32" or calibrate:
                d_c, _, pre_c = R.predict(net, img, f_px, dev, size, tf32=True)
                up("inv_gap", rel_gap(pre_c, pre_ref), cal["control_tf32"])
                up("depth_gap", rel_gap(d_c, d_ref), cal["control_tf32"])
                if control == "tf32":
                    pre_got, d_got = pre_c, d_c.cpu().numpy()
            if calibrate:
                for kind, readings in cal["faults"].items():
                    undo = faulted(net, kind)
                    try:
                        d_f, _, pre_f = R.predict(net, img, f_px, dev, size)
                    finally:
                        undo()
                    up("inv_gap", rel_gap(pre_f, pre_ref), readings)
                    up("depth_gap", rel_gap(d_f, d_ref), readings)
            up("inv_gap", rel_gap(pre_got, pre_ref))
            up("depth_gap", rel_gap(d_got, d_ref))
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
            dd = T(d_got)
            ref = P.points_from_depth(
                dd, T(m_got, torch.bool), T(c2w[cam]), T(K), T(pts_sfm), T(valid, torch.bool),
                generator=gen, width=scn.width, height=scn.height,
                align_method=st["mdi.alignment.method"], ransac_iters=shape[0],
                ransac_threshold=st["mdi.alignment.ransac.inlier_threshold"], sample_size=shape[1],
                subsample_method=st["mdi.subsampling.method"], subsample_factor=st["mdi.subsampling.factor"],
                use_sfm_density_mask=st["mdi.subsampling.sfm_mask.enabled"],
            )
            calls = got["calls"][first:first + len(positions)]
            mine = calls[k]
            a_ref = ref.scale * dd + ref.shift
            up("align_gap", rel_gap(mine.scale * dd + mine.shift, a_ref))
            up("mask_mismatch", (mine.mask != ref.mask).sum())
            kept = [float(c.valid_sfm_fraction) >= st["mdi.alignment.min_valid_sfm_fraction"] for c in calls]
            if not kept[k]:
                continue
            at = sum(int(c.mask.sum()) for c, ok in zip(calls[:k], kept[:k]) if ok)
            n = int(ref.mask.sum())
            got_pts, got_rgb = T(pts[at:at + n]), T(rgb[at:at + n])
            want_pts = ref.pts_world[ref.mask]
            want_rgb = T(img.reshape(-1, 3)[ref.mask.cpu().numpy()].astype(np.float32) / 255.0)
            if got_pts.shape != want_pts.shape:
                gaps["points_gap"] = gaps["rgb_gap"] = float("inf")
                continue
            if n == 0:
                continue
            up("points_gap", (got_pts - want_pts).abs().max() / radius)
            up("rgb_gap", (got_rgb - want_rgb).abs().max())
    for name, v in gaps.items():
        limits.add(name, v, bounds[name])
    return cal if calibrate else None
