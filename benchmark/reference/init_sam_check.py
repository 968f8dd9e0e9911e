"""The check of an init cell with SAM regions, on a sample of the window's
images drawn from the seed. For each sampled image:

- ``depth_gap``, ``normal_gap``: the program's predicted depth (over the
  largest reference depth) and normals (unit vectors, absolute) against
  the reference Metric3D's (``depthnet/metric3d.py``) on the same image;
- ``sam_embed_gap``: both generator calls' image embeddings against the
  reference encoder (``depthnet/sam.py``) on the network input that the
  reference makes (``mdi/sam_amg.py``) from the program's depth and normals;
- ``sam_logit_gap``, ``sam_iou_gap``: every low-res logit map and IoU
  prediction of each call (1,024 prompts, tokens 1-3) against the reference
  decoder run on the program's embedding; each gap over the largest
  reference value of its call;
- ``regions_mismatch``: pixels where the reference's filters, NMS,
  upsampling, painting and postprocess on the program's logits give another
  label than the program's segmentation, plus those where the reference's
  merge of the program's segmentation differs from the program's merged
  regions; must be 0;
- ``align_gap``, ``mask_mismatch``, ``points_gap``, ``rgb_gap``: the
  reference's per-region RANSAC (``mdi/regions.py``) on the program's depth
  and segmentation, from the program's generator state at that image, then
  its masks and unprojection, against the program's aligned depth, its mask,
  its points in the returned cloud and their colours; exact.

With ``control="tf32"`` each network output of the program (depth, normals,
embeddings, logits and IoU) is replaced by the reference's own with TF32
matmuls and convolutions on the same inputs: the control has to come out not
correct. ``calibrate`` also returns the readings the limits are set from: the
control's, and planted faults' (``rel_pos_zero``: the first global block's
relative positions zeroed; ``token0``: the single-mask token's logits and IoU
in place of tokens 1-3; ``no_filter``: the reference's steps with the IoU
and stability filters off; ``no_filter_no_expansion``: the same without the
label expansion of the postprocess).
"""
from __future__ import annotations

import numpy as np
import torch

from ..harness import scene as S
from .depthnet import metric3d as M
from .depthnet import sam as SAM
from .init_check import reference_net, sfm_normalised
from .mdi import points_from_depth as P
from .mdi import regions as R
from .mdi import sam_amg as A
from .train_check import scene_cameras

SEG = "mdi.alignment.segmentation."
NETWORK_GAPS = ("depth_gap", "normal_gap", "sam_embed_gap", "sam_logit_gap", "sam_iou_gap")
EXACT = ("regions_mismatch", "align_gap", "mask_mismatch", "points_gap", "rgb_gap")


def reference_sam(settings: dict, sd: dict, dev) -> SAM.SamNet:
    with torch.device("meta"):
        net = SAM.SamNet(img_size=settings[SEG + "sam_img_size"], **SAM.VARIANTS[settings[SEG + "sam_variant"]])
    net = net.to_empty(device=dev)
    net.load_state_dict(sd)
    return net.eval().requires_grad_(False)


def metric3d(net, dev, img: np.ndarray, fx: float, tf32: bool = False):
    """(depth [H, W], unit normals [H, W, 3]) of one uint8 image, as the
    port's predictor returns them."""
    h, w = img.shape[:2]
    ch, cw = M.CROP
    scale = min(cw / w, ch / h)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    with SAM.matmul_precision(tf32):
        depth, _, normal = M._forward(net, dev, img[None], nh, nw, (ch - nh) // 2, (cw - nw) // 2, fp32=not tf32)
    d = torch.clamp(depth[0] * (fx * scale / M.CANONICAL_FOCAL), *M.CLIP_RANGE)
    return d, normal[0, ..., :3]


def rel_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.float() - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


def amg_settings(amg: dict) -> dict:
    """The configuration's ``amg`` group as ``sam_amg.masks_from_logits`` takes it."""
    return dict(pred_iou_thresh=amg["pred_iou_thresh"], stability_thresh=amg["stability_score_thresh"],
                stability_offset=amg["stability_offset"], nms_thresh=amg["box_nms_thresh"])


@torch.inference_mode()
def check(limits, bounds, config, scn, got, sd, sam_sd, dev, control=None, calibrate=False):
    """Adds the cell's numbers to ``limits``; returns the calibration
    readings when ``calibrate``."""
    sc, st = config["scene"], config["settings"]
    c2w, K, _, _ = scene_cameras(scn, sc)
    sfm = sfm_normalised(scn)
    observed = [S.observations(scn, i, S.cast(scn, i)[1], sc["sfm_visible_rtol"])[1] for i in range(scn.n_cams)]
    m_pad = max(max(len(o) for o in observed), 1)
    train_cams = [i for i in range(scn.n_cams) if i % sc["test_every"]]
    backbone = {"vits": "small", "vitl": "large", "vitg": "giant"}.get(st["mdi.backbone"], st["mdi.backbone"])
    net = reference_net(backbone, sd, dev)
    sam = reference_sam(st, sam_sd, dev)
    amg = amg_settings(config["amg"])
    T = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x), dtype=dt, device=dev)
    gaps = {k: 0.0 for k in NETWORK_GAPS + EXACT}
    cal = dict(control_tf32={k: 0.0 for k in NETWORK_GAPS},
               faults=dict(rel_pos_zero=dict(sam_embed_gap=0.0), token0=dict(sam_logit_gap=0.0, sam_iou_gap=0.0),
                           no_filter=dict(regions_mismatch=0.0), no_filter_no_expansion=dict(regions_mismatch=0.0)))
    radius = float(np.linalg.norm(c2w[:, :3, 3], axis=-1).max())
    up = lambda name, v, d=gaps: d.__setitem__(name, max(d[name], float(v)))
    for pos in got["sample"]:
        im = got["images"][pos]
        cam = train_cams[im["position"]]
        img = S.cast(scn, cam)[0].cpu().numpy()
        d_ref, n_ref = metric3d(net, dev, img, float(K[0, 0]))
        d_got, n_got = T(im["depth"]), T(im["normal"])
        idx = observed[cam]
        pts_sfm = np.zeros((m_pad, 3), np.float32)
        valid = np.zeros((m_pad,), bool)
        pts_sfm[:len(idx)] = sfm[idx]
        valid[:len(idx)] = True
        cw_ = T(c2w[cam])
        pix, gt_z, ok = P.project_sfm_points(T(pts_sfm), T(valid, torch.bool), torch.linalg.inv(cw_), T(K),
                                             scn.width, scn.height)
        if control == "tf32" or calibrate:
            d_c, n_c = metric3d(net, dev, img, float(K[0, 0]), tf32=True)
            up("depth_gap", rel_gap(d_c, d_ref), cal["control_tf32"])
            up("normal_gap", (n_c - n_ref).abs().max(), cal["control_tf32"])
            if control == "tf32":
                d_got, n_got = d_c, n_c
        up("depth_gap", rel_gap(d_got, d_ref))
        up("normal_gap", (n_got - n_ref).abs().max())
        if "segment" not in im:  # the program skipped the image: too few SfM points in its frame
            if float(ok.sum()) / max(len(idx), 1) >= st["mdi.alignment.min_valid_sfm_fraction"]:
                gaps["points_gap"] = gaps["rgb_gap"] = float("inf")
            continue

        # The generator's calls, in the port's order: the depth image, then
        # the normal image.
        h, w = im["depth"].shape
        rgbs = [A.depth_image(im["depth"], im["mask"])]
        if st[SEG + "sam_use_normals"] and im["normal"] is not None:
            rgbs.append(A.normal_image(im["normal"]))
        if len(im["sam"]) != len(rgbs):
            raise RuntimeError(f"{len(im['sam'])} generator calls recorded for {len(rgbs)} images")
        masks_by_call, no_filter = [], []
        for rgb, call in zip(rgbs, im["sam"]):
            x, nhw = A.network_input(rgb, st[SEG + "sam_img_size"], dev)
            e_ref = sam.encode(x)
            e_got, l_got, q_got = call["embed"], call["logits"], call["iou"]
            xy = T(A.point_grid(config["amg"]["points_per_side"], *nhw))
            if control == "tf32" or calibrate:
                e_c = sam.encode(x, tf32=True)
                up("sam_embed_gap", rel_gap(e_c, e_ref), cal["control_tf32"])
                l_c, q_c = sam.decode(e_c, xy, tf32=True)
                l_r, q_r = sam.decode(e_c, xy)  # the reference on the control's own embedding
                up("sam_logit_gap", rel_gap(l_c[:, 1:], l_r[:, 1:]), cal["control_tf32"])
                up("sam_iou_gap", rel_gap(q_c[:, 1:], q_r[:, 1:]), cal["control_tf32"])
                del l_r
                if control == "tf32":
                    e_got, l_got, q_got = e_c, l_c[:, 1:], q_c[:, 1:]
                del l_c
            up("sam_embed_gap", rel_gap(e_got, e_ref))
            l_ref, q_ref = sam.decode(e_got, xy)
            up("sam_logit_gap", rel_gap(l_got, l_ref[:, 1:]))
            up("sam_iou_gap", rel_gap(q_got, q_ref[:, 1:]))
            if calibrate:
                f = cal["faults"]
                first = sam.image_encoder.blocks[SAM.VARIANTS[st[SEG + "sam_variant"]]["global_attn_indexes"][0]].attn
                saved = first.rel_pos_h.clone(), first.rel_pos_w.clone()
                first.rel_pos_h.zero_()
                first.rel_pos_w.zero_()
                up("sam_embed_gap", rel_gap(sam.encode(x), e_ref), f["rel_pos_zero"])
                first.rel_pos_h.copy_(saved[0])
                first.rel_pos_w.copy_(saved[1])
                up("sam_logit_gap", rel_gap(l_ref[:, :1].expand(-1, 3, -1, -1), l_ref[:, 1:]), f["token0"])
                up("sam_iou_gap", rel_gap(q_ref[:, :1].expand(-1, 3), q_ref[:, 1:]), f["token0"])
                no_filter.append(A.masks_from_logits(l_got, q_got, (h, w), nhw, dev, **dict(
                    amg, pred_iou_thresh=-np.inf, stability_thresh=-np.inf)))
            del l_ref
            masks_by_call.append(A.masks_from_logits(l_got, q_got, (h, w), nhw, dev, **amg))
        # The port paints the normal image's masks before the depth image's.
        seg_ref = A.regions(masks_by_call[::-1], (h, w), st)
        mismatch = int((seg_ref != im["segment"]).sum())
        if calibrate:
            f = cal["faults"]
            up("regions_mismatch", (A.regions(no_filter[::-1], (h, w), st) != im["segment"]).sum(), f["no_filter"])
            bare = dict(st, **{SEG + "sam_expansion_radius": 0})
            up("regions_mismatch", (A.regions(no_filter[::-1], (h, w), bare) != im["segment"]).sum(),
               f["no_filter_no_expansion"])

        # The program's depth and segmentation through the reference's
        # region-wise alignment, masks and unprojection.
        gen = torch.Generator(device=dev)
        gen.set_state(im["gen_state"])
        merged, aligned, amask, _ = R.align_regions(
            np.asarray(im["depth"], np.float32), np.asarray(im["mask"]), im["segment"], pix.cpu().numpy(),
            gt_z.cpu().numpy(), ok.cpu().numpy(), st, gen, dev)
        up("regions_mismatch", mismatch + int((merged != im["merged"]).sum()))
        a_ref = T(aligned)
        up("align_gap", rel_gap(T(im["aligned"]), a_ref))
        world, m_ref = P.masks_and_unproject(
            a_ref, T(amask, torch.bool), cw_, T(K), pix, ok, width=scn.width, height=scn.height,
            subsample_method=st["mdi.subsampling.method"], subsample_factor=st["mdi.subsampling.factor"],
            use_sfm_density_mask=st["mdi.subsampling.sfm_mask.enabled"])
        up("mask_mismatch", (im["m"] != m_ref).sum())
        call = got["calls"][im["call"]]
        at = sum(int(n) for q, n in call["order"] if q < pos)
        n = int(m_ref.sum())
        got_pts, got_rgb = T(call["pts"][at:at + n]), T(call["rgb"][at:at + n])
        want_rgb = T(img.reshape(-1, 3)[m_ref.cpu().numpy()].astype(np.float32) / 255.0)
        if got_pts.shape[0] != n:
            gaps["points_gap"] = gaps["rgb_gap"] = float("inf")
            continue
        if n == 0:
            continue
        up("points_gap", (got_pts - world[m_ref]).abs().max() / radius)
        up("rgb_gap", (got_rgb - want_rgb).abs().max())
    for name, v in gaps.items():
        limits.add(name, v, bounds[name])
    return cal if calibrate else None
