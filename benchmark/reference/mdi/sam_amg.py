"""The automatic mask generator's steps around the SAM networks, and the
region map it paints, as the port runs them (frozen copies of
``gs_init_tpu_torch/mdi/segmentation_sam.py``'s): the depth and normal
images, the network's input, the point grid, the stability scores, the
IoU and stability filters, the boxes on the valid low-res region, the greedy
box NMS, the kept masks upsampled to full size, the largest-first painting
and its postprocess (label expansion, connected components, tiny components
apart).

Departures from ``segment_anything``'s generator, which the port makes and so
this file makes too: the image is resized by ``jax.image.resize``'s
antialiased bilinear (``depthnet.common.resize``), not by PIL; the stability
score and the boxes are computed on the low-res logits (upstream upsamples
every mask first); only the masks that NMS keeps are upsampled; one crop
(the whole image), no crop NMS, no small-region postprocess.
"""
from __future__ import annotations

import numpy as np
import torch

from ..depthnet.common import resize

MASK_THRESHOLD = 0.0
_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
_STD = np.array([58.395, 57.12, 57.375], np.float32)
UNASSIGNED = 0
_VIRIDIS = np.array(
    [[0.267, 0.005, 0.329], [0.283, 0.141, 0.458], [0.254, 0.265, 0.530], [0.207, 0.372, 0.553],
     [0.164, 0.471, 0.558], [0.128, 0.567, 0.551], [0.135, 0.659, 0.518], [0.267, 0.749, 0.441],
     [0.478, 0.821, 0.318], [0.741, 0.873, 0.150], [0.993, 0.906, 0.144]], np.float32)


def viridis_rgb(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0) * (len(_VIRIDIS) - 1)
    lo = np.clip(x.astype(int), 0, len(_VIRIDIS) - 2)
    f = (x - lo)[..., None]
    return _VIRIDIS[lo] * (1 - f) + _VIRIDIS[lo + 1] * f


def depth_image(pred_depth: np.ndarray, pred_mask: np.ndarray):
    """The uint8 viridis image of the depth clamped to its 5-95% quantiles
    over the valid pixels (None when no pixel is valid)."""
    depth = np.asarray(pred_depth, np.float32).copy()
    ok = np.isfinite(depth) & np.asarray(pred_mask, bool)
    if not ok.any():
        return None
    lo, hi = np.quantile(depth[ok], [0.05, 0.95])
    depth = np.where(ok, np.clip(depth, lo, hi), lo)
    rng = depth.max() - depth.min()
    return (255.0 * viridis_rgb((depth - depth.min()) / (rng + 1e-8))).astype(np.uint8)


def normal_image(normals: np.ndarray) -> np.ndarray:
    return np.round(127.5 * (np.asarray(normals) + 1.0)).astype(np.uint8)


def network_input(image: np.ndarray, img_size: int, dev):
    """(x [1, 3, S, S]: the image resized so its long side is S, normalised
    and zero-padded at the bottom and right; its valid size (nh, nw))."""
    h, w = image.shape[:2]
    scale = img_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = torch.as_tensor(np.asarray(image, np.float32), device=dev).permute(2, 0, 1)
    x = resize(x, (nh, nw), "linear")
    x = (x - torch.as_tensor(_MEAN, device=dev)[:, None, None]) / torch.as_tensor(_STD, device=dev)[:, None, None]
    return torch.nn.functional.pad(x, (0, img_size - nw, 0, img_size - nh))[None], (nh, nw)


def point_grid(points_per_side: int, nh: int, nw: int) -> np.ndarray:
    """[P, 2] prompt pixels (x, y): cell centres of a regular grid over the
    valid region, row by row."""
    c = (np.arange(points_per_side) + 0.5) / points_per_side
    return np.stack(np.meshgrid(c * nw, c * nh, indexing="xy"), -1).reshape(-1, 2)


def stability(logits: torch.Tensor, offset: float) -> torch.Tensor:
    """Share of the pixels above -offset that are above +offset, per mask
    (logits [..., s, s])."""
    hi = (logits > MASK_THRESHOLD + offset).sum(dim=(-2, -1)).float()
    lo = (logits > MASK_THRESHOLD - offset).sum(dim=(-2, -1)).float()
    return hi / torch.clamp(lo, min=1.0)


def box_nms(boxes, iou, thresh: float):
    kept = []
    for ix in np.argsort(-iou):
        bx = boxes[ix]
        if bx is None:
            continue
        ok = True
        for jx in kept:
            bo = boxes[jx]
            inter = max(0, min(bx[2], bo[2]) - max(bx[0], bo[0]) + 1) * max(
                0, min(bx[3], bo[3]) - max(bx[1], bo[1]) + 1)
            a = (bx[2] - bx[0] + 1) * (bx[3] - bx[1] + 1)
            b = (bo[2] - bo[0] + 1) * (bo[3] - bo[1] + 1)
            if inter / (a + b - inter) > thresh:
                ok = False
                break
        if ok:
            kept.append(ix)
    return kept


def masks_from_logits(logits: torch.Tensor, iou: torch.Tensor, hw, nhw, dev, pred_iou_thresh=0.88,
                      stability_thresh=0.95, stability_offset=1.0, nms_thresh=0.7) -> list:
    """The generator's masks from its multimask logits [P, 3, s, s] and IoU
    predictions [P, 3] (tokens 1-3): filtered, NMS'd on their low-res boxes,
    upsampled and thresholded."""
    (h, w), (nh, nw) = hw, nhw
    side = logits.shape[-1]
    stab = stability(logits, stability_offset).reshape(-1).cpu().numpy()
    masks = logits.reshape(-1, side, side).cpu().numpy()
    iou = iou.reshape(-1).cpu().numpy()
    keep = (iou > pred_iou_thresh) & (stab > stability_thresh)
    masks, iou, stab = masks[keep], iou[keep], stab[keep]
    lh, lw = int(round(nh / 4)), int(round(nw / 4))
    boxes = []
    for m in masks:
        ys, xs = np.nonzero(m[:lh, :lw] > MASK_THRESHOLD)
        boxes.append((xs.min(), ys.min(), xs.max(), ys.max()) if len(xs) else None)
    out = []
    for ix in box_nms(boxes, iou, nms_thresh):
        low = torch.as_tensor(np.ascontiguousarray(masks[ix][:lh, :lw]), device=dev)
        full = (resize(low, (h, w), "linear") > MASK_THRESHOLD).cpu().numpy()
        if full.sum() == 0:
            continue
        out.append(dict(segmentation=full, area=int(full.sum())))
    return out


def paint(masks: list, shape, degenerate_thresh: float = 0.9) -> np.ndarray:
    """Largest first; a mask more than 75% inside one painted region joins it."""
    seg = np.zeros(shape, dtype=np.int64)
    cur = 1
    for ix in np.argsort([-m["area"] for m in masks]):
        region = masks[ix]["segmentation"]
        if masks[ix]["area"] / (shape[0] * shape[1]) > degenerate_thresh:
            continue
        values, counts = np.unique(seg[region], return_counts=True)
        largest = int(values[counts.argmax()])
        if counts.max() / max(region.sum(), 1) > 0.75 and largest != UNASSIGNED:
            seg[region] = largest
        else:
            seg[region] = cur
            cur += 1
    return seg


def postprocess(seg: np.ndarray, expansion_radius: int = 4, tiny_fraction: float = 1e-4) -> np.ndarray:
    """Unassigned pixels within the radius take their nearest label; the rest
    become a region per connected component; every region is split into its
    components, those under the tiny area each a region of its own."""
    from scipy import ndimage

    if expansion_radius > 0:
        dist, (iy, ix) = ndimage.distance_transform_edt(seg == UNASSIGNED, return_indices=True)
        grow = (seg == UNASSIGNED) & (dist <= expansion_radius)
        seg = seg.copy()
        seg[grow] = seg[iy[grow], ix[grow]]
    lab, n = ndimage.label(seg == UNASSIGNED)
    nxt = seg.max() + 1
    for f in range(1, n + 1):
        seg[lab == f] = nxt
        nxt += 1
    tiny = seg.shape[0] * seg.shape[1] * tiny_fraction
    out = np.zeros_like(seg)
    for label in np.unique(seg):
        if label == 0:
            continue
        lab, n = ndimage.label(seg == label)
        base = out.max() + 1
        extra = base + 1
        for f in range(1, n + 1):
            m = lab == f
            if m.sum() >= tiny:
                out[m] = base
            else:
                out[m] = extra
                extra += 1
    return out


def regions(masks_by_call: list, shape, seg) -> np.ndarray:
    """The region map of the generator calls' masks, in the port's order
    (the normal image's call first when there is one)."""
    masks = [m for call in masks_by_call for m in call]
    painted = paint(masks, shape, seg["mdi.alignment.segmentation.sam_degenerate_mask_thresh"])
    return postprocess(painted, seg["mdi.alignment.segmentation.sam_expansion_radius"],
                       seg["mdi.alignment.segmentation.sam_tiny_region_area_fraction"])
