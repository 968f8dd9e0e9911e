"""SAM depth segmentation: automatic mask generation and overlap-aware
region assignment — port of ``gs_init_tpu/mdi/segmentation_sam.py``.

The predicted depth is clamped to its 5-95% quantiles over the valid
pixels, colour-mapped (viridis) to RGB and run through the automatic mask
generator: a 32x32 grid of point prompts in batches of 64, multimask
output, the IoU and stability filters, a greedy box NMS on the host. With
``sam_use_normals`` the normal map is segmented too. The masks are painted
into a region map largest first, a mask that lies more than 75% inside an
existing region merging into it; then the labels are expanded, the
unassigned pixels split into connected components and tiny components
separated.

The networks run on ``device`` (the card by default); the resizes are
``models.common.resize``, which reproduces ``jax.image.resize``. Filtering,
NMS and painting are numpy, once per image at init. Without a checkpoint
(``sam_vit_*`` under ``$GS_TPU_CHECKPOINT_DIR`` or ``~/.cache/gs_init_tpu``)
the generator raises unless random weights are allowed.
"""
from __future__ import annotations

import functools
import logging
import os
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.common import build, full_fp32, resize
from ..models.sam import Sam, init_random_sam_
from .predictors.sam_convert import SAM_VARIANTS, load_sam_state_dict

_LOGGER = logging.getLogger(__name__)

MASK_THRESHOLD = 0.0
_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
_STD = np.array([58.395, 57.12, 57.375], np.float32)
UNASSIGNED = 0


def viridis_rgb(x: np.ndarray) -> np.ndarray:
    """Viridis from 11 anchors with linear interpolation (the JAX package's
    stand-in for matplotlib's colormap)."""
    anchors = np.array(
        [
            [0.267, 0.005, 0.329],
            [0.283, 0.141, 0.458],
            [0.254, 0.265, 0.530],
            [0.207, 0.372, 0.553],
            [0.164, 0.471, 0.558],
            [0.128, 0.567, 0.551],
            [0.135, 0.659, 0.518],
            [0.267, 0.749, 0.441],
            [0.478, 0.821, 0.318],
            [0.741, 0.873, 0.150],
            [0.993, 0.906, 0.144],
        ],
        np.float32,
    )
    x = np.clip(x, 0.0, 1.0) * (len(anchors) - 1)
    lo = np.clip(x.astype(int), 0, len(anchors) - 2)
    f = (x - lo)[..., None]
    return anchors[lo] * (1 - f) + anchors[lo + 1] * f


def find_sam_checkpoint(variant: str) -> Optional[str]:
    for d in [os.environ.get("GS_TPU_CHECKPOINT_DIR", ""), os.path.expanduser("~/.cache/gs_init_tpu")]:
        if d and os.path.isdir(d):
            for n in sorted(os.listdir(d)):
                if "sam" in n.lower() and variant.replace("_", "") in n.replace("_", ""):
                    return os.path.join(d, n)
    return None


def _box_nms(boxes, iou, thresh: float):
    """Greedy NMS over inclusive pixel boxes (None for an empty mask), in
    order of falling IoU prediction; returns the kept indices."""
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


class SamMaskGenerator:
    """The automatic mask generator around ``models.sam.Sam``."""

    def __init__(
        self,
        variant: str = "vit_h",
        checkpoint: Optional[str] = None,
        points_per_side: int = 32,
        points_per_batch: int = 64,
        pred_iou_thresh: float = 0.88,
        stability_score_thresh: float = 0.95,
        stability_offset: float = 1.0,
        box_nms_thresh: float = 0.7,
        img_size: int = 1024,
        allow_random_weights: bool = False,
        device: DeviceLike = None,
    ):
        self.img_size = img_size
        self.points_per_side = points_per_side
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_offset = stability_offset
        self.box_nms_thresh = box_nms_thresh
        self.device = resolve_device(device)
        ckpt = checkpoint or find_sam_checkpoint(variant)
        if ckpt is None and not allow_random_weights:
            raise FileNotFoundError(
                "No SAM checkpoint found. Place sam_vit_h_4b8939.pth (or another "
                "official sam_vit_* file) under $GS_TPU_CHECKPOINT_DIR or "
                "~/.cache/gs_init_tpu, or set sam_allow_random_weights for "
                "pipeline testing."
            )
        self.net = build(Sam, img_size=img_size, **SAM_VARIANTS[variant])
        if ckpt is not None:
            from .predictors.depth_anything_v2 import load_checkpoint_file

            load_sam_state_dict(self.net, load_checkpoint_file(ckpt))
            _LOGGER.info("SAM weights loaded from %s", ckpt)
        else:
            init_random_sam_(self.net, 0)
            _LOGGER.warning("SAM running with RANDOM weights (explicitly allowed): masks are not meaningful")
        self.net.to(self.device).eval()

    @torch.inference_mode()
    def generate(self, image_rgb: np.ndarray) -> list:
        """image_rgb: [H, W, 3] uint8 or float. Returns a list of dicts with
        ``segmentation`` [H, W] bool, ``area``, ``predicted_iou`` and
        ``stability_score``."""
        dev, net, S = self.device, self.net, self.img_size
        h, w = image_rgb.shape[:2]
        scale = S / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        x = torch.as_tensor(np.asarray(image_rgb, np.float32), device=dev).permute(2, 0, 1)
        x = resize(x, (nh, nw), "bilinear")
        x = (x - torch.as_tensor(_MEAN, device=dev)[:, None, None]) / torch.as_tensor(_STD, device=dev)[:, None, None]
        x = torch.nn.functional.pad(x, (0, S - nw, 0, S - nh))
        with full_fp32():
            embed = net.image_encoder(x[None])
            dense_pe = net.prompt_encoder.dense_pe()

        # The point grid over the valid (unpadded) region.
        pps = self.points_per_side
        gx = (np.arange(pps) + 0.5) / pps * nw
        gy = (np.arange(pps) + 0.5) / pps * nh
        pts = np.stack(np.meshgrid(gx, gy, indexing="xy"), -1).reshape(-1, 2)

        out_masks, out_iou, out_stab = [], [], []
        bsz = self.points_per_batch
        t, o = MASK_THRESHOLD, self.stability_offset
        for i in range(0, len(pts), bsz):
            batch = pts[i : i + bsz]
            pb = np.pad(batch, ((0, bsz - len(batch)), (0, 0)))
            points = torch.as_tensor(pb, dtype=torch.float32, device=dev)[:, None, :]
            # A padding not-a-point (label -1) after each point prompt, as
            # segment_anything's prompt encoder appends without a box.
            points = torch.cat([points, torch.zeros_like(points)], dim=1)
            labels = torch.tensor([[1, -1]] * bsz, dtype=torch.int32, device=dev)
            with full_fp32():
                sparse, no_mask = net.prompt_encoder(points, labels)
                masks, iou = net.mask_decoder(embed, dense_pe, sparse, no_mask)
            # Multimask output: tokens 1..3, not the single-mask token 0.
            masks, iou = masks[: len(batch), 1:], iou[: len(batch), 1:]
            hi = (masks > t + o).sum(dim=(-2, -1)).float()
            lo = (masks > t - o).sum(dim=(-2, -1)).float()
            out_masks.append(masks.cpu().numpy())
            out_iou.append(iou.cpu().numpy())
            out_stab.append((hi / torch.clamp(lo, min=1.0)).cpu().numpy())

        side = S // 16 * 4
        masks = np.concatenate(out_masks).reshape(-1, side, side)
        iou = np.concatenate(out_iou).reshape(-1)
        stab = np.concatenate(out_stab).reshape(-1)
        keep = (iou > self.pred_iou_thresh) & (stab > self.stability_score_thresh)
        masks, iou, stab = masks[keep], iou[keep], stab[keep]

        lh, lw = int(round(nh / 4)), int(round(nw / 4))  # the valid region at low resolution
        boxes = []
        for m in masks:
            ys, xs = np.nonzero(m[:lh, :lw] > MASK_THRESHOLD)
            boxes.append((xs.min(), ys.min(), xs.max(), ys.max()) if len(xs) else None)
        results = []
        for ix in _box_nms(boxes, iou, self.box_nms_thresh):
            low = torch.as_tensor(np.ascontiguousarray(masks[ix][:lh, :lw]), device=dev)
            full = (resize(low, (h, w), "bilinear") > MASK_THRESHOLD).cpu().numpy()
            area = int(full.sum())
            if area == 0:
                continue
            results.append(dict(segmentation=full, area=area, predicted_iou=float(iou[ix]),
                                stability_score=float(stab[ix])))
        return results


def create_segmentation(masks: list, image_shape, degenerate_mask_thresh: float = 0.9) -> np.ndarray:
    """Largest-first mask painting; a mask more than 75% inside one
    existing region merges into it."""
    order = np.argsort([-m["area"] for m in masks])
    seg = np.zeros(image_shape, dtype=np.int64)
    image_area = image_shape[0] * image_shape[1]
    cur = 1
    for ix in order:
        region = masks[ix]["segmentation"]
        if masks[ix]["area"] / image_area > degenerate_mask_thresh:
            continue
        values, counts = np.unique(seg[region], return_counts=True)
        largest = int(values[counts.argmax()])
        overlap = counts.max() / max(region.sum(), 1)
        if overlap > 0.75 and largest != UNASSIGNED:
            seg[region] = largest
        else:
            seg[region] = cur
            cur += 1
    return seg


def postprocess_segmentation(
    seg: np.ndarray, expansion_radius: int = 4, tiny_region_area_fraction: float = 1e-4
) -> np.ndarray:
    """Label expansion, then connected-component splitting."""
    from scipy import ndimage

    if expansion_radius > 0:
        # Each unassigned pixel within the radius takes its nearest label.
        dist, (iy, ix) = ndimage.distance_transform_edt(seg == UNASSIGNED, return_indices=True)
        grow = (seg == UNASSIGNED) & (dist <= expansion_radius)
        seg = seg.copy()
        seg[grow] = seg[iy[grow], ix[grow]]

    lab, n = ndimage.label(seg == UNASSIGNED)
    nxt = seg.max() + 1
    for f in range(1, n + 1):
        seg[lab == f] = nxt
        nxt += 1

    tiny = seg.shape[0] * seg.shape[1] * tiny_region_area_fraction
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


@functools.lru_cache(maxsize=1)
def _cached_generator(variant: str, allow_random: bool, img_size: int, device: str,
                      checkpoint: Optional[str]) -> SamMaskGenerator:
    return SamMaskGenerator(variant=variant, checkpoint=checkpoint, allow_random_weights=allow_random,
                            img_size=img_size, device=device)


def segment_depth_sam(
    pred_depth: np.ndarray,
    pred_mask: np.ndarray,
    normals: Optional[np.ndarray],
    seg_cfg,
    allow_random_weights: bool = False,
    device: DeviceLike = None,
) -> np.ndarray:
    """Quantile-clamped normalised depth -> viridis RGB -> masks (and the
    normal image's, with ``sam_use_normals``) -> overlap assignment ->
    expansion and components. Returns int labels [H, W]; all 0 when no
    pixel is valid."""
    depth = np.asarray(pred_depth, np.float32).copy()
    # Non-finite depth at masked pixels (a predictor's sky) stays out of
    # the quantiles and is pinned to the window's floor.
    ok = np.isfinite(depth) & np.asarray(pred_mask, bool)
    if not ok.any():
        return np.zeros(depth.shape, np.int32)
    lo, hi = np.quantile(depth[ok], [0.05, 0.95])
    depth = np.where(ok, np.clip(depth, lo, hi), lo)
    rng = depth.max() - depth.min()
    depth_norm = (depth - depth.min()) / (rng + 1e-8)

    gen = _cached_generator(seg_cfg.sam_variant, allow_random_weights, seg_cfg.sam_img_size,
                            str(resolve_device(device)), find_sam_checkpoint(seg_cfg.sam_variant))
    rgb = (255.0 * viridis_rgb(depth_norm)).astype(np.uint8)
    masks = gen.generate(rgb)
    if seg_cfg.sam_use_normals and normals is not None:
        nrgb = np.round(127.5 * (np.asarray(normals) + 1.0)).astype(np.uint8)
        masks = gen.generate(nrgb) + masks
    seg = create_segmentation(masks, depth.shape, seg_cfg.sam_degenerate_mask_thresh)
    return postprocess_segmentation(
        seg, expansion_radius=seg_cfg.sam_expansion_radius,
        tiny_region_area_fraction=seg_cfg.sam_tiny_region_area_fraction,
    )
