"""Monocular-depth initialisation — port of ``gs_init_tpu/mdi/init.py``.

For every training image: predict depth (or read it from the on-disk
cache), project the image's SfM points, align the depth to their scale,
combine the masks and unproject the kept pixels to world space with their
colours. Images whose SfM points project validly below
``min_valid_sfm_fraction`` are skipped; if every image is, the init raises
``LowDepthAlignmentConfidenceError``. Then the SfM points are added
(``include_sfm_points``) and the cloud is postprocessed. With
``export_ply``, ``pts_only`` or ``pts_output_dir`` the final cloud is
written to ``<pts_output_dir or result_dir>/mdi_init_points.ply``
(``pts_only`` then exits with ``SystemExit(0)``); with
``pts_output_per_image`` each image's points go to ``mdi_<image>.ply``
there too.

The per-image alignment, masks and unprojection run on ``device`` (the
card by default) and the cloud stays there until the end; segmentation,
Delaunay interpolation and the native merge run on the host, as in the JAX
package. The cache keeps the JAX package's layout and keys
(``<cache_dir>/<predictor>/<dataset>/<image>.npz`` with ``depth``, ``mask``
and an optional ``normal``), so either package reads the other's.
"""
from __future__ import annotations

import logging
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..datasets.parser import Dataset
from ..device import generator as make_generator
from ..device import resolve_device
from ..utils.ply import write_ply_points
from .alignment.lstsqrs import weighted_scale_shift
from .alignment.pipeline import align_depth
from .points_from_depth import masks_and_unproject, points_from_depth, project_sfm_points
from .postprocess import postprocess_point_cloud
from .predictors.interface import CameraIntrinsics, pick_model

_LOGGER = logging.getLogger(__name__)


class LowDepthAlignmentConfidenceError(RuntimeError):
    pass


def _cache_path(cfg, image_name: str) -> str:
    dataset = os.path.basename(os.path.normpath(cfg.data_dir)) or "dataset"
    d = os.path.join(cfg.mdi.cache_dir, cfg.mdi.predictor, dataset)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, image_name.replace("/", "_") + ".npz")


@trace.spanned("init.predict")
def _predict_or_cached(cfg, model, items):
    """Depth, mask and normal (or None) per dataset item, through the cache."""
    preds = [None] * len(items)
    to_run = []
    for i, it in enumerate(items):
        p = _cache_path(cfg, it["image_name"])
        if cfg.mdi.use_cache and os.path.exists(p):
            try:
                with np.load(p) as data:
                    nrm = data["normal"] if "normal" in data.files else None
                    preds[i] = (data["depth"], data["mask"], nrm)
                continue
            except (OSError, ValueError, KeyError, EOFError):  # a corrupted entry
                _LOGGER.warning("corrupted depth cache entry %s; recomputing", p)
                os.unlink(p)
        to_run.append(i)
    if to_run:
        images = np.stack([items[i]["image"] for i in to_run])
        intr = [
            CameraIntrinsics(
                fx=float(items[i]["K"][0, 0]), fy=float(items[i]["K"][1, 1]),
                cx=float(items[i]["K"][0, 2]), cy=float(items[i]["K"][1, 2]),
            )
            for i in to_run
        ]
        for i, out in zip(to_run, model.predict_depth_batch(images, intr)):
            nrm = np.asarray(out.normal) if out.normal is not None else None
            preds[i] = (np.asarray(out.depth), np.asarray(out.mask), nrm)
            if cfg.mdi.use_cache:
                p = _cache_path(cfg, items[i]["image_name"])
                tmp = f"{p}.{os.getpid()}.tmp"  # another process may write the same entry
                try:
                    extra = {} if nrm is None else {"normal": nrm}
                    with open(tmp, "wb") as f:  # a handle: savez appends .npz to a path
                        np.savez(f, depth=preds[i][0], mask=preds[i][1], **extra)
                    os.replace(tmp, p)
                finally:
                    if os.path.exists(tmp):  # an interrupted write
                        os.unlink(tmp)
    return preds


@trace.spanned("init")
def pts_and_rgb_from_monocular_depth(
    cfg,
    parser,
    model=None,
    generator: Optional[torch.Generator] = None,
    device=None,
    per_image: Optional[List[dict]] = None,
    summary: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Build the initial point cloud from per-image depth predictions.

    ``generator`` (on ``device``; seeded from ``cfg.seed`` when None) draws
    the RANSAC hypotheses, image after image. ``per_image``, when given,
    receives one dict per aligned image: ``name``, ``scale``, ``shift``,
    ``points`` and ``seconds`` (synchronised), and ``stages``, the seconds
    of its stages: ``predict`` (its share of the batch's prediction), then
    on the pipeline path (segmentation or an interpolated scale) ``align``
    (``align_depth``) and ``unproject`` (masks and unprojection), else
    ``align_and_unproject`` (``points_from_depth``, one pass on the
    device); and ``align_parts``, the seconds within ``align`` of the
    segmentation (``segment``) and the region merge (``merge``), empty with
    no segmenter. On the pipeline path the scale and shift reported are a
    least-squares fit of the aligned depth on the prediction. ``summary``,
    when given, receives ``points_before`` and ``points_after`` the
    postprocess, its ``postprocess_seconds`` and its stages
    (``postprocess_point_cloud``'s timings).
    Returns (points [N, 3], colours [N, 3]), float32 numpy."""
    mdi = cfg.mdi
    dev = resolve_device(device)
    model = model or pick_model(cfg, device=dev)
    gen = generator if generator is not None else make_generator(cfg.seed, dev)
    noise_rng = np.random.default_rng(cfg.seed)  # noise_frac, as the JAX package draws it
    rbf_rng = np.random.default_rng([cfg.seed, 1])  # seeds of the max_rbf_points subsets
    trainset = Dataset(parser, "train")
    T = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x), dtype=dt, device=dev)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)

    # One SfM padding size for every image.
    m_pad = max(int(max((len(v) for v in parser.point_indices.values()), default=1)), 1)
    subsample_kw = dict(
        subsample_method=mdi.subsampling.method,
        subsample_factor=mdi.subsampling.factor,
        min_stride=mdi.subsampling.adaptive.min_stride,
        max_stride=mdi.subsampling.adaptive.max_stride,
        use_grad_mask=mdi.depth_gradient_mask,
        grad_threshold=mdi.depth_gradient_threshold,
        use_sfm_density_mask=mdi.subsampling.sfm_mask.enabled,
    )
    use_pipeline = (
        mdi.alignment.segmentation.method is not None or mdi.alignment.method == "interpolate"
    )

    all_pts, all_rgbs = [], []
    bs = max(mdi.predict_batch_size, 1)
    n_skipped = 0
    for start in range(0, len(trainset), bs):
        items = [trainset[i] for i in range(start, min(start + bs, len(trainset)))]
        trace.set_item(items[0]["image_name"])
        t_pred = time.perf_counter()
        preds = _predict_or_cached(cfg, model, items)
        t_pred = (time.perf_counter() - t_pred) / len(items)
        for it, (depth, mask, normal) in zip(items, preds):
            trace.set_item(it["image_name"])
            t0 = time.perf_counter()
            stages, parts = {"predict": t_pred}, {}
            h, w = it["image"].shape[:2]
            idx = parser.point_indices.get(it["image_name"], np.empty(0, np.int64))
            sfm = np.zeros((m_pad, 3), np.float32)
            valid = np.zeros((m_pad,), bool)
            k = min(len(idx), m_pad)
            sfm[:k] = parser.points[idx[:k]]
            valid[:k] = True
            c2w, K = T(it["camtoworld"]), T(it["K"])
            depth_t, mask_t = T(depth), T(mask, torch.bool)
            rbf_seed = int(rbf_rng.integers(2**31 - 1))

            if use_pipeline:
                pix, gt_z, ok = project_sfm_points(
                    T(sfm), T(valid, torch.bool), torch.linalg.inv(c2w), K, w, h
                )
                frac = float(ok.sum()) / max(int(valid.sum()), 1)
                if frac < mdi.alignment.min_valid_sfm_fraction:
                    n_skipped += 1
                    _LOGGER.warning(
                        "skipping %s: only %.0f%% of SfM points valid", it["image_name"], 100 * frac
                    )
                    continue
                t1 = time.perf_counter()
                with trace.span("init.align"):
                    aligned, amask = align_depth(
                        np.asarray(depth, np.float32), np.asarray(mask),
                        pix.cpu().numpy(), gt_z.cpu().numpy(), ok.cpu().numpy(), mdi.alignment,
                        generator=gen, rbf_seed=rbf_seed, device=dev, normals=normal, timings=parts,
                    )
                t2 = time.perf_counter()
                with trace.span("init.unproject"):
                    aligned_t = T(aligned)
                    world, m = masks_and_unproject(
                        aligned_t, T(amask, torch.bool), c2w, K, pix, ok,
                        width=w, height=h, **subsample_kw,
                    )
                    if per_image is not None:
                        sync()
                        stages.update(align=t2 - t1, unproject=time.perf_counter() - t2)
                s = t = None
                if per_image is not None:
                    # Zeros, not NaN, where the prediction is invalid: the fit
                    # weighs them 0, and 0 x NaN would poison its sums.
                    keep = T(amask, torch.bool)
                    zero = torch.zeros_like(depth_t)
                    s, t = weighted_scale_shift(
                        torch.where(keep, depth_t, zero).reshape(-1),
                        torch.where(keep, aligned_t, zero).reshape(-1), keep.float().reshape(-1),
                    )
            else:
                t1 = time.perf_counter()
                with trace.span("init.align_unproject"):
                    out = points_from_depth(
                        depth_t, mask_t, c2w, K, T(sfm), T(valid, torch.bool), generator=gen,
                        width=w, height=h,
                        align_method=mdi.alignment.method,
                        ransac_iters=mdi.alignment.ransac.max_iterations,
                        ransac_threshold=mdi.alignment.ransac.inlier_threshold,
                        sample_size=mdi.alignment.ransac.sample_size,
                        **subsample_kw,
                    )
                    frac = float(out.valid_sfm_fraction)
                    if per_image is not None:
                        sync()
                        stages["align_and_unproject"] = time.perf_counter() - t1
                if frac < mdi.alignment.min_valid_sfm_fraction:
                    n_skipped += 1
                    _LOGGER.warning(
                        "skipping %s: only %.0f%% of SfM points valid", it["image_name"], 100 * frac
                    )
                    continue
                world, m, s, t = out.pts_world, out.mask, out.scale, out.shift
            pts = world[m]
            rgb = T(it["image"]).reshape(-1, 3)[m]
            if mdi.noise_frac > 0:
                noise = noise_rng.normal(0, parser.scene_scale * mdi.noise_frac, (len(pts), 3))
                pts = pts + T(noise)
            all_pts.append(pts)
            all_rgbs.append(rgb)
            if mdi.pts_output_per_image:
                d = mdi.pts_output_dir or cfg.result_dir
                os.makedirs(d, exist_ok=True)
                stem = os.path.splitext(it["image_name"])[0].replace("/", "_")
                write_ply_points(os.path.join(d, f"mdi_{stem}.ply"), pts.cpu().numpy(), rgb.cpu().numpy())
            if per_image is not None:
                sync()
                per_image.append(dict(
                    name=it["image_name"], scale=float(s), shift=float(t), points=len(pts),
                    seconds=time.perf_counter() - t0, stages=stages, align_parts=parts,
                ))

    if not all_pts:
        raise LowDepthAlignmentConfidenceError(
            "every training image was skipped during depth alignment"
        )
    pts = torch.cat(all_pts).cpu().numpy().astype(np.float32)
    rgbs = torch.cat(all_rgbs).cpu().numpy().astype(np.float32)
    _LOGGER.info(
        "monocular depth init: %d points from %d images (%d skipped)",
        len(pts), len(trainset) - n_skipped, n_skipped,
    )
    if mdi.include_sfm_points:
        pts = np.concatenate([pts, parser.points.astype(np.float32)])
        rgbs = np.concatenate([rgbs, parser.points_rgb.astype(np.float32)])

    train = [parser.images[int(i)] for i in parser.split_indices("train")]
    vms = np.stack([np.linalg.inv(im.camtoworld) for im in train])
    Kmats = np.stack([im.K for im in train])
    n_before, t_post, timings = len(pts), time.perf_counter(), {}
    pts, rgbs = postprocess_point_cloud(
        cfg, pts, rgbs, vms, Kmats, [im.width for im in train], [im.height for im in train],
        device=dev, timings=timings,
    )
    if summary is not None:
        summary.update(points_before=n_before, points_after=len(pts),
                       postprocess_seconds=time.perf_counter() - t_post, postprocess=timings)
    if mdi.export_ply or mdi.pts_only or mdi.pts_output_dir:
        out_dir = mdi.pts_output_dir or cfg.result_dir
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, "mdi_init_points.ply")
        write_ply_points(out, pts, rgbs)
        _LOGGER.info("exported init point cloud to %s", out)
        if mdi.pts_only:
            raise SystemExit(0)
    return pts, rgbs
