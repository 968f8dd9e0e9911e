"""Minimal dataclass CLI: presets + dot-path overrides — the port's own
copy of ``gs_init_tpu/config/cli.py``.

    python -m gs_init_tpu_torch.trainer default --data_dir ... --mdi.predictor=stub
    python -m gs_init_tpu_torch.trainer mcmc --strategy.cap_max=3700000

Typed casting through dataclass field introspection; ``REFERENCE_ALIASES``
translates the reference CLI's spellings, so overrides written for it work
verbatim.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, List, Optional, Sequence, Tuple


def _cast_value(tp, value: str):
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if origin is typing.Union:
        errs = []
        for a in args:
            if a is type(None):
                if value.lower() in ("none", "null"):
                    return None
                continue
            try:
                return _cast_value(a, value)
            except (ValueError, TypeError) as e:  # try next union member
                errs.append(e)
        raise ValueError(f"cannot cast {value!r} to {tp}: {errs}")
    if origin is typing.Literal:
        for a in args:
            if str(a) == value:
                return a
            try:
                if type(a)(value) == a:
                    return a
            except (ValueError, TypeError):
                pass
        raise ValueError(f"{value!r} not in literal {args}")
    if origin in (list, List):
        items = [v for v in value.strip("[]").split(",") if v != ""]
        return [_cast_value(args[0] if args else str, v.strip()) for v in items]
    if origin in (tuple, Tuple):
        items = [v for v in value.strip("()[]").split(",") if v != ""]
        if args and args[-1] is Ellipsis:
            return tuple(_cast_value(args[0], v.strip()) for v in items)
        return tuple(_cast_value(a, v.strip()) for a, v in zip(args, items))
    if tp is bool or tp == "bool":
        if value.lower() in ("true", "1", "yes", "on"):
            return True
        if value.lower() in ("false", "0", "no", "off"):
            return False
        raise ValueError(f"bad bool {value!r}")
    if tp is int:
        return int(value)
    if tp is float:
        return float(value)
    if tp is str:
        return value
    if tp is object or tp is Any:
        return value
    if dataclasses.is_dataclass(tp):
        raise ValueError(f"cannot assign scalar to dataclass field {tp}")
    return tp(value)


def _field_type(obj, name: str):
    for f in dataclasses.fields(obj):
        if f.name == name:
            tp = f.type
            if isinstance(tp, str):
                # Resolve postponed annotations against the module namespace.
                import sys

                mod = sys.modules[type(obj).__module__]
                tp = eval(tp, vars(typing) | vars(mod) | {"typing": typing})  # noqa: S307
            return tp
    raise AttributeError(f"{type(obj).__name__} has no field {name!r}")


# Reference-flag compatibility: a user of the reference
# (deivse/3dgs_monocular_depth_init) can keep their CLI overrides verbatim.
# Maps reference dot-paths to ours; values are either a target path (same
# value) or a callable (path, value) -> list[(path, value)] for renamed
# values / inverted booleans / split knobs.
def _subsample_factor(_, v):
    if v == "adaptive":
        return [("mdi.subsampling.method", "adaptive")]
    return [("mdi.subsampling.method", "static"), ("mdi.subsampling.factor", v)]


def _grad_mask_thresh(_, v):
    if v.lower() in ("none", "null"):
        return [("mdi.depth_gradient_mask", "false")]
    return [
        ("mdi.depth_gradient_mask", "true"),
        ("mdi.depth_gradient_threshold", v),
    ]


def _limit_init_scale(_, v):
    on = v.lower() in ("true", "1", "yes", "on")
    return [("mdi.scale_clamp_quantile", "0.75" if on else "0.0")]


def _noise_frac(_, v):
    if v.lower() in ("none", "null"):
        return [("mdi.noise_frac", "0.0")]
    return [("mdi.noise_frac", v)]


def _aligner(_, v):
    return [("mdi.alignment.method", {"interp": "interpolate"}.get(v, v))]


def _interp_method(_, v):
    return [("mdi.alignment.interp.method", {"linear": "delaunay"}.get(v, v))]


REFERENCE_ALIASES = {
    "random_background": "random_bkgd",
    "save_final_ply": "save_ply",
    "mdi.subsample_factor": _subsample_factor,
    "mdi.ignore_cache": lambda _, v: [
        ("mdi.use_cache",
         "false" if v.lower() in ("true", "1", "yes", "on") else "true")
    ],
    "mdi.noise_std_scene_frac": _noise_frac,
    "mdi.depth_grad_mask_thresh": _grad_mask_thresh,
    "mdi.limit_init_scale": _limit_init_scale,
    "mdi.init_scale_clamp_quantile": "mdi.scale_clamp_quantile",
    "mdi.use_num_sfm_points_mask": "mdi.subsampling.sfm_mask.enabled",
    "mdi.num_sfm_points_mask.num_patches_small_axis":
        "mdi.subsampling.sfm_mask.patches_per_image_side",
    "mdi.num_sfm_points_mask.threshold":
        "mdi.subsampling.sfm_mask.max_sfm_points_per_patch",
    "mdi.adaptive_subsampling.factor_range_min":
        "mdi.subsampling.adaptive.min_stride",
    "mdi.adaptive_subsampling.factor_range_max":
        "mdi.subsampling.adaptive.max_stride",
    "mdi.alignment.aligner": _aligner,
    "mdi.alignment.segmenter": "mdi.alignment.segmentation.method",
    "mdi.alignment.interp.method": _interp_method,
    "mdi.alignment.interp.init": "mdi.alignment.interp.prealign",
    "mdi.alignment.ransac.max_iters": "mdi.alignment.ransac.max_iterations",
    "mdi.alignment.segmentation.min_border_grad_threshold":
        "mdi.alignment.segmentation.merge_gradient_threshold",
    "mdi.alignment.segmentation.min_sfm_pts_in_region":
        "mdi.alignment.segmentation.merge_min_sfm_points",
    "mdi.alignment.segmentation.sam.use_normals":
        "mdi.alignment.segmentation.sam_use_normals",
    "mdi.alignment.segmentation.sam.degenerate_mask_thresh":
        "mdi.alignment.segmentation.sam_degenerate_mask_thresh",
    "mdi.alignment.segmentation.sam.expansion_radius":
        "mdi.alignment.segmentation.sam_expansion_radius",
    "mdi.alignment.segmentation.sam.tiny_region_area_fraction":
        "mdi.alignment.segmentation.sam_tiny_region_area_fraction",
    "mdi.alignment.segmentation.slic.num_regions":
        "mdi.alignment.segmentation.slic_n_segments",
    "mdi.alignment.segmentation.slic.compactness":
        "mdi.alignment.segmentation.slic_compactness",
    "mdi.postprocess.outlier_removal": lambda _, v: [
        ("mdi.postprocess.lof_outlier_removal",
         "true" if v == "lof" else "false")
    ],
    "mdi.postprocess.lof_num_neighbors": "mdi.postprocess.lof_neighbors",
    "mdi.postprocess.subsample": "mdi.postprocess.merge_subsample",
    "mdi.metric3d.backbone": "mdi.backbone",
    "mdi.depthanything.backbone": "mdi.backbone",
    "mdi.depthanything.metric": "mdi.metric",
    "mdi.depthanything.metric_model_type": "mdi.metric_variant",
    "mdi.alignment.ransac.min_iters": "mdi.alignment.ransac.min_iterations",
    "mdi.postprocess.subsample_params.max_bbox_aspect_ratio":
        "mdi.postprocess.merge_max_aspect_ratio",
    "mdi.postprocess.subsample_params.min_extent_multiplier":
        "mdi.postprocess.merge_extent_multiplier",
    "mdi.moge.backbone": "mdi.backbone",
    "mdi.unidepth.backbone": "mdi.backbone",
}


def set_by_path(cfg, path: str, value: str) -> None:
    """Set ``cfg.a.b.c = cast(value)`` given dot path ``a.b.c``.

    Reference-spelled paths (REFERENCE_ALIASES) are translated first, so
    overrides written for the reference CLI keep working verbatim.
    """
    alias = REFERENCE_ALIASES.get(path)
    if alias is not None:
        if callable(alias):
            # Alias results are canonical paths — set them directly (an
            # alias may legitimately emit its own spelling, e.g. the
            # interp.method value rename; re-translating would recurse).
            for p, v in alias(path, value):
                _set_canonical(cfg, p, v)
            return
        path = alias
    _set_canonical(cfg, path, value)


def _set_canonical(cfg, path: str, value: str) -> None:
    parts = path.split(".")
    obj = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    tp = _field_type(obj, parts[-1])
    setattr(obj, parts[-1], _cast_value(tp, value))


def apply_overrides(cfg, overrides: Dict[str, str]):
    for k, v in overrides.items():
        set_by_path(cfg, k, v)
    return cfg


def parse_cli(
    argv: Sequence[str],
    presets: Dict[str, Any],
    default_preset: Optional[str] = None,
):
    """Parse ``[preset] --key=value --key value ...`` into a config object."""
    argv = list(argv)
    preset = default_preset
    if argv and not argv[0].startswith("-"):
        preset = argv.pop(0)
    if preset is None or preset not in presets:
        raise SystemExit(
            f"usage: <preset> [--key=value ...]; presets: {sorted(presets)}"
        )
    import copy

    cfg = copy.deepcopy(presets[preset])
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise SystemExit(f"unexpected argument {arg!r}")
        key = arg[2:]
        if "=" in key:
            key, value = key.split("=", 1)
        else:
            if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                i += 1
                value = argv[i]
            else:
                value = "true"  # bare flag
        set_by_path(cfg, key.replace("-", "_"), value)
        i += 1
    return cfg
