"""Evaluation sweep orchestrator, a scene x config grid runner — port of
``gs_init_tpu/evaluation/sweep.py``.

Config strings such as

    "{default,mcmc} --mdi.predictor={depth_anything_v2,stub}"
    "default --mdi.alignment.method=[ALL]"

expand to the cartesian product of presets and dot-path overrides ([ALL]
enumerates a Literal field's members). Each (scene, combination) becomes a
``python -m gs_init_tpu_torch.trainer`` subprocess with a deterministic run
id: SHA-1 over the same JSON as the JAX package's, so a sweep started by
either package is resumed by the other. Completed runs (a matching run-id
stamp) are skipped, stale outputs are backed up, SLURM array tasks split
the grid, and MCMC runs get per-scene gaussian caps. ``evaluate_run``
rescores the saved renders (PNG, read with ``datasets/png.py``) with the
port's PSNR, SSIM and, when weights exist, LPIPS.

    python -m gs_init_tpu_torch.evaluation.sweep --data_root data/360_v2 \
        --scenes garden room --configs "{default,mcmc}" --output_root results/sweep --evaluate
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import typing
from typing import Dict, List, Optional, Sequence, Tuple

from ..config import Config

# Per-scene MCMC gaussian caps.
MCMC_SCENE_CAPS = {
    "garden": 6_000_000,
    "bicycle": 6_100_000,
    "stump": 4_750_000,
    "bonsai": 4_800_000,
    "counter": 4_000_000,
    "kitchen": 4_400_000,
    "room": 3_700_000,
    "treehill": 5_200_000,
    "flowers": 5_300_000,
}

ParamList = Tuple[Tuple[str, str], ...]


def all_values_of_param(name: str) -> List[str]:
    """Enumerate a Literal config field's members by dot path."""
    cur = Config
    for part in name.replace("-", "_").split("."):
        hints = typing.get_type_hints(cur)
        if part not in hints:
            raise AttributeError(f"no config field {name!r} (at {part!r})")
        cur = hints[part]
    origin = typing.get_origin(cur)
    if origin is typing.Union:
        args = [a for a in typing.get_args(cur) if a is not type(None)]
        if len(args) == 1:
            cur = args[0]
            origin = typing.get_origin(cur)
    if origin is typing.Literal:
        vals = [str(v) for v in typing.get_args(cur)]
        if not vals:
            raise RuntimeError(f"empty literal for {name}")
        return vals
    raise ValueError(f"cannot enumerate values of {name}: {cur}")


def _split_top_level(s: str) -> List[str]:
    parts, cur, depth = [], "", 0
    for ch in s:
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
        if ch == " " and depth == 0:
            if cur:
                parts.append(cur)
            cur = ""
        else:
            cur += ch
    if cur:
        parts.append(cur)
    return parts


def parse_config_string(config_str: str) -> List[ParamList]:
    """Expand a grid string to a list of (key, value) combination tuples.

    The first token may be a brace set of presets: "{default,mcmc}" or a
    bare preset name; remaining tokens are --key={v1,v2}, --key=value, or
    --key=[ALL].
    """
    parts = _split_top_level(config_str.strip())
    if not parts:
        raise ValueError("empty config string")
    axes: List[List[Tuple[str, str]]] = []

    first = parts[0]
    if not first.startswith("-"):
        presets = (
            [v.strip() for v in first[1:-1].split(",")]
            if first.startswith("{")
            else [first]
        )
        axes.append([("__preset__", p) for p in presets])
        parts = parts[1:]

    for part in parts:
        if "=" not in part:
            raise ValueError(f"expected key=value in {part!r}")
        key, value = part.split("=", 1)
        key = key.lstrip("-")
        if value == "[ALL]":
            vals = all_values_of_param(key)
        elif value.startswith("{"):
            if not value.endswith("}"):
                raise ValueError(f"unclosed brace in {part!r}")
            vals = [v.strip() for v in value[1:-1].split(",") if v.strip()]
        else:
            vals = [value]
        axes.append([(key, v) for v in vals])
    combos = sorted(set(itertools.product(*axes)))
    return [tuple(c) for c in combos]


def run_id_of(scene: str, combo: ParamList) -> str:
    blob = json.dumps([scene, list(combo)], sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def combo_name(combo: ParamList) -> str:
    parts = []
    for k, v in combo:
        if k == "__preset__":
            parts.append(v)
        else:
            parts.append(f"{k.split('.')[-1]}={v}")
    return "_".join(parts).replace("/", "-")


@dataclasses.dataclass
class SweepRun:
    scene: str
    combo: ParamList
    run_id: str
    out_dir: str
    done: bool = False


def backup_stale_dir(out_dir: str, output_root: str) -> str:
    """Move a stale/mismatched run dir into ``<output_root>_backup/``.

    Mirrors the reference's rename_old_dir_with_timestamp
    (nerfbaselines_evaluator.py:53-76): the backup name carries the
    last-edit timestamp of the directory's contents, and the backup tree
    preserves the run's path relative to the output root — nothing is ever
    silently retrained over in place.
    """
    import datetime

    mtimes = [
        os.path.getmtime(os.path.join(r, f))
        for r, _, fs in os.walk(out_dir)
        for f in fs
    ]
    last = max(mtimes, default=os.path.getmtime(out_dir))
    ts = datetime.datetime.fromtimestamp(last).strftime("_%d-%m-%Y_%H-%M-%S")
    rel = os.path.relpath(out_dir, output_root)
    dst = os.path.join(
        os.path.dirname(output_root.rstrip(os.sep)) or ".",
        os.path.basename(output_root.rstrip(os.sep)) + "_backup",
        os.path.dirname(rel),
        os.path.basename(rel) + ts,
    )
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    if os.path.exists(dst):  # same-second collision: uniquify
        i = 1
        while os.path.exists(f"{dst}.{i}"):
            i += 1
        dst = f"{dst}.{i}"
    shutil.move(out_dir, dst)
    return dst


def _run_is_done(out_dir: str, rid: str) -> bool:
    """Completed = a matching run-id stamp, the final stats and a val-stats
    file for every configured eval step (a missing per-step result forces
    a rerun, not only a missing final one)."""
    stamp = os.path.join(out_dir, "run_id.json")
    if not os.path.exists(stamp):
        return False
    try:
        with open(stamp) as f:
            if json.load(f)["run_id"] != rid:
                return False
        if not os.path.exists(os.path.join(out_dir, "stats", "train_final.json")):
            return False
        cfg_path = os.path.join(out_dir, "cfg.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
            for s in cfg.get("eval_steps", []):
                if not os.path.exists(os.path.join(out_dir, "stats", f"val_step{s}.json")):
                    return False
        return True
    except (OSError, ValueError, KeyError, TypeError):
        return False


def plan_sweep(
    data_root: str,
    scenes: Sequence[str],
    config_strings: Sequence[str],
    output_root: str,
    force_overwrite: bool = False,
) -> List[SweepRun]:
    runs = []
    for cfg_str in config_strings:
        for combo in parse_config_string(cfg_str):
            for scene in scenes:
                rid = run_id_of(scene, combo)
                out = os.path.join(
                    output_root, scene, f"{combo_name(combo)}_{rid}"
                )
                done = not force_overwrite and _run_is_done(out, rid)
                if os.path.exists(out) and not done:
                    dst = backup_stale_dir(out, output_root)
                    print(f"[sweep] stale output backed up: {out} -> {dst}")
                runs.append(
                    SweepRun(
                        scene=scene, combo=combo, run_id=rid, out_dir=out,
                        done=done,
                    )
                )
    return runs


def shard_for_slurm(runs: List[SweepRun]) -> List[SweepRun]:
    """Filter the run list to this SLURM array shard (reference :703-741)."""
    tid = os.environ.get("SLURM_ARRAY_TASK_ID")
    cnt = os.environ.get("SLURM_ARRAY_TASK_COUNT")
    if tid is None or cnt is None:
        return runs
    tid, cnt = int(tid), int(cnt)
    return [r for i, r in enumerate(runs) if i % cnt == tid]


def train_command(run: SweepRun, data_root: str, extra: Sequence[str] = ()):
    preset = "default"
    args = []
    for k, v in run.combo:
        if k == "__preset__":
            preset = v
        else:
            args.append(f"--{k}={v}")
    if preset == "mcmc" and run.scene in MCMC_SCENE_CAPS and not any(
        a.startswith("--strategy.cap_max") for a in args
    ):
        args.append(f"--strategy.cap_max={MCMC_SCENE_CAPS[run.scene]}")
    return [
        sys.executable,
        "-m",
        "gs_init_tpu_torch.trainer",
        preset,
        f"--data_dir={os.path.join(data_root, run.scene)}",
        f"--result_dir={run.out_dir}",
        *args,
        *extra,
    ]


def evaluate_run(out_dir: str, step: Optional[int] = None, device=None) -> Dict[str, float]:
    """Recompute the metrics from the SAVED renders (``renders/val_{step}_*.png``,
    gt | render canvases), independently of what the training process
    reported, and write them to ``results-{step}.json``. ``step`` defaults
    to the last of the run's ``eval_steps``; the scores run on ``device``
    (the card by default)."""
    import glob

    import numpy as np
    import torch

    from ..datasets.png import read_png
    from ..device import resolve_device
    from ..ops.lpips import lpips, lpips_available
    from ..ops.ssim import psnr, ssim
    from .patches import split_canvas

    dev = resolve_device(device)
    if step is None:
        with open(os.path.join(out_dir, "cfg.json")) as f:
            cfg = json.load(f)
        step = max(cfg["eval_steps"]) if cfg.get("eval_steps") else None
        if step is None:
            raise ValueError(f"no eval steps recorded in {out_dir}/cfg.json")
    paths = sorted(glob.glob(os.path.join(out_dir, "renders", f"val_{step}_*.png")))
    if not paths:
        raise FileNotFoundError(
            f"no saved predictions renders/val_{step}_*.png in {out_dir} "
            "(train with save_predictions=True)"
        )
    use_lpips = lpips_available()
    per_image: List[Dict[str, float]] = []
    for p in paths:
        gt, render = (torch.as_tensor(a, device=dev) for a in split_canvas(read_png(p)))
        m = {"psnr": float(psnr(render, gt)), "ssim": float(ssim(render[None], gt[None]))}
        if use_lpips:
            m["lpips"] = float(lpips(render[None], gt[None]))
        per_image.append(m)
    results = {
        "step": step,
        "n_images": len(per_image),
        "metrics": {k: float(np.mean([m[k] for m in per_image])) for k in per_image[0]},
        "per_image": per_image,
    }
    out_path = os.path.join(out_dir, f"results-{step}.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"[sweep] evaluate: {out_path} " + " ".join(f"{k}={v:.4f}" for k, v in results["metrics"].items()))
    return results["metrics"]


def prune_run(out_dir: str, keep_fraction_steps: int = 2) -> None:
    """Delete heavy outputs after a finished run to save disk.

    Mirrors the reference's post-train cleanup (nerfbaselines_evaluator.py:
    649-662): keep the final splat export and final checkpoint, drop
    intermediate checkpoints, and keep prediction canvases only for the
    first and last eval step (the reference keeps {0, 8000, 14000, final}).
    Stats, TB logs, and results-*.json are always kept.
    """
    import glob

    # Checkpoints: keep only the highest step.
    ckpts = sorted(
        glob.glob(os.path.join(out_dir, "ckpts", "ckpt_*.npz")),
        key=lambda p: int(re.search(r"ckpt_(\d+)", p).group(1)),
    )
    for p in ckpts[:-1]:
        os.remove(p)
    # Prediction canvases: keep first + last eval step only.
    steps = sorted(
        {
            int(m.group(1))
            for p in glob.glob(os.path.join(out_dir, "renders", "val_*_*.png"))
            if (m := re.search(r"val_(\d+)_\d+\.png$", p))
        }
    )
    keep = set(steps[:1] + steps[-1:])
    for s in steps:
        if s in keep:
            continue
        for p in glob.glob(os.path.join(out_dir, "renders", f"val_{s}_*.png")):
            os.remove(p)


def execute_sweep(
    data_root: str,
    scenes: Sequence[str],
    config_strings: Sequence[str],
    output_root: str,
    extra_args: Sequence[str] = (),
    dry_run: bool = False,
    force_overwrite: bool = False,
    evaluate: bool = False,
    prune: bool = False,
) -> List[SweepRun]:
    runs = shard_for_slurm(
        plan_sweep(
            data_root, scenes, config_strings, output_root,
            force_overwrite=force_overwrite,
        )
    )
    for run in runs:
        if run.done:
            print(f"[sweep] skip (done): {run.out_dir}")
        else:
            cmd = train_command(run, data_root, extra_args)
            print(f"[sweep] run: {' '.join(cmd)}")
            if dry_run:
                continue
            os.makedirs(run.out_dir, exist_ok=True)
            with open(os.path.join(run.out_dir, "run_id.json"), "w") as f:
                json.dump({"run_id": run.run_id, "combo": list(run.combo)}, f)
            res = subprocess.run(cmd)
            if res.returncode != 0:
                print(f"[sweep] FAILED ({res.returncode}): {run.out_dir}")
                continue
            run.done = True
        if evaluate and not dry_run:
            try:
                evaluate_run(run.out_dir)
            except (OSError, ValueError) as e:
                print(f"[sweep] evaluate FAILED: {run.out_dir}: {e}")
        if prune and not dry_run:
            prune_run(run.out_dir)
    return runs


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="scene x config sweep")
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--scenes", nargs="+", required=True)
    ap.add_argument("--configs", nargs="+", required=True)
    ap.add_argument("--output_root", required=True)
    ap.add_argument("--dry_run", action="store_true")
    ap.add_argument("--force_overwrite", action="store_true",
                    help="retrain even over completed matching outputs")
    ap.add_argument("--evaluate", action="store_true",
                    help="recompute metrics from saved renders after each run")
    ap.add_argument("--prune", action="store_true",
                    help="delete heavy intermediate outputs after each run")
    # Single string, shlex-split (argparse would eat leading-dash items).
    ap.add_argument("--extra", default="", help="extra trainer flags, quoted")
    ns = ap.parse_args(argv)
    import shlex

    execute_sweep(
        ns.data_root, ns.scenes, ns.configs, ns.output_root,
        extra_args=shlex.split(ns.extra), dry_run=ns.dry_run,
        force_overwrite=ns.force_overwrite, evaluate=ns.evaluate,
        prune=ns.prune,
    )


if __name__ == "__main__":
    main()
