"""Results tables from sweep outputs — port of
``gs_init_tpu/evaluation/tables.py``: collect the eval stats of every
(scene, preset) run, with train-time scalars read back from its TensorBoard
event files, and print markdown or LaTeX tables with the best value of
each column in bold.

    python -m gs_init_tpu_torch.evaluation.tables --output_root results/sweep --metrics psnr ssim
"""
from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, List, Optional, Sequence

from ..utils.tb import read_scalars

METRICS = ["psnr", "ssim", "lpips", "cc_psnr", "num_GS", "ellipse_time"]
HIGHER_BETTER = {
    "psnr": True, "ssim": True, "lpips": False, "cc_psnr": True,
    "tb_train/loss": False, "tb_train/mem_peak_gb": False,
}

# Train-time scalars merged into the rows from the TensorBoard event files.
DEFAULT_TB_TAGS = ["train/num_GS", "train/loss", "train/mem_peak_gb"]


def read_tb_scalars(
    run_dir: str, tags: Optional[Sequence[str]] = None, step: Optional[int] = None
) -> Dict[str, float]:
    """``{tag: value}`` from a run's ``tb/`` event files: the value at
    ``step`` if given (exact match), else the last one logged. Missing tags
    are absent; a missing or corrupt event file gives an empty dict."""
    tb_dir = os.path.join(run_dir, "tb")
    if not os.path.isdir(tb_dir):
        return {}
    try:
        scalars = read_scalars(tb_dir)
    except (OSError, ValueError, IndexError, UnicodeDecodeError):
        return {}
    out: Dict[str, float] = {}
    for tag in tags or list(scalars):
        vals = scalars.get(tag)
        if not vals:
            continue
        if step is None:
            out[tag] = vals[-1][1]
        else:
            for s, v in vals:
                if s == step:
                    out[tag] = v
                    break
    return out


def collect_results(
    output_root: str, step: Optional[int] = None, tb_tags: Optional[Sequence[str]] = DEFAULT_TB_TAGS
) -> List[dict]:
    """Rows from ``<output_root>/<scene>/<preset>_<runid>/stats/val_step*.json``
    (the latest step per (scene, preset), or ``step``), each with the
    ``tb_tags`` as ``tb_<tag>`` columns when given."""
    rows = []
    tb_cache: Dict[str, Dict[str, float]] = {}
    for stats_path in glob.glob(os.path.join(output_root, "*", "*", "stats", "val_step*.json")):
        m = re.search(r"val_step(\d+)\.json$", stats_path)
        if not m:
            continue
        run_dir = os.path.dirname(os.path.dirname(stats_path))
        scene = os.path.basename(os.path.dirname(run_dir))
        preset = re.sub(r"_[0-9a-f]{12}$", "", os.path.basename(run_dir))
        if tb_tags and run_dir not in tb_cache:
            tb_cache[run_dir] = {f"tb_{k}": v for k, v in read_tb_scalars(run_dir, tb_tags).items()}
        with open(stats_path) as f:
            stats = json.load(f)
        rows.append(dict(scene=scene, preset=preset, step=int(m.group(1)), **stats, **tb_cache.get(run_dir, {})))
    if step is not None:
        return [r for r in rows if r["step"] == step]
    latest: Dict[tuple, dict] = {}
    for r in rows:
        k = (r["scene"], r["preset"])
        if k not in latest or r["step"] > latest[k]["step"]:
            latest[k] = r
    return list(latest.values())


def make_table(rows: List[dict], metric: str = "psnr", fmt: str = "markdown", decimals: int = 3) -> str:
    """One row per preset, one column per scene and their average; the best
    value of each column in bold."""
    scenes = sorted({r["scene"] for r in rows})
    presets = sorted({r["preset"] for r in rows})
    values: Dict[str, Dict[str, float]] = {p: {} for p in presets}
    for r in rows:
        if metric in r:
            values[r["preset"]][r["scene"]] = float(r[metric])
    for p in presets:
        vals = [values[p][s] for s in scenes if s in values[p]]
        if vals:
            values[p]["__avg__"] = sum(vals) / len(vals)

    cols = scenes + ["__avg__"]
    best: Dict[str, float] = {}
    hb = HIGHER_BETTER.get(metric, True)
    for c in cols:
        col_vals = [values[p][c] for p in presets if c in values[p]]
        if col_vals:
            best[c] = max(col_vals) if hb else min(col_vals)

    def cell(p, c):
        if c not in values[p]:
            return "-"
        v = values[p][c]
        s = f"{v:.{decimals}f}"
        if c in best and abs(v - best[c]) < 10 ** (-decimals) / 2:
            s = f"**{s}**" if fmt == "markdown" else rf"\textbf{{{s}}}"
        return s

    header = ["preset"] + scenes + ["avg"]
    if fmt == "markdown":
        lines = ["| " + " | ".join(header) + " |", "|" + "|".join(["---"] * len(header)) + "|"]
        lines += ["| " + " | ".join([p] + [cell(p, c) for c in cols]) + " |" for p in presets]
        return "\n".join(lines)
    if fmt == "latex":
        lines = [r"\begin{tabular}{l" + "r" * len(cols) + "}", " & ".join(header) + r" \\ \hline"]
        lines += [" & ".join([p] + [cell(p, c) for c in cols]) + r" \\" for p in presets]
        lines.append(r"\end{tabular}")
        return "\n".join(lines)
    raise ValueError(f"unknown format {fmt!r}")


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="make results tables")
    ap.add_argument("--output_root", required=True)
    ap.add_argument("--metrics", nargs="+", default=["psnr", "ssim"])
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--format", default="markdown", choices=["markdown", "latex"])
    ns = ap.parse_args(argv)
    rows = collect_results(ns.output_root, ns.step)
    for metric in ns.metrics:
        print(f"\n## {metric}\n")
        print(make_table(rows, metric, ns.format))


if __name__ == "__main__":
    main()
