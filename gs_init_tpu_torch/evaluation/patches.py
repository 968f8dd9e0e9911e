"""Per-patch evaluation metrics — port of
``gs_init_tpu/evaluation/patches.py``: each saved eval canvas
(``renders/val_<step>_<view>.png``, gt | render side by side) is split into
a patch grid, PSNR and SSIM are taken per patch, and the grids become
markdown tables and, on request, heatmap PNGs.

    python -m gs_init_tpu_torch.evaluation.patches --result_dir results/garden [--heatmaps]
"""
from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..datasets.png import read_png
from ..ops.ssim import psnr, ssim


def split_canvas(canvas: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """gt | render side-by-side canvas -> (gt, render), float in [0, 1]."""
    w = canvas.shape[1] // 2
    img = canvas.astype(np.float32) / (255.0 if canvas.dtype == np.uint8 else 1.0)
    return img[:, :w], img[:, w : 2 * w]


def patch_metrics(gt: np.ndarray, render: np.ndarray, grid: Tuple[int, int] = (4, 6)) -> Dict[str, np.ndarray]:
    """Per-patch PSNR and SSIM grids [gy, gx] (SSIM NaN for patches under
    11 pixels on a side)."""
    gy, gx = grid
    h, w = gt.shape[:2]
    ph, pw = h // gy, w // gx
    out_psnr = np.zeros((gy, gx))
    out_ssim = np.zeros((gy, gx))
    for i in range(gy):
        for j in range(gx):
            a = torch.as_tensor(gt[i * ph : (i + 1) * ph, j * pw : (j + 1) * pw])
            b = torch.as_tensor(render[i * ph : (i + 1) * ph, j * pw : (j + 1) * pw])
            out_psnr[i, j] = float(psnr(b, a))
            out_ssim[i, j] = float(ssim(b[None], a[None])) if min(ph, pw) >= 11 else np.nan
    return {"psnr": out_psnr, "ssim": out_ssim}


def patch_table(grid_vals: np.ndarray, decimals: int = 2) -> str:
    gy, gx = grid_vals.shape
    lines = ["| |" + "|".join(f" c{j} " for j in range(gx)) + "|", "|" + "---|" * (gx + 1)]
    for i in range(gy):
        row = [f"r{i}"] + [("-" if np.isnan(v) else f"{v:.{decimals}f}") for v in grid_vals[i]]
        lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)


def save_heatmap(grid_vals: np.ndarray, path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    im = ax.imshow(grid_vals, cmap="viridis")
    for (i, j), v in np.ndenumerate(grid_vals):
        if not np.isnan(v):
            ax.text(j, i, f"{v:.1f}", ha="center", va="center", fontsize=7, color="white")
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def analyze_renders(result_dir: str, grid: Tuple[int, int] = (4, 6), stage: str = "val") -> List[dict]:
    """Per-patch metrics for every saved eval canvas of a result dir."""
    rows = []
    for path in sorted(glob.glob(os.path.join(result_dir, "renders", f"{stage}_*.png"))):
        m = re.search(rf"{stage}_(\d+)_(\d+)\.png$", path)
        if not m:
            continue
        gt, render = split_canvas(read_png(path))
        rows.append(dict(step=int(m.group(1)), view=int(m.group(2)), path=path, **patch_metrics(gt, render, grid)))
    return rows


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="per-patch metric tables")
    ap.add_argument("--result_dir", required=True)
    ap.add_argument("--grid", nargs=2, type=int, default=[4, 6])
    ap.add_argument("--heatmaps", action="store_true")
    ns = ap.parse_args(argv)
    for r in analyze_renders(ns.result_dir, tuple(ns.grid)):
        print(f"\n### step {r['step']} view {r['view']} — patch PSNR\n")
        print(patch_table(r["psnr"]))
        if ns.heatmaps:
            out = r["path"].replace(".png", "_patch_psnr.png")
            save_heatmap(r["psnr"], out)
            print(f"(heatmap: {out})")


if __name__ == "__main__":
    main()
