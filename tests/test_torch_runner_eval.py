"""``Runner.eval`` computes its metrics on the Runner's device from the
render's tensors; only the saved canvases and the numbers reach the host.

Held here against a host recomputation: each val view rendered again
through ``Runner.render`` (its numpy contract) and scored with the port's
PSNR, SSIM, colour-corrected PSNR and LPIPS on CPU tensors; the means equal
eval's stats within 1e-6 relative. The saved canvases hold the ground
truth and those renders as 8-bit PNG.
"""
import json
import os

import numpy as np
import pytest
import torch

import gs_init_tpu_torch.ops.lpips as PL
from gs_init_tpu_torch.config import Config
from gs_init_tpu_torch.datasets.png import read_png
from gs_init_tpu_torch.datasets.synthetic import make_scene, write_colmap_scene
from gs_init_tpu_torch.engine.appearance import color_correct
from gs_init_tpu_torch.engine.runner import Runner
from gs_init_tpu_torch.ops.ssim import psnr, ssim
from test_torch_lpips import _weights, _write

RTOL = 1e-6


def test_eval_stats_match_a_host_recomputation(tmp_path, monkeypatch):
    sc = make_scene(n_gaussians=48, n_cams=8, width=64, height=48, device="cpu")
    data_dir = write_colmap_scene(str(tmp_path / "scene"), sc, n_points=48)
    (tmp_path / "lpips").mkdir()
    _write(tmp_path / "lpips", "npz", *_weights())
    monkeypatch.setenv("GS_TPU_CHECKPOINT_DIR", str(tmp_path / "lpips"))
    PL._load_params.cache_clear()
    try:
        cfg = Config(data_dir=data_dir, data_factor=1, result_dir=str(tmp_path / "run"), max_steps=10,
                     eval_steps=[], save_steps=[], test_every=4, sh_degree=1, max_gaussians=64,
                     pair_capacity=1 << 14, mesh="off", data_prefetch=0, use_bilateral_grid=True,
                     save_predictions=True)
        r = Runner(cfg, device="cpu")
        for step in range(cfg.max_steps):
            r.train_iteration(step)
        stats = r.eval(cfg.max_steps)
        want = {k: [] for k in ("psnr", "ssim", "cc_psnr", "lpips")}
        for i in range(len(r.valset)):
            item = r.valset[i]
            h, w = item["image"].shape[:2]
            color, _, _ = r.render(item["camtoworld"], item["K"], w, h, render_mode="RGB")
            c, gt = torch.as_tensor(color)[None], torch.as_tensor(item["image"])[None]
            want["psnr"].append(float(psnr(c, gt)))
            want["ssim"].append(float(ssim(c, gt)))
            want["cc_psnr"].append(float(psnr(color_correct(c, gt), gt)))
            want["lpips"].append(float(PL.lpips(c, gt)))
            canvas = read_png(os.path.join(cfg.result_dir, "renders", f"val_{cfg.max_steps}_{i:03d}.png"))
            np.testing.assert_array_equal(canvas, (np.concatenate([item["image"], color], 1) * 255).astype(np.uint8))
    finally:
        PL._load_params.cache_clear()
    assert len(r.valset) >= 2
    for k, v in want.items():
        assert stats[k] == pytest.approx(float(np.mean(v)), rel=RTOL), k
    with open(os.path.join(cfg.result_dir, "stats", f"val_step{cfg.max_steps}.json")) as f:
        assert json.load(f) == stats
