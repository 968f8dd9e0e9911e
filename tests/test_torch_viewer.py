"""The port's live viewer (``gs_init_tpu_torch/viewer.py``) during CPU
training: the HTTP server attaches to a running Runner and serves PNG
renders of the current parameters between train iterations, equal to
``Runner.render`` at the same camera; ``/status`` follows the step;
``train()`` starts it unless ``disable_viewer``; renders and steps share
the Runner's lock. The twin is tests/test_viewer_live.py.
"""
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from gs_init_tpu_torch.config import Config, DefaultStrategyConfig
from gs_init_tpu_torch.datasets.png import decode_png
from gs_init_tpu_torch.datasets.synthetic import make_scene, write_colmap_scene
from gs_init_tpu_torch.engine.runner import Runner
from torch_parity import n


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    sc = make_scene(n_gaussians=60, n_cams=6, width=48, height=32, device="cpu")
    return write_colmap_scene(str(tmp_path_factory.mktemp("viewer")), sc, n_points=48)


def _cfg(scene_dir, tmp_path, **kw):
    return Config(
        data_dir=scene_dir, data_factor=1, result_dir=str(tmp_path / "results"), max_steps=4,
        eval_steps=[], save_steps=[], sh_degree=1, max_gaussians=128, pair_capacity=1 << 12,
        tb_every=100, disable_viewer=False, port=0, data_prefetch=0,
        strategy=DefaultStrategyConfig(refine_start_iter=10_000), **kw,
    )


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def test_live_viewer_mid_training(scene_dir, tmp_path):
    runner = Runner(_cfg(scene_dir, tmp_path), device="cpu")
    port = runner.start_viewer()
    try:
        assert port and port > 0
        for step in range(2):
            runner.train_step = step
            runner.train_iteration(step)
        status, ctype, body = _get(port, "/status")
        assert status == 200 and "json" in ctype
        st = json.loads(body)
        assert st["step"] == 1 and st["num_GS"] > 0

        status, ctype, body = _get(port, "/render?yaw=0.3&pitch=0.1&radius=1.2&w=48&h=32")
        assert status == 200 and ctype == "image/png"
        img = decode_png(body)
        c2w, K = runner.viewer.camera(0.3, 0.1, 1.2, 48, 32)
        color, _, _ = runner.render(c2w, K, 48, 32, render_mode="RGB")
        np.testing.assert_array_equal(img, (np.clip(color, 0, 1) * 255).astype(np.uint8))
        assert img.shape == (32, 48, 3) and img.max() > 0

        before = n(runner.gstate.params.means).copy()
        for step in range(2, 4):
            runner.train_step = step
            runner.train_iteration(step)
        assert not np.allclose(before, n(runner.gstate.params.means))
        status, _, body = _get(port, "/")
        assert status == 200 and b"orbit" in body
        with pytest.raises(urllib.error.HTTPError):
            _get(port, "/nope")
    finally:
        runner.viewer.stop()


def test_train_autostarts_viewer(scene_dir, tmp_path):
    runner = Runner(_cfg(scene_dir, tmp_path), device="cpu")
    runner.train()
    try:
        assert runner.viewer is not None and runner.viewer.port > 0
        status, _, body = _get(runner.viewer.port, "/status")
        assert status == 200 and json.loads(body)["step"] == 3
    finally:
        runner.viewer.stop()
    cfg = _cfg(scene_dir, tmp_path)
    cfg.disable_viewer = True
    quiet = Runner(cfg, device="cpu")
    quiet.train()
    assert quiet.viewer is None


def test_renders_wait_for_the_step(scene_dir, tmp_path):
    """A render requested while a train iteration holds the lock is served
    after the step, never from half-updated parameters."""
    runner = Runner(_cfg(scene_dir, tmp_path), device="cpu")
    port = runner.start_viewer()
    try:
        got = {}
        with runner.lock:
            th = threading.Thread(target=lambda: got.setdefault("r", _get(port, "/render?w=48&h=32")))
            th.start()
            th.join(timeout=1.0)
            assert th.is_alive()  # blocked on the lock
            runner.train_iteration(0)
        th.join(timeout=30)
        assert not th.is_alive() and got["r"][0] == 200
    finally:
        runner.viewer.stop()
    assert torch.isfinite(runner.gstate.params.means).all()
