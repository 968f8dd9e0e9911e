"""Sharded checkpoints (``engine/ckpt.py``): a Runner on a 2x2 mesh of
gloo ranks saves one file per gaussian shard; the checkpoint restores onto
a 1x2 mesh and onto one device, every array equal to the saved run's
gathered state (and to its npz), the aux groups included."""
import json
import os

import numpy as np
import pytest
import torch

from gs_init_tpu_torch.config import Config
from gs_init_tpu_torch.datasets.synthetic import make_scene, write_colmap_scene
from gs_init_tpu_torch.engine import ckpt
from gs_init_tpu_torch.engine.runner import Runner
from torch_dist import mesh_jobs, spawn, whole_state

torch.set_num_threads(2)


def _cfg(data_dir, result_dir, mesh):
    return dict(data_dir=data_dir, result_dir=result_dir, data_factor=1, max_steps=10, batch_size=2,
                sh_degree=1, max_gaussians=96, pair_capacity=1 << 13, tile_size=16, mesh=mesh,
                eval_steps=[], save_steps=[], tb_every=1000, data_prefetch=0, pose_opt=True,
                use_bilateral_grid=True)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    sc = make_scene(n_gaussians=60, n_cams=6, width=48, height=32, device="cpu")
    data_dir = write_colmap_scene(str(tmp / "scene"), sc)
    run = spawn(mesh_jobs, 4, [("runner", _cfg(data_dir, str(tmp / "run"), "2x2"), 3,
                                ("sharded", "save", "state"))])[0][0]
    return dict(run=run, data_dir=data_dir, tmp=tmp)


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sharded_layout(saved):
    path = saved["run"]["sharded"]
    assert sorted(os.listdir(path)) == ["meta.json", "replicated.npz", "shard0.npz", "shard1.npz"]
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta == dict(step=3, capacity=96, mesh=[2, 2], shards=2, adam_count=3)
    with np.load(os.path.join(path, "shard1.npz")) as z:
        np.testing.assert_array_equal(z["params/means"], saved["run"]["state"]["params/means"][48:])


def test_restore_onto_1x2(saved):
    out = spawn(mesh_jobs, 2, [("restore", _cfg(saved["data_dir"], str(saved["tmp"] / "r12"), "1x2"),
                                saved["run"]["sharded"])])
    for r in out:
        assert r[0]["step"] == 3 and r[0]["mesh"] == {"data": 1, "gauss": 2}
        _assert_state_equal(r[0]["state"], saved["run"]["state"])


def test_restore_onto_one_device(saved):
    r = Runner(Config(**_cfg(saved["data_dir"], str(saved["tmp"] / "one"), "off")), device="cpu")
    assert ckpt.load_sharded(r, saved["run"]["sharded"]) == 3
    _assert_state_equal(whole_state(r), saved["run"]["state"])
    # The same state as the run's whole-state npz gives.
    r2 = Runner(Config(**_cfg(saved["data_dir"], str(saved["tmp"] / "npz"), "off")), device="cpu")
    r2.load(saved["run"]["npz"])
    _assert_state_equal(whole_state(r2), saved["run"]["state"])
    # A capacity that differs is refused.
    cfg = _cfg(saved["data_dir"], str(saved["tmp"] / "small"), "off")
    cfg["max_gaussians"] = 64
    with pytest.raises(ValueError, match="capacity"):
        ckpt.load_sharded(Runner(Config(**cfg), device="cpu"), saved["run"]["sharded"])
