"""The multi-process launch of the port's trainer
(``parallel/multihost.py``, ``trainer.main``): the JAX trainer's
environment (``COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``) mapped onto torchrun's, and ``trainer.main`` in two
gloo ranks on the CPU under ``COORDINATOR_ADDRESS``: the process group
forms, mesh "auto" shards the gaussians over both ranks (batch 1), only
rank 0 writes files, and the trained state is the same on both ranks.
"""
import json
import os

import numpy as np
import pytest
import torch

from gs_init_tpu_torch.datasets.synthetic import make_scene, write_colmap_scene
from gs_init_tpu_torch.parallel import multihost
from torch_dist import spawn, trainer_rank

torch.set_num_threads(2)

LAUNCH_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
               "COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


@pytest.fixture
def clean_env(monkeypatch):
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_no_launch_is_one_process(clean_env):
    assert multihost.launch_env() == {}
    assert multihost.initialize_multihost() == (0, 1)  # a no-op
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    assert multihost.local_batch_slice(8) == slice(0, 8)


@pytest.mark.parametrize("coord", ["COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS"])
def test_jax_launch_maps_onto_torchrun(clean_env, coord):
    clean_env.setenv(coord, "10.0.0.7:1234")
    clean_env.setenv("JAX_NUM_PROCESSES", "4")
    clean_env.setenv("JAX_PROCESS_ID", "3")
    env = multihost.launch_env()
    assert (env["MASTER_ADDR"], env["MASTER_PORT"], env["WORLD_SIZE"], env["RANK"]) == ("10.0.0.7", "1234", "4", "3")
    assert env["LOCAL_RANK"] == str(3 % max(torch.cuda.device_count(), 1))
    clean_env.setenv("LOCAL_RANK", "1")
    clean_env.setenv("RANK", "2")  # torchrun's own names win
    assert (multihost.launch_env()["LOCAL_RANK"], multihost.launch_env()["RANK"]) == ("1", "2")


def test_torchrun_env_and_devices(clean_env):
    for k, v in dict(MASTER_ADDR="h", MASTER_PORT="29500", WORLD_SIZE="8", RANK="6", LOCAL_RANK="2").items():
        clean_env.setenv(k, v)
    assert multihost.launch_env()["LOCAL_RANK"] == "2"
    assert multihost.local_device() == torch.device("cuda", 2)
    assert multihost.local_device("cpu") == torch.device("cpu")
    assert multihost.default_backend("cpu") == "gloo" and multihost.default_backend("cuda:0") == "nccl"


def test_trainer_main_in_two_ranks(tmp_path, clean_env):
    sc = make_scene(n_gaussians=40, n_cams=6, width=48, height=32, device="cpu")
    data_dir = write_colmap_scene(str(tmp_path / "scene"), sc, n_points=32)
    res = str(tmp_path / "res")
    argv = ["default", f"--data_dir={data_dir}", f"--result_dir={res}", "--data_factor=1", "--test_every=3",
            "--max_steps=12", "--eval_steps=[12]", "--save_steps=[12]", "--max_gaussians=63",
            "--pair_capacity=8192", "--tile_size=16", "--sh_degree=1", "--tb_every=4",
            "--strategy.refine_start_iter=3", "--strategy.refine_every=5"]
    ranks = spawn(trainer_rank, 2, argv, init=False)
    for r, out in enumerate(ranks):
        assert (out["rank"], out["world"], out["backend"]) == (r, 2, "gloo")
        assert out["mesh"] == {"data": 1, "gauss": 2} and out["is_main"] == (r == 0)
        assert out["psnr"] == ranks[0]["psnr"] and np.isfinite(out["psnr"])
        for k, v in out["state"].items():
            np.testing.assert_array_equal(v, ranks[0]["state"][k], err_msg=k)
    assert ranks[0]["state"]["params/means"].shape == (64, 3)  # 63 rounded up to the gauss axis
    with open(os.path.join(res, "stats", "val_step12.json")) as f:
        assert json.load(f)["psnr"] == pytest.approx(ranks[0]["psnr"], abs=1e-9)
    assert sorted(os.listdir(os.path.join(res, "ckpts"))) == ["ckpt_12.npz"]
    assert len([f for f in os.listdir(os.path.join(res, "tb")) if "tfevents" in f]) == 1
