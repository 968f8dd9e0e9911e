"""Parity: the port's Method adapter (``gs_init_tpu_torch/integration/
method.py``) against ``gs_init_tpu.integration.method`` on the same tiny
scene, both with ``rasterizer_impl="xla"`` (the dense oracle),
``wire8=False`` and one device. The JAX Method trains three steps and saves; the port's
Method loads that checkpoint, and from the same state both give the same
render (color and accumulation within 1e-5 abs, depth within 1e-5 of its
max), the same fitted
appearance embedding (``optimize_embedding``, 10 Adam steps, within 1e-4
of its max) and the same demo PLY; the port trains on, saves, and the JAX
Method loads it to 0 ulp. Also the lifecycle on its own and the dataset
presets. The twin is tests/test_integration.py.
"""
import numpy as np
import pytest

from gs_init_tpu.integration import method as jmethod
from gs_init_tpu.utils.ply import read_ply_splats as j_read_ply
from gs_init_tpu_torch.datasets.synthetic import make_scene, write_colmap_scene
from gs_init_tpu_torch.engine.params import PARAM_NAMES
from gs_init_tpu_torch.integration import method as pmethod
from torch_parity import n

OVERRIDES = {
    "data_factor": 1, "max_steps": 10, "test_every": 5, "sh_degree": 1, "max_gaussians": 128,
    "pair_capacity": 8192, "rasterizer_impl": "xla", "wire8": "false", "app_opt": "true",
    "data_prefetch": 0, "mesh": "off",  # the tests' 8 virtual CPU devices would shard the JAX Runner
}


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    sc = make_scene(n_gaussians=80, n_cams=10, width=64, height=48, device="cpu")
    return write_colmap_scene(str(tmp_path_factory.mktemp("method")), sc, n_points=64)


def _method(cls_module, scene_dir, result_dir, **kw):
    extra = dict(device="cpu") if cls_module is pmethod else {}
    return cls_module.GsInitTpuMethod(
        data_dir=scene_dir, config_overrides=dict(OVERRIDES, result_dir=result_dir), **kw, **extra
    )


def test_method_matches_jax_from_the_same_checkpoint(scene_dir, tmp_path):
    jm = _method(jmethod, scene_dir, str(tmp_path / "jax"))
    jm.setup_train()
    for step in range(3):
        jm.train_iteration(step)
    ckpt = jm.save(str(tmp_path / "jax_ckpt.npz"))

    pm = _method(pmethod, scene_dir, str(tmp_path / "port"), checkpoint=ckpt)
    info, jinfo = pm.get_info(), jm.get_info()
    assert info["loaded_step"] == 2 and info["num_gaussians"] == jinfo["num_gaussians"] > 0
    assert info["num_iterations"] == jinfo["num_iterations"] == 10

    item = pm.runner.valset[0]
    got = pm.render(item["camtoworld"], item["K"], 64, 48)
    want = jm.render(item["camtoworld"], item["K"], 64, 48)
    for k in ("color", "accumulation", "depth"):
        assert got[k].shape == want[k].shape
        scale = np.abs(want[k]).max() if k == "depth" else 1.0
        np.testing.assert_allclose(got[k] / scale, np.asarray(want[k]) / scale, atol=1e-5, err_msg=k)

    emb = pm.optimize_embedding(item["image"], item["camtoworld"], item["K"], n_steps=10)
    jemb = jm.optimize_embedding(item["image"], item["camtoworld"], item["K"], n_steps=10)
    assert emb.shape == (pm.cfg.app_embed_dim,) and np.isfinite(emb).all()
    np.testing.assert_allclose(emb / np.abs(jemb).max(), jemb / np.abs(jemb).max(), atol=1e-4)

    opts = dict(embedding=jemb, camera_center=[0.5, -0.2, 1.0])
    p_ply = j_read_ply(pm.export_demo(str(tmp_path / "p.ply"), options=opts))
    j_ply = j_read_ply(jm.export_demo(str(tmp_path / "j.ply"), options=opts))
    for a, b in zip(p_ply, j_ply):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)

    # The port trains on from the JAX state; the JAX Method loads its save.
    pm.setup_train()
    for step in range(3, 5):
        metrics = pm.train_iteration(step)
    assert np.isfinite(metrics["loss"])
    pckpt = pm.save(str(tmp_path / "port_ckpt.npz"))
    jm2 = _method(jmethod, scene_dir, str(tmp_path / "jax2"), checkpoint=pckpt)
    assert jm2.step == 4
    for name in PARAM_NAMES:
        np.testing.assert_array_equal(np.asarray(getattr(jm2.runner.gstate.params, name)),
                                      n(getattr(pm.runner.gstate.params, name)), err_msg=name)


def test_method_lifecycle(scene_dir, tmp_path):
    m = _method(pmethod, scene_dir, str(tmp_path / "r"))
    assert m.get_info()["num_iterations"] == 10
    m.setup_train()
    for step in range(3):
        metrics = m.train_iteration(step)
    assert np.isfinite(metrics["loss"])
    ckpt = m.save()
    assert ckpt.endswith("ckpt_2.npz")
    item = m.runner.valset[0]
    out = m.render(item["camtoworld"], item["K"], 64, 48)
    assert out["color"].shape == (48, 64, 3) and out["depth"].shape == (48, 64)
    m2 = _method(pmethod, scene_dir, str(tmp_path / "r2"), checkpoint=ckpt)
    np.testing.assert_array_equal(n(m2.runner.gstate.params.means), n(m.runner.gstate.params.means))
    plain = _method(pmethod, scene_dir, str(tmp_path / "r3"))
    plain.cfg.app_opt = False
    plain.runner.aux.app = None
    with pytest.raises(RuntimeError, match="app_opt"):
        plain.optimize_embedding(item["image"], item["camtoworld"], item["K"], n_steps=1)


def test_dataset_presets(scene_dir, tmp_path):
    assert pmethod.DATASET_PRESETS == jmethod.DATASET_PRESETS
    m = _method(pmethod, scene_dir, str(tmp_path / "r4"), dataset_kind="blender")
    assert m.cfg.init_type == "random"
    assert m.cfg.background_color == (1.0, 1.0, 1.0)
    assert pmethod.register_with_nerfbaselines() is False  # nerfbaselines is not installed
