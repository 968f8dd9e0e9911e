"""The port's Runner on a multi-GPU mesh (``engine/runner.py``'s mesh
branch), as ``tests/test_runner_mesh.py`` holds the JAX Runner: four gloo
ranks on the CPU, mesh "2x2" (two cameras per step over the data axis,
the gaussians over the gauss axis).

- ``resolve_mesh`` with the cases of ``tests/test_runner_mesh.py:47-58``
  (the world size in place of the JAX device count);
- the loss curve against the one-device Runner through refines: within
  1e-4 relative before the first (``test_runner_mesh.py:101``), within 5%
  at the end (a refine restarts Adam moments, so rounding grows into whole
  steps, see ``tests/test_torch_runner.py``);
- eval, save and a reload that resumes, on the mesh;
- the MCMC strategy's relocation and noise through the Runner;
- the monocular-depth init on the mesh, with the depth cache and the
  init-cloud export on: rank 0 alone predicts and writes, and every rank
  starts from the one-device Runner's state (the cloud exceeds the
  capacity: the uniform random subset, in a full buffer);
- the npz of the mesh run loads into the JAX Runner to 0 ulp.
"""
import numpy as np
import pytest

from gs_init_tpu.config import Config as JConfig
from gs_init_tpu.engine.runner import Runner as JRunner
from gs_init_tpu_torch.config import Config, DefaultStrategyConfig, MCMCStrategyConfig
from gs_init_tpu_torch.datasets.synthetic import make_scene, write_colmap_scene
from gs_init_tpu_torch.engine.runner import Runner, resolve_mesh
from torch_dist import mesh_jobs, spawn, whole_state


def _cfg(data_dir, result_dir, mesh, **kw):
    base = dict(data_dir=data_dir, result_dir=result_dir, data_factor=1, max_steps=40, batch_size=2,
                sh_degree=1, max_gaussians=96, pair_capacity=1 << 13, tile_size=16, mesh=mesh,
                eval_steps=[], save_steps=[], tb_every=1000, data_prefetch=0,
                strategy=DefaultStrategyConfig(refine_start_iter=10, refine_every=15, reset_every=3000))
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    sc = make_scene(n_gaussians=60, n_cams=8, width=48, height=32, device="cpu")
    data_dir = write_colmap_scene(str(tmp / "scene"), sc)
    mcmc = dict(strategy=MCMCStrategyConfig(cap_max=96, refine_start_iter=2, refine_every=5), init_opa=0.5,
                init_scale=0.1, opacity_reg=0.01, scale_reg=0.01)
    jobs = [
        ("runner", _cfg(data_dir, str(tmp / "curve"), "2x2"), 30),
        ("runner", _cfg(data_dir, str(tmp / "ckpt"), "2x2"), 3, ("eval", "save", "reload", "state")),
        ("runner", _cfg(data_dir, str(tmp / "mcmc"), "2x2", **mcmc), 12),
    ]
    mdi = Config(data_dir="").mdi
    mdi.predictor, mdi.use_cache, mdi.cache_dir = "stub", True, str(tmp / "depth_cache")
    mdi.export_ply, mdi.pts_output_dir = True, str(tmp / "mdi_pts")
    jobs.append(("mdi", _cfg(data_dir, str(tmp / "mdi"), "2x2", init_type="monocular_depth", mdi=mdi)))
    ranks = spawn(mesh_jobs, 4, jobs)
    ref = Runner(Config(**_cfg(data_dir, str(tmp / "ref"), "off")), device="cpu")
    ref_losses = [float(ref.train_iteration(i)["loss"]) for i in range(30)]
    return dict(ranks=ranks, ref=ref_losses, data_dir=data_dir, tmp=tmp, mdi=mdi)


def test_resolve_mesh():
    assert resolve_mesh(Config(data_dir="", mesh="off"), world=8) is None
    assert resolve_mesh(Config(data_dir="", mesh="2x4"), world=1) == (2, 4)
    assert resolve_mesh(Config(data_dir="", mesh="auto", batch_size=2), world=8) == (2, 4)
    assert resolve_mesh(Config(data_dir="", mesh="auto", batch_size=3), world=4) == (1, 4)
    assert resolve_mesh(Config(data_dir="", mesh="auto", shard_pixels=True), world=4) == (4, 1)
    assert resolve_mesh(Config(data_dir="", mesh="auto", batch_size=2), world=1) is None
    assert resolve_mesh(Config(data_dir="", mesh="auto")) is None  # no process group here


def test_runner_mesh_matches_single_device_loss_curve(runs):
    curve = runs["ranks"][0][0]
    assert curve["mesh"] == {"data": 2, "gauss": 2}
    np.testing.assert_allclose(curve["losses"][:10], runs["ref"][:10], rtol=1e-4, atol=1e-5)
    assert abs(curve["losses"][-1] - runs["ref"][-1]) < 0.05 * runs["ref"][-1]
    # Every rank saw the same (replicated) loss.
    for r in runs["ranks"][1:]:
        assert r[0]["losses"] == curve["losses"]


def test_runner_mesh_eval_save_load(runs):
    res = [r[1] for r in runs["ranks"]]
    assert np.isfinite(res[0]["psnr"]) and all(r["psnr"] == res[0]["psnr"] for r in res)
    assert all(r["reload_step"] == 3 and r["reload_equal"] for r in res)
    assert np.isfinite(res[0]["resumed_loss"])
    # Only rank 0 writes: one npz, one eval json.
    ckpts = sorted(p.name for p in (runs["tmp"] / "ckpt" / "ckpts").iterdir())
    assert ckpts == ["ckpt_3.npz"]
    assert (runs["tmp"] / "ckpt" / "stats" / "val_step3.json").exists()


def test_runner_mesh_mcmc(runs):
    losses = runs["ranks"][0][2]["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert runs["ranks"][0][2]["num_GS"] <= 96


def test_runner_mesh_monocular_depth_init(runs):
    """The mdi init under a mesh: rank 0 alone runs the predictor and writes
    the depth cache (no temporary file left) and the init cloud; every rank
    starts from the state of a one-device Runner that reads that cache. The
    cloud exceeds the capacity, so that state is the uniform random subset,
    drawn alike on every rank and on one device, in a full buffer."""
    from gs_init_tpu_torch.mdi.init import pts_and_rgb_from_monocular_depth

    res = [r[3] for r in runs["ranks"]]
    one = Runner(Config(**_cfg(runs["data_dir"], str(runs["tmp"] / "mdi_one"), "off",
                               init_type="monocular_depth", mdi=runs["mdi"])), device="cpu")
    n_train = len(one.trainset)
    cap = one.cfg.max_gaussians
    cloud, _ = pts_and_rgb_from_monocular_depth(one.cfg, one.parser, model=_NoPredictor(), device="cpu")
    assert len(cloud) > cap and int(one.gstate.alive.sum()) == cap
    assert [r["predicted"] for r in res] == [n_train, 0, 0, 0]
    cached = sorted(p.name for p in (runs["tmp"] / "depth_cache").rglob("*") if p.is_file())
    assert len(cached) == n_train and all(name.endswith(".npz") for name in cached)
    assert [p.name for p in (runs["tmp"] / "mdi_pts").iterdir()] == ["mdi_init_points.ply"]
    want = whole_state(one)
    for r in res:
        for k in want:
            np.testing.assert_array_equal(r["state"][k], want[k], err_msg=k)


class _NoPredictor:
    """A predictor that must not be asked: the init reads the cache."""

    name = "stub"

    def predict_depth_batch(self, images, intrinsics):
        raise AssertionError("the depth cache should have been used")


def test_mesh_npz_loads_into_jax_runner(runs):
    """The mesh run's npz in the JAX Runner (and in a one-device port
    Runner): every array equal to the gathered state, to 0 ulp."""
    res = runs["ranks"][0][1]
    state = res["state"]
    cfg = _cfg(runs["data_dir"], str(runs["tmp"] / "jax"), "off", rasterizer_impl="xla")
    jr = JRunner(JConfig(**{k: v for k, v in cfg.items() if k != "strategy"}))
    assert jr.load(res["npz"]) == 3
    for name in ("means", "quats", "scales", "opacities", "sh0", "shN"):
        np.testing.assert_array_equal(np.asarray(getattr(jr.gstate.params, name)), state[f"params/{name}"])
        np.testing.assert_array_equal(np.asarray(getattr(jr.adam.mu, name)), state[f"mu/{name}"])
        np.testing.assert_array_equal(np.asarray(getattr(jr.adam.nu, name)), state[f"nu/{name}"])
    np.testing.assert_array_equal(np.asarray(jr.gstate.alive), state["alive"])
    for name in ("grad2d", "count", "radii_max"):
        np.testing.assert_array_equal(np.asarray(getattr(jr.sstate, name)), state[f"strategy/{name}"])
    pr = Runner(Config(**_cfg(runs["data_dir"], str(runs["tmp"] / "one"), "off")), device="cpu")
    pr.load(res["npz"])
    got = whole_state(pr)
    for k in state:
        np.testing.assert_array_equal(got[k], state[k], err_msg=k)
