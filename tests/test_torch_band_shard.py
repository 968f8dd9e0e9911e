"""The port's pixel-band train step (``cfg.shard_pixels``,
``parallel/shard.make_band_sharded_train_step``) on meshes (2, 1) and
(2, 2) of gloo ranks on the CPU, against the port's one-device step and
the JAX package's band step on the virtual 8-device CPU mesh; then the
band Runner end to end against the one-device Runner.

The scene is ``tests/test_band_shard.py``'s: 32x48 pixels at tile 16, so
three tile rows split into bands of two (the last band runs past the
image and its padded rows are dropped), one camera per step. The port's
steps run its tile path with the compositor's plain twins; against JAX
(dense oracle) one case with the regularisers, a random background and the
depth loss runs through the port's ``xla`` path on each mesh.

Tolerances as ``tests/test_torch_parallel.py``: against the port's one
device, loss within 1e-5 relative and means, scales, opacities, sh0 and
grad2d within 1e-5 absolute (``tests/test_band_shard.py``'s); against JAX,
loss within 1e-5 relative, grad2d and first moments within 1e-4 of their
max and each parameter within 1e-5 plus its Adam step's sign-flip slack;
the Runner's loss curve within 1e-4 relative (``test_band_shard.py:172``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_init_tpu.config import Config as JConfig
from gs_init_tpu.engine.optim import init_adam_state, make_adam_config
from gs_init_tpu.engine.params import GaussianParams, GaussianState, init_from_points
from gs_init_tpu.engine.strategy import default as jdstrat
from gs_init_tpu.engine.train_step import AuxParams as JAux
from gs_init_tpu.engine.train_step import Batch as JBatch
from gs_init_tpu.engine.train_step import init_aux_opt as j_init_aux_opt
from gs_init_tpu.parallel.shard import make_band_sharded_train_step as j_band
from gs_init_tpu.parallel.shard import make_mesh as j_make_mesh
from gs_init_tpu.parallel.shard import shardings
from gs_init_tpu_torch.config import Config, DefaultStrategyConfig
from gs_init_tpu_torch.datasets.synthetic import make_scene, write_colmap_scene
from gs_init_tpu_torch.engine.params import PARAM_NAMES
from gs_init_tpu_torch.engine.runner import Runner
from gs_init_tpu_torch.parallel.shard import band_height
from torch_dist import assert_adam_steps_close, assert_step_match, mesh_jobs, run_step, spawn
from torch_parity import assert_close_scaled

torch.set_num_threads(2)

CAP, W, H = 128, 32, 48
IDX = np.array([1])
MESHES = [(2, 1), (2, 2)]
BASE = dict(max_steps=100, sh_degree=1, max_gaussians=CAP, pair_capacity=1 << 13, batch_size=1,
            tile_size=16, shard_pixels=True)
CASES = {
    "base": {},
    "regs_bkgd": {"random_bkgd": True, "opacity_reg": 0.01, "scale_reg": 0.01},
    "bg_color": {"background_color": (0.2, 0.4, 0.9)},
    "depth": {"depth_loss": True},
    "absgrad": {"strategy": DefaultStrategyConfig(absgrad=True)},
}
BANDS2 = ("base", "absgrad")  # the cases run with two bands on one rank
ALL = {"random_bkgd": True, "opacity_reg": 0.01, "scale_reg": 0.01, "depth_loss": True}


@functools.lru_cache
def _scene():
    return make_scene(n_gaussians=48, n_cams=4, width=W, height=H, device="cpu")


@functools.lru_cache
def _inputs(depth: bool, bkgd: bool):
    sc = _scene()
    g = init_from_points(jnp.asarray(sc.points), jnp.asarray(sc.rgbs), CAP, 1)
    batch = dict(camtoworlds=sc.camtoworlds[IDX], Ks=sc.Ks[IDX], pixels=sc.images[IDX], image_ids=IDX)
    if depth:
        rng = np.random.default_rng(0)
        vals = rng.uniform(1.0, 5.0, (1, 6)).astype(np.float32)
        vals[0, 4:] = 0.0
        batch.update(depth_points=rng.integers(0, [W, H], (1, 6, 2)).astype(np.float32), depth_values=vals)
    out = dict(params={k: np.asarray(v) for k, v in g.params._asdict().items()},
               alive=np.asarray(g.alive), batch=batch, step=5)
    if bkgd:  # the band step's replicated draw (shard.py:455)
        out["bkgd"] = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (1, 3)))
    return out


def _case_inputs(cfg_kw):
    return _inputs(bool(cfg_kw.get("depth_loss")), bool(cfg_kw.get("random_bkgd")))


def _job(cfg_kw, mesh_shape, impl="auto", bands_per_rank=1):
    return ("step", dict(BASE, rasterizer_impl=impl, **cfg_kw), float(_scene().scene_scale), W, H,
            _case_inputs(cfg_kw), mesh_shape, True, bands_per_rank)


def _jax_band(cfg_kw, mesh_shape):
    sc = _scene()
    inputs = _case_inputs(cfg_kw)
    cfg = JConfig(**dict(BASE, rasterizer_impl="xla", **cfg_kw))
    acfg = make_adam_config(cfg, sc.scene_scale)
    g = GaussianState(params=GaussianParams(**{k: jnp.asarray(v) for k, v in inputs["params"].items()}),
                      alive=jnp.asarray(inputs["alive"]))
    mesh = j_make_mesh(*mesh_shape)
    gauss_s, _, repl_s = shardings(mesh)
    put = lambda tree, s: jax.tree.map(lambda x: jax.device_put(x, s), tree)
    adam = jax.tree.map(lambda x: jax.device_put(x, gauss_s if x.ndim > 0 else repl_s), init_adam_state(g.params))
    batch = JBatch(**{k: jnp.asarray(v) for k, v in inputs["batch"].items()})
    g2, a2, s2, _, _, m = j_band(cfg, acfg, W, H, mesh)(
        put(g, gauss_s), adam, put(jdstrat.init_state(CAP), gauss_s), JAux(), j_init_aux_opt(JAux()),
        put(batch, repl_s), jnp.int32(5), jax.random.PRNGKey(0),
    )
    out = {"metric/loss": np.asarray(m["loss"]), "grad2d": np.asarray(s2.grad2d), "b1": acfg.b1,
           "lrs": dict(acfg.lrs._asdict())}
    out.update({f"params/{k}": np.asarray(getattr(g2.params, k)) for k in PARAM_NAMES})
    out.update({f"mu/{k}": np.asarray(getattr(a2.mu, k)) for k in PARAM_NAMES})
    return out


def _runner_cfg(data_dir, result_dir, mesh, shard_pixels):
    return dict(data_dir=data_dir, result_dir=result_dir, data_factor=1, max_steps=20, batch_size=1,
                sh_degree=1, max_gaussians=96, pair_capacity=1 << 13, tile_size=16, mesh=mesh,
                shard_pixels=shard_pixels, eval_steps=[], save_steps=[], tb_every=1000, data_prefetch=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of four ranks: every case on both meshes (tile path), the
    JAX case on the xla path, two cases with two bands on one rank, and a
    2x2 band Runner for 12 steps."""
    tmp = tmp_path_factory.mktemp("band")
    sc = make_scene(n_gaussians=60, n_cams=6, width=48, height=32, device="cpu")
    data_dir = write_colmap_scene(str(tmp), sc)
    jobs = [_job(kw, shape) for shape in MESHES for kw in CASES.values()]
    jobs += [_job(ALL, shape, impl="xla") for shape in MESHES]
    jobs += [_job(CASES[case], (1, 1), bands_per_rank=2) for case in BANDS2]
    jobs.append(("runner", _runner_cfg(data_dir, str(tmp / "band"), "2x2", True), 12))
    ranks = spawn(mesh_jobs, 4, jobs)
    out = {}
    for i, shape in enumerate(MESHES):
        out[shape] = dict(zip(CASES, ranks[0][i * len(CASES):(i + 1) * len(CASES)]))
    for i, shape in enumerate(MESHES):
        out[shape]["all"] = ranks[0][len(MESHES) * len(CASES) + i]
    out["bands2"] = dict(zip(BANDS2, ranks[0][len(MESHES) * (len(CASES) + 1):-1]))
    out["runner"] = ranks[0][-1]
    ref = Runner(Config(**_runner_cfg(data_dir, str(tmp / "ref"), "off", False)), device="cpu")
    out["runner_ref"] = [float(ref.train_iteration(i)["loss"]) for i in range(12)]
    return out


@pytest.fixture(scope="module")
def one_rank():
    sc = _scene()
    return {name: run_step(Config(**dict(BASE, **kw)), float(sc.scene_scale), W, H, _case_inputs(kw))
            for name, kw in CASES.items()}


def test_band_height():
    assert band_height(48, 16, 2) == 32 and band_height(48, 16, 3) == 16 and band_height(840, 32, 2) == 448


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_band_step_matches_one_rank(runs, one_rank, mesh_shape, case):
    got, want = runs[mesh_shape][case], one_rank[case]
    assert_step_match(got, want, what=f"band {mesh_shape} {case}")
    np.testing.assert_array_equal(got["count"], want["count"])
    # Each band bins only its own rows' pairs: the worst band has fewer.
    assert 0 < int(got["metric/pairs"]) < int(want["metric/pairs"])
    assert int(got["metric/overflow"]) == 0


@pytest.mark.parametrize("case", BANDS2)
def test_two_bands_on_one_rank(runs, one_rank, case):
    """``bands_per_rank=2`` on a one-rank mesh renders the two bands of the
    2x1 mesh one after the other: the same step as that mesh and as the
    one-device step, and the same worst band."""
    got = runs["bands2"][case]
    assert_step_match(got, runs[(2, 1)][case], what=f"two bands on one rank vs 2x1 {case}")
    assert_step_match(got, one_rank[case], what=f"two bands on one rank {case}")
    assert int(got["metric/pairs"]) == int(runs[(2, 1)][case]["metric/pairs"])


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_band_step_matches_jax(runs, mesh_shape):
    got, want = runs[mesh_shape]["all"], _jax_band(ALL, mesh_shape)
    what = f"band {mesh_shape} vs JAX"
    np.testing.assert_allclose(got["metric/loss"], want["metric/loss"], rtol=1e-5, err_msg=what)
    assert_close_scaled(got["grad2d"], want["grad2d"], 1e-4, err_msg=f"{what} grad2d")
    for k in ("means", "scales", "opacities", "sh0"):
        assert_adam_steps_close(got, want, want["lrs"][k], want["b1"], f"params/{k}", f"mu/{k}", what)


def test_band_runner_end_to_end(runs):
    """The Runner with shard_pixels on a 2x2 mesh trains through the band
    step and tracks the one-device loss curve."""
    assert runs["runner"]["mesh"] == {"data": 2, "gauss": 2}
    np.testing.assert_allclose(runs["runner"]["losses"], runs["runner_ref"], rtol=1e-4, atol=1e-5)
