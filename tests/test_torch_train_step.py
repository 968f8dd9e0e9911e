"""Parity of the slice as a whole: the port's train step, ``refine`` and
``reset_opacities`` against the JAX package's, from identical state; then a
port-only CPU ``Runner`` run on a tiny synthetic COLMAP scene.

The JAX step runs the Pallas compositor in interpret mode with the f32 wire
and f32 record sort (``wire8=False, sort_bf16=False``) and donates its
state, so it only ever gets fresh arrays (its own outputs, or arrays made
from numpy).

Tolerances: losses within 1e-5 relative; Adam moments within 1e-4 of their
max magnitude (gradients agree to f32 rounding of two summation orders);
strategy counts and radii exactly, grad2d within 1e-4 of its max. Adam
divides each gradient by its own running size, so a gradient error e moves
a parameter by about lr * 2e / |g| per step (at most 2 lr, a sign flip).
With e = 1e-4 of the leaf's max gradient, each parameter may differ by 1e-5
plus lr times the sum over the steps taken of min(2, 2e-4 max|g| / |g|).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_init_tpu.config import Config as JConfig
from gs_init_tpu.config import DefaultStrategyConfig as JStrategy
from gs_init_tpu.engine import optim as jopt
from gs_init_tpu.engine.params import GaussianParams as JParams
from gs_init_tpu.engine.params import GaussianState as JState
from gs_init_tpu.engine.params import init_from_points as j_init
from gs_init_tpu.engine.strategy import default as jstrat
from gs_init_tpu.engine.train_step import AuxParams, Batch as JBatch, init_aux_opt
from gs_init_tpu.engine.train_step import make_train_step as j_make_step
from gs_init_tpu_torch.config import Config, DefaultStrategyConfig
from gs_init_tpu_torch.engine import optim as popt
from gs_init_tpu_torch.engine.params import PARAM_NAMES, state_from_numpy
from gs_init_tpu_torch.engine.strategy import default as pstrat
from gs_init_tpu_torch.engine.train_step import AuxParams as PAux
from gs_init_tpu_torch.engine.train_step import Batch, make_train_step
from gs_init_tpu_torch.engine.train_step import init_aux_opt as p_init_aux_opt
from torch_parity import CPU, H, W, assert_close_scaled, n, scene, t

CAP, N_PTS = 64, 48
CFG = dict(
    sh_degree=3, sh_degree_interval=2, max_gaussians=CAP, pair_capacity=8192,
    tile_size=16, chunk_size=128, rasterizer_impl="pallas", wire8=False,
    sort_bf16=False, max_steps=100,
)
OPTIONS = dict(
    random_bkgd=True, opacity_reg=0.01, scale_reg=0.01, depth_loss=True,
)


def _configs(options: bool):
    extra = OPTIONS if options else {}
    jcfg = JConfig(**CFG, **extra, strategy=JStrategy(absgrad=options))
    pcfg = Config(**CFG, **extra, strategy=DefaultStrategyConfig(absgrad=options))
    return jcfg, pcfg


def _initial_state(rng):
    sc = scene(rng, n_g=N_PTS)
    g = j_init(jnp.asarray(sc["means"]), jnp.asarray(sc["colors"]), CAP, 3, init_opacity=0.4)
    leaves = {k: np.array(getattr(g.params, k)) for k in PARAM_NAMES}
    leaves["shN"] = (rng.normal(size=leaves["shN"].shape) * 0.1).astype(np.float32)
    # Dead slots behind the camera: at the origin, which is the camera
    # centre here, their projection and gradients would be NaN on both sides.
    leaves["means"][~np.array(g.alive)] = (0.0, 0.0, -1.0)
    # Anisotropic scales, so the rotations get real (not rounding-noise) gradients.
    leaves["scales"] = (leaves["scales"] + rng.normal(0, 0.3, leaves["scales"].shape)).astype(np.float32)
    return sc, leaves, np.array(g.alive)


def _jax_state(leaves, alive):
    return JState(params=JParams(**{k: jnp.asarray(v) for k, v in leaves.items()}),
                  alive=jnp.asarray(alive))


def _batches(rng, sc, options):
    pixels = rng.uniform(size=(1, H, W, 3)).astype(np.float32)
    c2w = np.linalg.inv(sc["viewmats"]).astype(np.float32)
    kw = {}
    if options:
        kw["sampling_mask"] = (rng.uniform(size=(1, H, W, 1)) > 0.3).astype(np.float32)
        pts = np.stack([rng.uniform(0, W, 16), rng.uniform(0, H, 16)], -1)[None]
        vals = rng.uniform(1.0, 4.0, (1, 16))
        vals[:, -3:] = 0.0  # padding entries carry no depth target
        kw["depth_points"] = pts.astype(np.float32)
        kw["depth_values"] = vals.astype(np.float32)
    jb = JBatch(camtoworlds=jnp.asarray(c2w), Ks=jnp.asarray(sc["Ks"]), pixels=jnp.asarray(pixels),
                image_ids=jnp.zeros((1,), jnp.int32), **{k: jnp.asarray(v) for k, v in kw.items()})
    pb = Batch(camtoworlds=t(c2w), Ks=t(sc["Ks"]), pixels=t(pixels),
               image_ids=torch.zeros((1,), dtype=torch.long), **{k: t(v) for k, v in kw.items()})
    return jb, pb


def _compare(jg, ja, js, pg, pa, ps, slack, lrs):
    for k in PARAM_NAMES:
        diff = np.abs(n(getattr(pg.params, k)) - np.asarray(getattr(jg.params, k)))
        allowed = 1e-5 + lrs[k] * slack[k]
        assert (diff <= allowed).all(), (k, float(diff[diff > allowed].max()))
        assert_close_scaled(getattr(pa.mu, k), getattr(ja.mu, k), 1e-4, err_msg=f"mu {k}")
        assert_close_scaled(getattr(pa.nu, k), getattr(ja.nu, k), 2e-4, err_msg=f"nu {k}")
    assert pa.count == int(ja.count)
    np.testing.assert_array_equal(n(ps.count), np.asarray(js.count))
    np.testing.assert_array_equal(n(ps.radii_max), np.asarray(js.radii_max))
    assert_close_scaled(ps.grad2d, js.grad2d, 1e-4, err_msg="grad2d")


@pytest.mark.parametrize("options", [False, True], ids=["default", "bkgd-mask-depth-regs-absgrad"])
def test_train_steps_match_jax(rng, options):
    """One step, then four more (five in all), from identical state."""
    jcfg, pcfg = _configs(options)
    sc, leaves, alive = _initial_state(rng)
    jb, pb = _batches(rng, sc, options)
    scene_scale = 2.0
    jacfg = jopt.make_adam_config(jcfg, scene_scale)
    pacfg = popt.make_adam_config(pcfg, scene_scale)
    j_step = j_make_step(jcfg, jacfg, W, H)
    p_step = make_train_step(pcfg, pacfg, W, H)

    jg = _jax_state(leaves, alive)
    ja = jopt.init_adam_state(jg.params)
    js = jstrat.init_state(CAP)
    aux = AuxParams()
    aux_opt = init_aux_opt(aux)
    pg = state_from_numpy(leaves, alive, CPU)
    pa = popt.init_adam_state(pg.params)
    ps = pstrat.init_state(CAP, CPU)
    paux = PAux()
    paux_opt = p_init_aux_opt(paux)
    slack = {k: np.zeros(v.shape) for k, v in leaves.items()}
    mu_prev = {k: np.zeros_like(v) for k, v in leaves.items()}
    for step in range(5):
        key = jax.random.PRNGKey(100 + step)
        bkgd = t(jax.random.uniform(key, (1, 3))) if options else None
        jg, ja, js, aux, aux_opt, jm = j_step(jg, ja, js, aux, aux_opt, jb, jnp.int32(step), key)
        pg, pa, ps, paux, paux_opt, pm = p_step(pg, pa, ps, paux, paux_opt, pb, step, bkgd=bkgd)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        assert int(pm["pairs"]) == int(jm["pairs"]) > 0
        assert int(pm["overflow"]) == int(jm["overflow"]) == 0
        for k in PARAM_NAMES:  # this step's JAX gradient, from its moment
            mu = np.asarray(getattr(ja.mu, k))
            g = np.abs(mu - jacfg.b1 * mu_prev[k]) / (1 - jacfg.b1)
            slack[k] += np.minimum(2.0, 2e-4 * g.max() / np.maximum(g, 1e-30))
            mu_prev[k] = mu
        if step in (0, 4):
            _compare(jg, ja, js, pg, pa, ps, slack, pacfg.lrs)


def test_refine_and_reset_match_jax(rng):
    """Grow (dup + split into free slots, capacity-limited), prune and
    opacity reset with the JAX draws of the split noise handed over."""
    cfg_kw = dict(grow_grad2d=0.002, grow_scale3d=0.05, prune_opa=0.05, prune_scale3d=0.3,
                  refine_scale2d_stop_iter=50, reset_every=5, revised_opacity=True)
    jcfg, pcfg = JStrategy(**cfg_kw), DefaultStrategyConfig(**cfg_kw)
    _, leaves, alive = _initial_state(rng)
    # Half small (duplicated), half large (split); radii_max straddles
    # grow_scale2d so the screen-size rule splits some of the small ones.
    size = rng.choice([0.03, 0.3], CAP)[:, None] * rng.uniform(0.8, 1.2, (CAP, 3))
    leaves["scales"] = np.log(size).astype(np.float32)
    leaves["opacities"] = rng.normal(size=CAP).astype(np.float32) * 3
    stats = dict(
        grad2d=rng.uniform(0, 0.01, CAP).astype(np.float32),
        count=rng.integers(0, 4, CAP).astype(np.float32),
        radii_max=rng.uniform(0, 0.1, CAP).astype(np.float32),
    )
    moments = {k: (rng.normal(size=v.shape).astype(np.float32)) for k, v in leaves.items()}
    scene_scale, step = 1.5, 10

    key = jax.random.PRNGKey(7)
    jg = _jax_state(leaves, alive)
    jp = JParams(**{k: jnp.asarray(v) for k, v in moments.items()})
    ja = jopt.AdamState(mu=jp, nu=jax.tree.map(jnp.abs, jp), count=jnp.int32(3))
    js = jstrat.DefaultStrategyState(**{k: jnp.asarray(v) for k, v in stats.items()})
    jg, ja, _, jstats = jstrat.refine(jg, ja, js, key, scene_scale, jcfg, jnp.int32(step))
    jg, ja = jstrat.reset_opacities(jg, ja, jcfg)

    # The JAX refine's own draws (default.py: split(key) -> two normals).
    k1, k2 = jax.random.split(key)
    eps1, eps2 = (t(jax.random.normal(k, (CAP, 3))) for k in (k1, k2))
    pg = state_from_numpy(leaves, alive, CPU)
    pa = popt.adam_from_numpy(moments, {k: np.abs(v) for k, v in moments.items()}, 3, CPU)
    ps = pstrat.strategy_from_numpy(stats["grad2d"], stats["count"], stats["radii_max"], CPU)
    pg, pa, ps_new, pstats = pstrat.refine(pg, pa, ps, eps1, eps2, scene_scale, pcfg, step)
    pg, pa = pstrat.reset_opacities(pg, pa, pcfg)

    assert pstats == {k: int(v) for k, v in jstats.items()}
    assert pstats["n_dup"] > 0 and pstats["n_split"] > 0 and pstats["n_pruned"] > 0
    np.testing.assert_array_equal(n(pg.alive), np.asarray(jg.alive))
    for k in PARAM_NAMES:
        np.testing.assert_allclose(n(getattr(pg.params, k)), np.asarray(getattr(jg.params, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(n(getattr(pa.mu, k)), np.asarray(getattr(ja.mu, k)))
        np.testing.assert_array_equal(n(getattr(pa.nu, k)), np.asarray(getattr(ja.nu, k)))
    assert float(ps_new.grad2d.abs().sum() + ps_new.count.sum()) == 0.0


def test_runner_lowers_loss_on_cpu(tmp_path):
    """The port alone: synthetic scene -> COLMAP files -> Runner on the CPU,
    with one refine (step 40) inside the run; the training loss falls by
    more than 15% and eval PSNR rises."""
    from gs_init_tpu_torch.datasets.synthetic import make_scene, write_colmap_scene
    from gs_init_tpu_torch.engine.runner import Runner

    sc = make_scene(n_gaussians=64, n_cams=6, width=W, height=H, device="cpu")
    data_dir = write_colmap_scene(str(tmp_path), sc, n_points=48)
    cfg = Config(
        data_dir=data_dir, data_factor=1, result_dir=str(tmp_path / "res"), max_steps=60,
        eval_steps=[], test_every=3, max_gaussians=256, pair_capacity=1 << 13,
        tile_size=16, sh_degree=1, tb_every=1,
        strategy=DefaultStrategyConfig(refine_start_iter=30, refine_every=40, reset_every=1000),
    )
    runner = Runner(cfg, device="cpu")
    n0 = int(runner.gstate.alive.sum())
    psnr0 = runner.eval(0)["psnr"]
    losses = [float(runner.train_iteration(step)["loss"]) for step in range(cfg.max_steps)]
    psnr1 = runner.eval(cfg.max_steps)["psnr"]
    assert np.isfinite(losses).all()
    assert int(runner.gstate.alive.sum()) > n0  # the refine grew the set
    assert np.mean(losses[-5:]) < 0.85 * np.mean(losses[:5]), losses
    assert psnr1 > psnr0, (psnr0, psnr1)
    assert os.path.exists(os.path.join(cfg.result_dir, "stats", f"val_step{cfg.max_steps}.json"))
