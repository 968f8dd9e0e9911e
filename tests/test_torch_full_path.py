"""Parity: the whole training path of ``chip_smoke.py`` phase 10 at a CPU
size, the port's Runner against the JAX Runner.

A clustered scene (a textured foreground that alone carries the SfM
points, inside a wall and a ground that no SfM point covers; 64x48, 8
cameras, ``test_every=4``) goes through the monocular-depth init of both
packages with the SfM points included, least-squares alignment and the
static stride. The stub predicts 0.37 x the scene's surface depth + 1.3,
with each observed SfM point's own depth at its pixel, so each image's fit
recovers the stub's scale and shift from its SfM correspondences. Then
both Runners train 60 steps from the same state (the JAX Runner's
initial gaussians, loaded into the port through a checkpoint) over the
same batch order, with refines at steps 20 and 40 whose split noise is the
JAX Runner's own draws, an opacity reset at step 50, and a capacity that
the second refine fills. JAX renders with its dense oracle
(``rasterizer_impl="xla"``, as ``test_torch_runner.py``), the port with its
tile compositor's plain version, the path a CPU run of the port takes.

Tolerances: each image's fitted (s, t) within FIT_S_RTOL and FIT_T_ATOL
of the JAX fit's; the init clouds within the move those gaps make at the
largest prediction along the widest ray, plus 1e-6 of their extent (K^-1
and the camera-to-world product in two orders); the losses within 5e-5 relative
before the first refine and 2e-3 after it (``test_torch_runner.py``'s, for
its reason: a refine restarts Adam moments, whose first steps are lr x
sign(gradient)); the alive counts after each refine equal; eval PSNR
within 2e-3 dB. The port's eval-only restart (``trainer.main --ckpt``)
reproduces its own PSNR to 1e-6.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from gs_init_tpu.config import Config as JConfig
from gs_init_tpu.config import DefaultStrategyConfig as JDefault
from gs_init_tpu.datasets.parser import Parser as JParser
from gs_init_tpu.engine.runner import Runner as JRunner
from gs_init_tpu.mdi import init as jinit
from gs_init_tpu.mdi.predictors.stub import StubPredictor as JStub
from gs_init_tpu_torch import trainer
from gs_init_tpu_torch.config import Config, DefaultStrategyConfig
from gs_init_tpu_torch.datasets import synthetic
from gs_init_tpu_torch.datasets.parser import Parser
from gs_init_tpu_torch.engine.params import num_alive
from gs_init_tpu_torch.engine.runner import Runner
from gs_init_tpu_torch.engine.strategy import default as pdefault
from gs_init_tpu_torch.mdi import init as pinit
from gs_init_tpu_torch.mdi.predictors.stub import StubPredictor
from torch_parity import t

STEPS = 60
# The two packages' least-squares (s, t) of one image: f32 normal equations
# over ~40 correspondences summed in two orders, 2.5e-4 relative in s and
# 4.9e-4 in t apart at most on this scene (measured; s and t move against
# each other along the fit's ill-conditioned direction).
FIT_S_RTOL = 5e-4
FIT_T_ATOL = 1e-3
CAPACITY = 480  # the first refine (step 20) grows 193 to 386, the second fills it


def _cfg(C, S, data_dir, result_dir, impl):
    c = C(
        data_dir=data_dir, data_factor=1, result_dir=result_dir, max_steps=STEPS, eval_steps=[STEPS],
        save_steps=[], test_every=4, sh_degree=1, sh_degree_interval=20, max_gaussians=CAPACITY,
        pair_capacity=1 << 15, rasterizer_impl=impl, wire8=False, sort_bf16=False, mesh="off",
        data_prefetch=0, tb_every=20, init_type="monocular_depth",
        strategy=S(refine_start_iter=10, refine_every=20, reset_every=50, grow_grad2d=2e-5),
    )
    c.mdi.predictor = "stub"
    c.mdi.use_cache = False
    c.mdi.alignment.method = "lstsqrs"
    return c


def _oracle_stub(cls, scene, parser):
    """The stub (0.37 depth + 1.3) over the scene's surface depth, NaN
    where alpha <= 0.3, with each observed SfM point's own depth at its
    pixel, in trainset order."""
    from gs_init_tpu_torch.datasets import colmap_io

    rec = colmap_io.read_reconstruction(os.path.join(parser.data_dir, "sparse/0"))
    xyz = dict(zip(rec.point_ids.tolist(), rec.points_xyz))
    depths = []
    for i in parser.split_indices("train"):
        d = np.where(scene.alphas[i] > 0.3, scene.surface_depths[i], np.nan).astype(np.float32)
        w2c = np.linalg.inv(scene.camtoworlds[i])
        im = rec.images[int(i) + 1]
        for pid, (x, y) in zip(im.point3D_ids.tolist(), im.xys):
            d[int(y), int(x)] = (xyz[pid] @ w2c[:3, :3].T + w2c[:3, 3])[2]
        depths.append(d)
    calls = iter(range(10**6))
    stub = cls(oracle=lambda image, intr: depths[next(calls) % len(depths)])
    stub.depth_max = max(float(np.nanmax(d)) for d in depths)
    return stub


def _fits(module, mp):
    """Each image's (scale, shift) from ``module``'s points_from_depth."""
    fits, real = [], module.points_from_depth

    def spy(*a, **kw):
        out = real(*a, **kw)
        fits.append((float(out.scale), float(out.shift)))
        return out

    mp.setattr(module, "points_from_depth", spy)
    return fits


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("full_path")
    scene = synthetic.make_clustered_scene(seed=3, n_fg=200, n_bg=600, n_cams=8, width=64, height=48,
                                           device="cpu")
    data_dir = synthetic.write_colmap_scene(str(tmp / "scene"), scene, n_points=60)
    jcfg = _cfg(JConfig, JDefault, data_dir, str(tmp / "jax"), "xla")
    pcfg = _cfg(Config, DefaultStrategyConfig, data_dir, str(tmp / "port"), "auto")
    jparser, pparser = JParser(data_dir, factor=1, test_every=4), Parser(data_dir, factor=1, test_every=4)
    with pytest.MonkeyPatch.context() as mp:
        jfits, pfits = _fits(jinit, mp), _fits(pinit, mp)
        stub = _oracle_stub(StubPredictor, scene, pparser)
        jr = JRunner(jcfg, parser=jparser, mdi_model=_oracle_stub(JStub, scene, jparser))
        pr = Runner(pcfg, parser=pparser, mdi_model=stub, device="cpu")
    alive0 = [np.asarray(r.gstate.alive) for r in (jr, pr)]
    clouds = [
        (np.asarray(r.gstate.params.means)[a], np.asarray(r.gstate.params.sh0)[a])
        for r, a in zip((jr, pr), alive0)
    ]
    pr.load(jr.save(0))  # the same initial gaussians, Adam state and statistics
    order = np.random.default_rng(3).integers(0, len(pr.trainset), STEPS).tolist()

    noise = []
    refine = jr._refine_jit

    def spy(gstate, adam, sstate, key, *rest):
        k1, k2 = jax.random.split(key)
        cap = gstate.params.means.shape[0]
        noise.append([np.asarray(jax.random.normal(k, (cap, 3))) for k in (k1, k2)])
        return refine(gstate, adam, sstate, key, *rest)

    jr._refine_jit = spy
    corners = np.array([[x, y, 1.0] for x in (0, scene.width) for y in (0, scene.height)])
    out = dict(alive0=alive0, clouds=clouds, n_sfm=len(pparser.points), fits=(np.array(jfits), np.array(pfits)),
               k=float(np.cbrt(np.linalg.det(pparser.transform[:3, :3]))),
               pred_max=stub.scale * stub.depth_max + stub.shift,
               ray_max=float(np.linalg.norm(corners @ np.linalg.inv(scene.Ks[0]).T, axis=1).max()))
    mp = pytest.MonkeyPatch()
    try:
        for name, r in (("jax", jr), ("port", pr)):
            it = iter(order)
            r._next_batch = lambda r=r, it=it: r._build_batch([next(it)])
            losses, alive = [], {}
            for step in range(STEPS):
                losses.append(float(r.train_iteration(step)["loss"]))
                if step in (20, 40):
                    alive[step] = int(np.asarray(r.gstate.alive).sum()) if name == "jax" else num_alive(r.gstate)
            if name == "jax":
                eps = iter(noise)
                mp.setattr(pdefault, "split_noise", lambda cap, gen, dev: tuple(t(e) for e in next(eps)))
            out[name] = dict(losses=np.array(losses), alive=alive, eval=r.eval(STEPS))
        out["port_ckpt"] = pr.save(STEPS)
    finally:
        mp.undo()
    out["n_refines"] = len(noise)
    out["data_dir"], out["tmp"] = data_dir, tmp
    return out


def test_init_fits_match_jax(runs):
    jf, pf = runs["fits"]
    assert len(jf) == len(pf) == 6
    # Each fit undoes the stub's 0.37 up to the parser's similarity scale.
    assert abs(np.median(pf[:, 0]) * 0.37 / runs["k"] - 1) < 1e-3
    np.testing.assert_allclose(pf[:, 0], jf[:, 0], rtol=FIT_S_RTOL)
    np.testing.assert_allclose(pf[:, 1], jf[:, 1], rtol=0, atol=FIT_T_ATOL)


def test_init_clouds_match_jax(runs):
    (ja, pa), ((jm, jc), (pm, pc)) = runs["alive0"], runs["clouds"]
    np.testing.assert_array_equal(pa, ja)
    assert runs["n_sfm"] < ja.sum() < CAPACITY  # depth points beside the SfM points
    np.testing.assert_array_equal(pc, jc)
    # A depth point moves by the fits' gap at its prediction, along its ray.
    s = float(np.abs(runs["fits"][0][:, 0]).max())
    bound = (FIT_S_RTOL * s * runs["pred_max"] + FIT_T_ATOL) * runs["ray_max"]
    extent = float(np.abs(jm).max())
    np.testing.assert_allclose(pm / extent, jm / extent, rtol=0, atol=bound / extent + 1e-6)


def test_losses_match_jax(runs):
    jl, pl = runs["jax"]["losses"], runs["port"]["losses"]
    assert runs["n_refines"] == 2 and np.isfinite(pl).all()
    np.testing.assert_allclose(pl[:21], jl[:21], rtol=5e-5)
    np.testing.assert_allclose(pl, jl, rtol=2e-3)


def test_refines_fill_the_capacity_alike(runs):
    ja, pa = runs["jax"]["alive"], runs["port"]["alive"]
    assert pa == ja
    assert int(runs["alive0"][1].sum()) < pa[20] < pa[40] == CAPACITY


def test_eval_psnr_matches_jax(runs):
    je, pe = runs["jax"]["eval"], runs["port"]["eval"]
    assert pe["psnr"] == pytest.approx(je["psnr"], abs=2e-3)
    assert pe["num_GS"] == je["num_GS"]


def test_eval_only_restart_reproduces_psnr(runs):
    res = str(runs["tmp"] / "restart")
    trainer.main(["default", f"--data_dir={runs['data_dir']}", "--data_factor=1", f"--result_dir={res}",
                  "--test_every=4", "--sh_degree=1", f"--max_gaussians={CAPACITY}", "--pair_capacity=32768",
                  f"--ckpt=[{runs['port_ckpt']}]"], device="cpu")
    with open(os.path.join(res, "stats", f"val_step{STEPS}.json")) as f:
        psnr = json.load(f)["psnr"]
    assert psnr == pytest.approx(runs["port"]["eval"]["psnr"], abs=1e-6)


def test_render_views_carries_the_pair_table_across_views(monkeypatch):
    """Ground-truth renders of a scene whose first view overflows the
    starting pair table: that view renders again with a table of at least
    its demand, the others once each, and every image equals a render with
    a table that never overflows."""
    rng = np.random.default_rng(0)
    n = 6000  # each covers most of the 12 tiles of 16x16: ~70k pairs
    pts = rng.uniform(-0.6, 0.6, (n, 3))
    quats, scales = rng.normal(size=(n, 4)), rng.uniform(0.3, 0.5, (n, 3))
    opac, rgbs = rng.uniform(0.2, 0.5, n), rng.uniform(0, 1, (n, 3))
    c2ws = np.stack([synthetic.look_at(np.array([3.0 * np.cos(a), 0.0, 3.0 * np.sin(a)]), np.zeros(3))
                     for a in (0.0, 0.4, 0.8)])
    K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])
    Ks = np.tile(K, (3, 1, 1))
    calls = []
    real = synthetic.rasterize

    def counted(*a, **kw):
        out = real(*a, **kw)
        calls.append((kw["pair_capacity"], int(out[2].overflow), int(out[2].binning.tile_starts[-1])))
        return out

    monkeypatch.setattr(synthetic, "rasterize", counted)
    got = synthetic.render_views(pts, quats, scales, opac, rgbs, c2ws, Ks, 64, 48, device="cpu")
    assert calls[0][1] > 0 and len(calls) == 4 and all(c[1] == 0 for c in calls[1:])
    assert calls[1][0] >= calls[0][2] + calls[0][1]  # the demand of the view that overflowed
    monkeypatch.setattr(synthetic, "rasterize", real)
    ts = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    for i in range(3):
        render, alpha, _ = real(ts(pts), ts(quats), ts(scales), ts(opac), ts(rgbs),
                                torch.linalg.inv(ts(c2ws[i]))[None], ts(K)[None], 64, 48,
                                render_mode="RGB+ED", tile_size=16, pair_capacity=1 << 20)
        np.testing.assert_array_equal(got[0][i], render[0, ..., :3].clamp(0.0, 1.0).numpy())
        np.testing.assert_array_equal(got[1][i], alpha[0, ..., 0].numpy())
