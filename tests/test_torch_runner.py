"""Parity: the port's Runner loop against the JAX Runner's, and what its
eval writes.

Both Runners train the same tiny scene for 30 steps with the dense oracle
(``rasterizer_impl="xla"``) on one device, from the same state (the JAX
Runner's initial gaussians, loaded into the port's through a checkpoint),
over the same batch order, with refines at steps 10 and 20 whose split
noise is the JAX Runner's own draws. Up to the first refine each step's
loss agrees within 5e-5 relative (f32 forward and backward in two
libraries; 1e-5 measured). A refine clones and splits every gaussian and
restarts their Adam moments, whose first steps are lr x sign(gradient):
rounding apart turns into whole steps apart. The JAX Runner against itself
with its initial means moved by 1e-7 relative drifts up to 5.1e-4 apart
after the refines (measured on this scene), so from there the losses agree
within 2e-3 relative. The refines leave the same gaussians alive, and the
final eval's PSNR agrees within 0.01 dB and its SSIM within 1e-3. The eval then reports LPIPS (random
weights under ``GS_TPU_CHECKPOINT_DIR``) within 1e-4 of the JAX Runner's,
and TensorBoard scalars at the JAX Runner's tags, readable by its tables.
"""
import json
import os

import jax
import numpy as np
import pytest

import gs_init_tpu.ops.lpips as JL
from gs_init_tpu.config import Config as JConfig
from gs_init_tpu.config import DefaultStrategyConfig as JDefault
from gs_init_tpu.engine.runner import Runner as JRunner
from gs_init_tpu.evaluation import tables as jtables
from gs_init_tpu_torch.config import Config, DefaultStrategyConfig
from gs_init_tpu_torch.datasets.synthetic import make_scene, write_colmap_scene
from gs_init_tpu_torch.engine.params import num_alive
from gs_init_tpu_torch.engine.runner import Runner
from gs_init_tpu_torch.engine.strategy import default as pdefault
from gs_init_tpu_torch.utils.tb import read_scalars
from test_torch_lpips import _weights, _write
from torch_parity import t

STEPS = 30


def _cfg(C, S, data_dir, result_dir):
    # Every candidate of a refine is cloned or split, and each split uses
    # the noise handed in; opacities are never reset within the run.
    return C(
        data_dir=data_dir, data_factor=1, result_dir=result_dir, max_steps=STEPS, eval_steps=[STEPS],
        save_steps=[], test_every=4, sh_degree=1, sh_degree_interval=10, max_gaussians=160,
        pair_capacity=1 << 14, rasterizer_impl="xla", wire8=False, sort_bf16=False, mesh="off",
        data_prefetch=0, tb_every=10,
        strategy=S(refine_start_iter=5, refine_every=10, reset_every=10_000, grow_grad2d=2e-5),
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runner")
    sc = make_scene(n_gaussians=80, n_cams=9, width=64, height=48, device="cpu")
    data_dir = write_colmap_scene(str(tmp / "scene"), sc, n_points=64)
    ckpt = tmp / "lpips"
    ckpt.mkdir()
    _write(ckpt, "npz", *_weights())
    jr = JRunner(_cfg(JConfig, JDefault, data_dir, str(tmp / "jax")))
    pr = Runner(_cfg(Config, DefaultStrategyConfig, data_dir, str(tmp / "port")), device="cpu")
    pr.load(jr.save(0))  # the same initial gaussians, Adam state and statistics
    order = np.random.default_rng(3).integers(0, len(pr.trainset), STEPS).tolist()
    assert len(pr.trainset) == len(jr.trainset)

    noise = []
    refine, split_noise = jr._refine_jit, pdefault.split_noise

    def spy(gstate, adam, sstate, key, *rest):
        k1, k2 = jax.random.split(key)
        cap = gstate.params.means.shape[0]
        noise.append([np.asarray(jax.random.normal(k, (cap, 3))) for k in (k1, k2)])
        return refine(gstate, adam, sstate, key, *rest)

    jr._refine_jit = spy
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setenv("GS_TPU_CHECKPOINT_DIR", str(ckpt))
    JL._load_params.cache_clear()
    try:
        for name, r in (("jax", jr), ("port", pr)):
            it = iter(order)
            r._next_batch = lambda r=r, it=it: r._build_batch([next(it)])
            losses, alive = [], []
            for step in range(STEPS):
                losses.append(float(r.train_iteration(step)["loss"]))
                alive.append(int(num_alive(r.gstate)) if name == "port" else int(np.asarray(r.gstate.alive).sum()))
            if name == "jax":
                eps = iter(noise)
                mp.setattr(pdefault, "split_noise", lambda cap, gen, dev: tuple(t(e) for e in next(eps)))
            out[name] = dict(losses=np.array(losses), alive=alive, eval=r.eval(STEPS))
        mp.setattr(pdefault, "split_noise", split_noise)
        # A whole train() of the port for its TensorBoard scalars.
        cfg = _cfg(Config, DefaultStrategyConfig, data_dir, str(tmp / "port_train"))
        Runner(cfg, device="cpu").train()
        out["tb_dir"] = cfg.result_dir
    finally:
        mp.undo()
        JL._load_params.cache_clear()
    out["n_refines"] = len(noise)
    return out


def test_loss_curve_matches_jax(runs):
    jl, pl = runs["jax"]["losses"], runs["port"]["losses"]
    assert runs["n_refines"] == 2 and np.isfinite(pl).all()
    np.testing.assert_allclose(pl[:11], jl[:11], rtol=5e-5)
    np.testing.assert_allclose(pl, jl, rtol=2e-3)
    assert pl[-1] < pl[0]


def test_refines_keep_the_same_gaussians(runs):
    assert runs["port"]["alive"] == runs["jax"]["alive"]
    assert runs["port"]["alive"][-1] != runs["port"]["alive"][0]  # the refines grew or pruned


def test_eval_matches_jax_with_lpips(runs):
    je, pe = runs["jax"]["eval"], runs["port"]["eval"]
    assert set(pe) == set(je) and "lpips" in pe
    assert pe["psnr"] == pytest.approx(je["psnr"], abs=1e-2)
    assert pe["ssim"] == pytest.approx(je["ssim"], abs=1e-3)
    assert pe["lpips"] == pytest.approx(je["lpips"], rel=1e-4)
    assert pe["num_GS"] == je["num_GS"]


def test_tensorboard_scalars_at_the_jax_tags(runs):
    d = runs["tb_dir"]
    scalars = read_scalars(os.path.join(d, "tb"))
    assert [s for s, _ in scalars["train/loss"]] == list(range(0, STEPS, 10))
    assert [s for s, _ in scalars["train/num_GS"]] == list(range(0, STEPS, 10))
    assert "train/mem_peak_gb" not in scalars  # no device memory statistics on the CPU
    with open(os.path.join(d, "stats", f"val_step{STEPS}.json")) as f:
        stats = json.load(f)
    for k, v in stats.items():
        assert scalars[f"val/{k}"] == [(STEPS, pytest.approx(v, rel=1e-6))]
    assert "lpips" in stats  # the fixture's weights
    row = jtables.read_tb_scalars(d, ["train/loss", "train/num_GS"])
    assert row["train/loss"] == pytest.approx(scalars["train/loss"][-1][1])
    assert row["train/num_GS"] == scalars["train/num_GS"][-1][1]
