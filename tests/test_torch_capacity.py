"""An init cloud above the capacity: the port's uniform random subset, and
a Runner that starts with a full buffer under both presets.

The two packages draw the subset with different generators
(``torch.randperm`` on the cloud's device, ``jax.random.choice``), so the
subset is checked in two parts: (a) the port keeps ``capacity`` distinct
rows of the cloud, each with its own colour; (b) on exactly those rows, in
the port's order, JAX's ``init_from_points`` at N == capacity gives the
same scales, ``sh0`` and opacities, within 1e-6 of each buffer's largest
magnitude. Then a tiny Runner whose SfM cloud exceeds ``max_gaussians``
announces the subset, starts with alive == capacity and stays within it
through its refines (the default preset: granted slots never exceed the
free ones) or relocations (mcmc: within min(cap_max, capacity)).
"""
import numpy as np
import pytest
import torch

from gs_init_tpu.engine.params import init_from_points as j_init
from gs_init_tpu_torch import trainer
from gs_init_tpu_torch.datasets.synthetic import make_scene, write_colmap_scene
from gs_init_tpu_torch.engine.params import init_from_points, num_alive, rgb_to_sh0
from gs_init_tpu_torch.engine.runner import Runner
from gs_init_tpu_torch.engine.strategy import default as pdefault
from gs_init_tpu_torch.engine.strategy import mcmc as pmcmc
from torch_parity import n

RTOL = 1e-6
N_CLOUD, CAP = 64, 40


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(N_CLOUD, 3)).astype(np.float32)
    rgb = rng.uniform(0, 1, (N_CLOUD, 3)).astype(np.float32)
    gen = torch.Generator().manual_seed(7)
    g = init_from_points(torch.as_tensor(pts), torch.as_tensor(rgb), CAP, sh_degree=1, init_opacity=0.2,
                         generator=gen)
    return pts, rgb, g


def _rows(pts, means):
    """Each row of ``means``' index in ``pts`` (exact equality), -1 if none."""
    eq = (means[:, None, :] == pts[None, :, :]).all(-1)
    return np.where(eq.any(1), eq.argmax(1), -1)


def test_subset_is_distinct_rows_with_their_colours(cloud):
    pts, rgb, g = cloud
    alive = n(g.alive)
    assert alive.sum() == CAP and alive[:CAP].all()
    rows = _rows(pts, n(g.params.means)[:CAP])
    assert (rows >= 0).all(), "a kept mean is not a row of the cloud"
    assert len(np.unique(rows)) == CAP, "the subset repeats a row (a draw with replacement)"
    np.testing.assert_array_equal(n(g.params.sh0)[:CAP, 0], n(rgb_to_sh0(torch.as_tensor(rgb[rows]))))
    # Not the head of the cloud: the cloud is image-ordered in a real init.
    assert not np.array_equal(np.sort(rows), np.arange(CAP))


def test_subset_init_matches_jax_on_its_rows(cloud):
    pts, rgb, g = cloud
    rows = _rows(pts, n(g.params.means)[:CAP])
    j = j_init(pts[rows], rgb[rows], CAP, sh_degree=1, init_opacity=0.2)
    assert np.asarray(j.alive).all()
    for name in ("means", "scales", "opacities", "sh0", "shN"):
        got, want = n(getattr(g.params, name)), np.asarray(getattr(j.params, name))
        assert got.shape == want.shape
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=RTOL, err_msg=name)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    sc = make_scene(n_gaussians=64, n_cams=6, width=64, height=48, device="cpu")
    return write_colmap_scene(str(tmp_path_factory.mktemp("capacity")), sc, n_points=N_CLOUD)


def _runner(preset, data_dir, result_dir):
    cfg = trainer.build_presets()[preset]
    cfg.data_dir, cfg.data_factor, cfg.result_dir = data_dir, 1, result_dir
    cfg.max_steps, cfg.eval_steps, cfg.save_steps = 7, [], []
    cfg.test_every, cfg.sh_degree, cfg.max_gaussians = 3, 1, CAP
    cfg.pair_capacity, cfg.mesh, cfg.data_prefetch = 1 << 14, "off", 0
    s = cfg.strategy
    s.refine_start_iter, s.refine_every = 1, 3  # refines or relocations at steps 3 and 6
    if preset == "default":
        # Every visible gaussian is a candidate; gaussians whose opacity
        # fell below the initial 0.1 are pruned, which frees slots that the
        # next refine grants.
        s.grow_grad2d, s.prune_opa, s.reset_every = 1e-12, 0.0999, 10_000
    else:
        # Opacities rise from the preset's 0.5 over the first steps here;
        # min_opacity within their spread makes some gaussians dead.
        s.cap_max, s.min_opacity = 10 * CAP, 0.53
    return Runner(cfg, device="cpu")


@pytest.mark.parametrize("preset", ["default", "mcmc"])
def test_runner_starts_full_and_stays_within_capacity(preset, data_dir, tmp_path, capsys, monkeypatch):
    grants, relocations = [], []
    alloc, relocate = pdefault._alloc_slots, pmcmc.refine

    def spy_alloc(alive, cand):
        dst, ok = alloc(alive, cand)
        grants.append((int(cand.sum()), int((~alive).sum()), int(ok.sum())))
        return dst, ok

    def spy_relocate(gstate, adam, sstate, targets, cfg):
        n_dead = int(pmcmc.live_mask(gstate, cfg)[1].sum())
        out = relocate(gstate, adam, sstate, targets, cfg)
        relocations.append((n_dead, int(num_alive(out[0]))))
        return out

    monkeypatch.setattr(pdefault, "_alloc_slots", spy_alloc)
    monkeypatch.setattr(pmcmc, "refine", spy_relocate)
    r = _runner(preset, data_dir, str(tmp_path))
    assert f"init points {N_CLOUD} exceed capacity {CAP}; keeping a uniform random subset" in capsys.readouterr().out
    assert num_alive(r.gstate) == CAP
    means = n(r.gstate.params.means)
    assert len(np.unique(means, axis=0)) == CAP
    alive = []
    for step in range(r.cfg.max_steps):
        assert np.isfinite(float(r.train_iteration(step)["loss"]))
        alive.append(num_alive(r.gstate))
    assert max(alive) <= CAP
    if preset == "default":
        assert len(grants) == 2 and not relocations
        assert all(granted <= free for _, free, granted in grants)
        (c0, f0, g0), (c1, f1, g1) = grants
        assert f0 == g0 == 0 and c0 > 0  # a full buffer: every candidate dropped
        assert 0 < g1 == min(c1, f1)  # the slots the first refine's pruning freed, granted
    else:
        assert len(relocations) == 2 and not grants
        assert all(a <= min(r.cfg.strategy.cap_max, CAP) for _, a in relocations)
        assert sum(d for d, _ in relocations) > 0  # dead gaussians relocated onto a full buffer
