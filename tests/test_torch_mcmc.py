"""The port's MCMC strategy against the JAX package's, from identical state.

``refine`` and ``add_noise`` take their randomness as tensors; the tests
rebuild the JAX package's draws (``categorical`` over the live opacities,
the ``normal`` of the noise) call for call and hand them over.

Tolerances: ``relocation_params`` within 1e-7 abs (new opacity) and 1e-5
relative (scale factor) of JAX at n = 1..8 (measured 6e-8 and 1.1e-6: the
51-term f32 sums add in another order). Against a float64 evaluation over
n = 1..51 both packages lose digits to the alternating sum's cancellation:
on this test's inputs the factor is off by up to 2.44e-4 relative for the
port and 2.59e-4 for JAX (both at n = 47, opacity 0.0052), the opacity by
4.6e-8; the test allows 1e-3 and 1e-7. The f32 sum is kept as the JAX
package computes it. ``refine``: alive and Adam moments exactly,
parameters within 1e-6. ``add_noise``: means within 1e-6 of their max.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import gammaln

from gs_init_tpu.config import MCMCStrategyConfig as JMCMC
from gs_init_tpu.engine import optim as jopt
from gs_init_tpu.engine.params import GaussianParams as JParams
from gs_init_tpu.engine.params import GaussianState as JState
from gs_init_tpu.engine.strategy import default as jdefault
from gs_init_tpu.engine.strategy import mcmc as jmcmc
from gs_init_tpu_torch.config import MCMCStrategyConfig
from gs_init_tpu_torch.device import generator
from gs_init_tpu_torch.engine import optim as popt
from gs_init_tpu_torch.engine.params import PARAM_NAMES, state_from_numpy
from gs_init_tpu_torch.engine.strategy import default as pdefault
from gs_init_tpu_torch.engine.strategy import mcmc
from torch_parity import CPU, n, t

CAP = 64


def _relocation_f64(opa, k):
    """Eq. 9 of 3DGS-MCMC in float64 (the same sum, no cancellation issue
    at these sizes)."""
    k = np.clip(k, 1, 51).astype(np.float64)
    opa = opa.astype(np.float64)
    new_o = 1.0 - (1.0 - opa) ** (1.0 / k)
    i = np.arange(1, 52, dtype=np.float64)
    on = i[None] <= k[:, None]
    log_binom = gammaln(k[:, None] + 1) - gammaln(i + 1) - gammaln(np.where(on, k[:, None] - i + 1, 1.0))
    terms = (np.where(i % 2 == 1, 1.0, -1.0) / np.sqrt(i)
             * np.exp(log_binom + i * np.log(np.maximum(new_o[:, None], 1e-12))))
    return new_o, opa / np.maximum(np.where(on, terms, 0.0).sum(1), 1e-12)


def _both(opa, k):
    jo, jf = (np.asarray(x) for x in jmcmc.relocation_params(jnp.asarray(opa), jnp.asarray(k)))
    po, pf = (n(x) for x in mcmc.relocation_params(t(opa), t(k)))
    return jo, jf, po, pf


def test_relocation_params_match_jax(rng):
    k = np.repeat(np.arange(1, 9), 40).astype(np.float32)
    opa = rng.uniform(0.005, 0.99, len(k)).astype(np.float32)
    jo, jf, po, pf = _both(opa, k)
    np.testing.assert_allclose(po, jo, rtol=0, atol=1e-7)
    np.testing.assert_allclose(pf, jf, rtol=1e-5, atol=0)


def test_relocation_params_against_float64(rng):
    k = np.repeat(np.arange(1, 52), 20).astype(np.float32)
    opa = rng.uniform(0.005, 0.99, len(k)).astype(np.float32)
    jo, jf, po, pf = _both(opa, k)
    wo, wf = _relocation_f64(opa, k)
    for o, f in ((jo, jf), (po, pf)):  # the JAX package, then the port
        np.testing.assert_allclose(o, wo, rtol=0, atol=1e-7)
        np.testing.assert_allclose(f, wf, rtol=1e-3, atol=0)


def _state(rng, n_alive=48, dead_frac=0.3):
    """Alive slots with opacities straddling min_opacity, free slots
    behind them; random Adam moments."""
    leaves = dict(
        means=rng.normal(size=(CAP, 3)),
        quats=rng.normal(size=(CAP, 4)),
        scales=rng.normal(-2.0, 0.5, (CAP, 3)),
        opacities=np.where(rng.uniform(size=CAP) < dead_frac, -7.0, rng.normal(0.0, 2.0, CAP)),
        sh0=rng.normal(size=(CAP, 1, 3)),
        shN=rng.normal(size=(CAP, 3, 3)),
    )
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    alive = np.arange(CAP) < n_alive
    moments = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in leaves.items()}
    return leaves, alive, moments


def _jax(leaves, alive, moments):
    g = JState(params=JParams(**{k: jnp.asarray(v) for k, v in leaves.items()}), alive=jnp.asarray(alive))
    mu = JParams(**{k: jnp.asarray(v) for k, v in moments.items()})
    return g, jopt.AdamState(mu=mu, nu=jax.tree.map(jnp.abs, mu), count=jnp.int32(3))


def _port(leaves, alive, moments):
    g = state_from_numpy(leaves, alive, CPU)
    return g, popt.adam_from_numpy(moments, {k: np.abs(v) for k, v in moments.items()}, 3, CPU)


def _jax_targets(key, g):
    """The draws of ``gs_init_tpu/engine/strategy/mcmc.py``'s refine."""
    opa = jax.nn.sigmoid(g.params.opacities)
    live = g.alive & ~(opa < 0.005)
    logits = jnp.where(live, jnp.log(jnp.maximum(opa, 1e-12)), -jnp.inf)
    k1, _ = jax.random.split(key)
    return t(jax.random.categorical(k1, logits, shape=(CAP,)), torch.long)


def _relocate_both(leaves, alive, moments, key, **cfg):
    jg, ja = _jax(leaves, alive, moments)
    targets = _jax_targets(key, jg)
    jg, ja, _ = jmcmc.refine(jg, ja, jdefault.init_state(CAP), key, JMCMC(**cfg))
    pg, pa = _port(leaves, alive, moments)
    pg, pa, _ = mcmc.refine(pg, pa, pdefault.init_state(CAP, CPU), targets, MCMCStrategyConfig(**cfg))
    return (jg, ja), (pg, pa)


def _assert_same(jg, ja, pg, pa):
    np.testing.assert_array_equal(n(pg.alive), np.asarray(jg.alive))
    for k in PARAM_NAMES:
        np.testing.assert_allclose(n(getattr(pg.params, k)), np.asarray(getattr(jg.params, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(n(getattr(pa.mu, k)), np.asarray(getattr(ja.mu, k)), err_msg=k)
        np.testing.assert_array_equal(n(getattr(pa.nu, k)), np.asarray(getattr(ja.nu, k)), err_msg=k)


def test_refine_matches_jax(rng):
    leaves, alive, moments = _state(rng)
    (jg, ja), (pg, pa) = _relocate_both(leaves, alive, moments, jax.random.PRNGKey(3))
    _assert_same(jg, ja, pg, pa)
    dead = alive & (1 / (1 + np.exp(-leaves["opacities"])) < 0.005)
    assert dead.sum() > 5
    # Dead slots became copies (moments zeroed), and the 5% tranche grew.
    assert (n(pa.mu.means)[dead] == 0).all()
    assert int(pg.alive.sum()) == int(np.float32(48) * np.float32(1.05))


def test_add_noise_matches_jax(rng):
    leaves, alive, _ = _state(rng)
    leaves["opacities"][:10] = 6.0  # opaque: the gate shuts
    key, lr = jax.random.PRNGKey(11), 1.6e-4 * 0.5
    jg, _ = _jax(leaves, alive, leaves)
    jg = jmcmc.add_noise(jg, key, lr, JMCMC())
    eps = t(jax.random.normal(key, (CAP, 3)))
    pg = mcmc.add_noise(state_from_numpy(leaves, alive, CPU), eps, lr, MCMCStrategyConfig())
    want = np.asarray(jg.params.means)
    scale = np.abs(want).max()
    np.testing.assert_allclose(n(pg.params.means) / scale, want / scale, rtol=0, atol=1e-6)
    moved = np.abs(n(pg.params.means) - leaves["means"]).max(-1) > 0
    faint = alive & (leaves["opacities"] == -7.0)  # opacity 9e-4: the gate is open
    assert faint.sum() > 5 and moved[faint].all()
    assert not moved[~alive].any() and not moved[:10].any()


def test_growth_stops_at_cap_max(rng):
    """Repeated relocations grow by the 5% tranche until cap_max, matching
    JAX at every round, and never pass it."""
    leaves, alive, moments = _state(rng, n_alive=40, dead_frac=0.0)
    jg, ja = _jax(leaves, alive, moments)
    pg, pa = _port(leaves, alive, moments)
    cfg = dict(cap_max=50)
    counts, want = [], []
    for r in range(6):
        want.append(min(50, int(np.float32(want[-1] if want else 40) * np.float32(1.05))))
        key = jax.random.PRNGKey(20 + r)
        targets = _jax_targets(key, jg)
        jg, ja, _ = jmcmc.refine(jg, ja, jdefault.init_state(CAP), key, JMCMC(**cfg))
        pg, pa, _ = mcmc.refine(pg, pa, pdefault.init_state(CAP, CPU), targets, MCMCStrategyConfig(**cfg))
        _assert_same(jg, ja, pg, pa)
        counts.append(int(pg.alive.sum()))
    assert counts == want and counts[-2:] == [50, 50], (counts, want)


def test_no_live_gaussian(rng):
    """Every alive gaussian dead: JAX's categorical over all -inf logits
    gives slot 0 everywhere; the port's draws do the same (no error), and
    the relocation matches."""
    leaves, alive, moments = _state(rng, dead_frac=1.0)
    opa, dead, live = mcmc.live_mask(state_from_numpy(leaves, alive, CPU), MCMCStrategyConfig())
    assert not bool(live.any()) and bool(dead.any())
    drawn = mcmc.draw_targets(opa, live, generator(0))
    assert bool((drawn == 0).all())
    key = jax.random.PRNGKey(5)
    np.testing.assert_array_equal(n(_jax_targets(key, _jax(leaves, alive, moments)[0])), np.zeros(CAP))
    (jg, ja), (pg, pa) = _relocate_both(leaves, alive, moments, key)
    _assert_same(jg, ja, pg, pa)


@pytest.mark.parametrize("seed", [0, 1])
def test_relocate_draws_live_slots(rng, seed):
    """The port's own draws: only live slots, in proportion to opacity."""
    leaves, alive, moments = _state(rng)
    g, a = _port(leaves, alive, moments)
    opa, _, live = mcmc.live_mask(g, MCMCStrategyConfig())
    drawn = mcmc.draw_targets(opa, live, generator(seed))
    assert bool(live[drawn].all())
    g, a, _ = mcmc.relocate(g, a, pdefault.init_state(CAP, CPU), generator(seed), MCMCStrategyConfig())
    assert int(g.alive.sum()) == int(np.float32(48) * np.float32(1.05))
