"""Parity: the port's dense oracle (``ops/rasterize_ref.py``), ``render``
with ``impl="xla"`` and the clustered-scene fixture against the JAX package.

Tolerances: alpha and compositing within 1e-5 abs (f32, two libraries'
exp/log1p and summation orders); gradients within 1e-4 of each leaf's max
magnitude (autograd through cumulative sums in two orders); accumulated
depth (depths up to 4) within 1e-5 relative to its max; the fixture's
images within 1e-5 abs, its surface depths equal (an argmax; this scene has
no pixel whose top two compositing weights lie within 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_init_tpu.datasets.synthetic import make_clustered_scene as j_make_clustered
from gs_init_tpu.ops import rasterize_ref as jref
from gs_init_tpu.ops.projection import Projected as JProjected, project_gaussians as j_project
from gs_init_tpu.ops.render import rasterize as j_rasterize
from gs_init_tpu_torch.datasets.synthetic import make_clustered_scene
from gs_init_tpu_torch.ops import rasterize_ref as pref
from gs_init_tpu_torch.ops.projection import Projected
from gs_init_tpu_torch.ops.render import rasterize
from torch_parity import H, W, assert_close_scaled, n, scene, t

KEYS = ("means", "quats", "scales", "opacities", "colors")
PROJ_FIELDS = ("means2d", "conics", "depths", "radii", "opacities", "extents")


def _projected(rng, n_g=40, width=W, height=H, n_cams=1):
    """A JAX projection of a random scene, as numpy leaves."""
    sc = scene(rng, n_g=n_g, width=width, height=height)
    vm = np.repeat(sc["viewmats"], n_cams, 0)
    vm[1:, 0, 3] = 0.1  # a second camera shifted sideways
    proj = j_project(
        *(jnp.asarray(sc[k]) for k in KEYS[:4]), jnp.asarray(vm),
        jnp.asarray(np.repeat(sc["Ks"], n_cams, 0)), width, height,
    )
    cols = np.repeat(sc["colors"][None], n_cams, 0)
    return {f: np.asarray(getattr(proj, f)) for f in PROJ_FIELDS}, cols


@pytest.mark.parametrize("tile_mode", ["none", "radii", "extents"])
def test_alpha_at(rng, tile_mode):
    p, _ = _projected(rng)
    pix = np.asarray(jref._pixel_grid(W, H))
    kw_j, kw_p = {}, {}
    if tile_mode != "none":
        kw_j = dict(radii=jnp.asarray(p["radii"][0]), tile_size=16)
        kw_p = dict(radii=t(p["radii"][0], torch.int32), tile_size=16)
        if tile_mode == "extents":
            kw_j["extents"] = jnp.asarray(p["extents"][0])
            kw_p["extents"] = t(p["extents"][0], torch.int32)
    valid = p["radii"][0] > 0
    want = jref.alpha_at(
        jnp.asarray(p["means2d"][0]), jnp.asarray(p["conics"][0]), jnp.asarray(p["opacities"][0]),
        jnp.asarray(valid), jnp.asarray(pix), **kw_j,
    )
    got = pref.alpha_at(
        t(p["means2d"][0]), t(p["conics"][0]), t(p["opacities"][0]),
        torch.as_tensor(valid), t(pix), **kw_p,
    )
    np.testing.assert_array_equal(n(got) > 0, n(want) > 0)
    np.testing.assert_allclose(n(got), n(want), atol=1e-5)
    np.testing.assert_array_equal(n(pref.pixel_grid(W, H)), pix)


def test_composite_chunk_values_and_grads(rng):
    n_g, npix = 24, 50
    alpha = rng.uniform(0, 0.9, (n_g, npix)).astype(np.float32)
    alpha[rng.uniform(size=alpha.shape) < 0.3] = 0.0
    colors = rng.uniform(0, 1, (n_g, 3)).astype(np.float32)
    depths = rng.uniform(1, 4, n_g).astype(np.float32)
    t_in = rng.uniform(0.2, 1, npix).astype(np.float32)
    wts = [rng.normal(size=s).astype(np.float32) for s in ((npix, 3), (npix,), (npix,), (npix,))]

    def j_loss(a, c, d, ti):
        outs = jref.composite_chunk(a, c, d, ti)
        return sum(jnp.sum(o * w) for o, w in zip(outs, wts)), outs

    (jl, jout), jg = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(x) for x in (alpha, colors, depths, t_in))
    )
    leaves = [t(x).requires_grad_(True) for x in (alpha, colors, depths, t_in)]
    pout = pref.composite_chunk(*leaves)
    pl = sum((o * t(w)).sum() for o, w in zip(pout, wts))
    pg = torch.autograd.grad(pl, leaves)
    for a, b in zip(pout, jout):
        np.testing.assert_allclose(n(a), n(b), atol=1e-5)
    for name, a, b in zip(("alpha", "colors", "depths", "t_in"), pg, jg):
        assert_close_scaled(a, b, 1e-4, err_msg=name)


@pytest.mark.parametrize("tile_size,pixel_chunk", [(None, 4096), (16, 1000)])
def test_rasterize_reference_values_and_grads(rng, tile_size, pixel_chunk):
    p, cols = _projected(rng, n_g=32, n_cams=2)
    bg = rng.uniform(0, 1, (2, 3)).astype(np.float32)
    wts = [rng.normal(size=s).astype(np.float32) for s in ((2, H, W, 3), (2, H, W), (2, H, W))]
    diff = ("means2d", "conics", "depths", "opacities")

    def j_loss(m2, co, de, op, c):
        pj = JProjected(
            means2d=m2, conics=co, depths=de, radii=jnp.asarray(p["radii"]), opacities=op,
            extents=jnp.asarray(p["extents"]),
        )
        outs = jref.rasterize_reference(
            pj, c, W, H, backgrounds=jnp.asarray(bg), pixel_chunk=pixel_chunk, tile_size=tile_size,
        )
        return sum(jnp.sum(o * w) for o, w in zip(outs, wts)), outs

    (_, jout), jg = jax.value_and_grad(j_loss, argnums=tuple(range(5)), has_aux=True)(
        *(jnp.asarray(p[k]) for k in diff), jnp.asarray(cols)
    )
    leaves = [t(p[k]).requires_grad_(True) for k in diff] + [t(cols).requires_grad_(True)]
    pp = Projected(
        means2d=leaves[0], conics=leaves[1], depths=leaves[2], radii=t(p["radii"], torch.int32),
        opacities=leaves[3], extents=t(p["extents"], torch.int32),
    )
    pout = pref.rasterize_reference(
        pp, leaves[4], W, H, backgrounds=t(bg), pixel_chunk=pixel_chunk, tile_size=tile_size
    )
    pl = sum((o * t(w)).sum() for o, w in zip(pout, wts))
    pg = torch.autograd.grad(pl, leaves)
    color, alpha, depth = (n(o) for o in pout)
    assert color.shape == (2, H, W, 3) and alpha.shape == depth.shape == (2, H, W)
    assert alpha.max() > 0.5
    np.testing.assert_allclose(color, n(jout[0]), atol=1e-5)
    np.testing.assert_allclose(alpha, n(jout[1]), atol=1e-5)
    np.testing.assert_allclose(depth / np.abs(depth).max(), n(jout[2]) / np.abs(depth).max(), atol=1e-5)
    for name, a, b in zip(diff + ("colors",), pg, jg):
        assert float(np.abs(n(b)).max()) > 0, name
        assert_close_scaled(a, b, 1e-4, err_msg=name)


def test_render_xla_values_and_grads(rng):
    """``render(impl="xla")`` against the JAX one, through projection, with
    RGB+ED, a background and the means2d tap."""
    sc = scene(rng, n_g=36)
    bg = np.array([[0.2, 0.3, 0.4]], np.float32)
    target = rng.uniform(size=(1, H, W, 4)).astype(np.float32)
    kw = dict(render_mode="RGB+ED", tile_size=16, impl="xla", pixel_chunk=2048)

    def j_loss(m, q, s, o, col, dummy):
        render, alpha, _ = j_rasterize(
            m, q, s, o, col, jnp.asarray(sc["viewmats"]), jnp.asarray(sc["Ks"]), W, H,
            means2d_dummy=dummy, backgrounds=jnp.asarray(bg), **kw,
        )
        return jnp.mean((jnp.nan_to_num(render) - target) ** 2) + 0.1 * jnp.mean(alpha), (render, alpha)

    jin = [jnp.asarray(sc[k]) for k in KEYS] + [jnp.zeros((1, 36, 2))]
    (jl, (jr, ja)), jg = jax.value_and_grad(j_loss, argnums=tuple(range(6)), has_aux=True)(*jin)
    pin = [t(sc[k]).requires_grad_(True) for k in KEYS] + [torch.zeros((1, 36, 2), requires_grad=True)]
    pr, pa, info = rasterize(
        *pin[:5], t(sc["viewmats"]), t(sc["Ks"]), W, H, means2d_dummy=pin[5], backgrounds=t(bg), **kw,
    )
    pl = torch.mean((torch.nan_to_num(pr) - t(target)) ** 2) + 0.1 * torch.mean(pa)
    pg = torch.autograd.grad(pl, pin)
    assert int(info.overflow) == 0 and info.binning is None
    np.testing.assert_allclose(n(pa), n(ja), atol=1e-5)
    np.testing.assert_allclose(n(pr)[..., :3], n(jr)[..., :3], atol=1e-5)
    sig = n(ja)[..., 0] > 1e-2  # expected depth is only defined where alpha is
    np.testing.assert_allclose(n(pr)[..., 3][sig], n(jr)[..., 3][sig], rtol=1e-5)
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-5)
    for name, a, b in zip(list(KEYS) + ["means2d_dummy"], pg, jg):
        assert float(np.abs(n(b)).max()) > 0, name
        assert_close_scaled(a, b, 1e-4, err_msg=name)


def test_make_clustered_scene_matches_jax():
    kw = dict(seed=3, n_fg=40, n_bg=24, n_cams=3, width=40, height=30)
    js = j_make_clustered(**kw)
    ps = make_clustered_scene(**kw, device="cpu")
    for k in ("points", "rgbs", "camtoworlds", "Ks"):
        np.testing.assert_array_equal(getattr(ps, k), getattr(js, k), err_msg=k)
    np.testing.assert_allclose(ps.images, js.images, atol=1e-5)
    np.testing.assert_allclose(ps.alphas, js.alphas, atol=1e-5)
    cover = js.alphas > 1e-2
    np.testing.assert_allclose(ps.depths[cover], js.depths[cover], rtol=1e-5)
    assert (js.surface_depths > 0).mean() > 0.3
    # The argmax of the weights picks one gaussian's depth: equal, since no
    # pixel of this scene has its top two weights within 1e-6 of each other.
    np.testing.assert_array_equal(ps.surface_depths, js.surface_depths)


@pytest.mark.parametrize("options", [False, True], ids=["default", "bkgd-mask-depth-regs-absgrad"])
def test_train_step_xla_matches_jax(rng, options):
    """One train step through the dense oracle (``rasterizer_impl="xla"``),
    the port's against the JAX package's from identical state: the loss,
    the Adam moments and the densification statistics (the oracle has no
    absgrad tap: both packages then take the screen-space gradients)."""
    from gs_init_tpu.engine import optim as jopt
    from gs_init_tpu.engine.strategy import default as jstrat
    from gs_init_tpu.engine.train_step import AuxParams, init_aux_opt
    from gs_init_tpu.engine.train_step import make_train_step as j_make_step
    from gs_init_tpu_torch.engine import optim as popt
    from gs_init_tpu_torch.engine.params import PARAM_NAMES, state_from_numpy
    from gs_init_tpu_torch.engine.strategy import default as pstrat
    from gs_init_tpu_torch.engine.train_step import AuxParams as PAux
    from gs_init_tpu_torch.engine.train_step import init_aux_opt as p_init_aux_opt
    from gs_init_tpu_torch.engine.train_step import make_train_step
    from test_torch_train_step import CAP, _batches, _configs, _initial_state, _jax_state
    from torch_parity import CPU

    jcfg, pcfg = _configs(options)
    jcfg.rasterizer_impl = pcfg.rasterizer_impl = "xla"
    sc, leaves, alive = _initial_state(rng)
    jb, pb = _batches(rng, sc, options)
    jacfg, pacfg = jopt.make_adam_config(jcfg, 2.0), popt.make_adam_config(pcfg, 2.0)
    jg = _jax_state(leaves, alive)
    aux = AuxParams()
    key = jax.random.PRNGKey(100)
    _, ja, js, _, _, jm = j_make_step(jcfg, jacfg, W, H)(
        jg, jopt.init_adam_state(jg.params), jstrat.init_state(CAP), aux, init_aux_opt(aux), jb,
        jnp.int32(0), key,
    )
    pg = state_from_numpy(leaves, alive, CPU)
    bkgd = t(jax.random.uniform(key, (1, 3))) if options else None
    paux = PAux()
    _, pa, ps, _, _, pm = make_train_step(pcfg, pacfg, W, H)(
        pg, popt.init_adam_state(pg.params), pstrat.init_state(CAP, CPU), paux, p_init_aux_opt(paux),
        pb, 0, bkgd=bkgd,
    )
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert int(pm["overflow"]) == 0 and int(pm["pairs"]) == 0
    for k in PARAM_NAMES:
        assert_close_scaled(getattr(pa.mu, k), getattr(ja.mu, k), 1e-4, err_msg=f"mu {k}")
    np.testing.assert_array_equal(n(ps.count), np.asarray(js.count))
    assert_close_scaled(ps.grad2d, js.grad2d, 1e-4, err_msg="grad2d")
