"""The port's pose / appearance / bilateral-grid modules against the JAX
package's: every function of ``engine/appearance.py`` (values and
gradients, CP4D included) on the same numpy inputs and the JAX package's
own initial parameters carried across, then one train step with each aux
group on against the JAX step, both with the dense rasterizer
(``rasterizer_impl="xla"``), from the same state.

Tolerances: values within 1e-5 abs (1e-5 of the max where magnitudes
grow, through 3x3 and MLP products summed in other orders); gradients
within 1e-5 of each leaf's max magnitude. ``color_correct``: JAX solves in
f32 by SVD, the port in float64 by the normal matrix's pseudo-inverse; the
outputs agree within 1e-4 abs (measured 2e-6 here), and on a constant image
(rank 1) both give each channel its reference mean. The train step: loss
within 1e-5 relative; gaussian and aux Adam moments within 1e-4 of each
leaf's max (f32 gradient sums in two orders, as tests/test_torch_train_step.py);
each aux leaf's move within 1e-3 of its largest move. ``simple_adam_update``
alone: params' moves and moments within 1e-6 of each leaf's max.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_init_tpu.config import Config as JConfig
from gs_init_tpu.config import DefaultStrategyConfig as JStrategy
from gs_init_tpu.engine import appearance as ja
from gs_init_tpu.engine import optim as jopt
from gs_init_tpu.engine.params import GaussianParams as JParams
from gs_init_tpu.engine.params import GaussianState as JState
from gs_init_tpu.engine.params import init_from_points as j_init
from gs_init_tpu.engine.strategy import default as jstrat
from gs_init_tpu.engine.train_step import AuxParams as JAux
from gs_init_tpu.engine.train_step import Batch as JBatch
from gs_init_tpu.engine.train_step import init_aux_opt as j_init_aux_opt
from gs_init_tpu.engine.train_step import make_train_step as j_make_step
from gs_init_tpu_torch.config import Config, DefaultStrategyConfig
from gs_init_tpu_torch.device import generator
from gs_init_tpu_torch.engine import appearance as pa
from gs_init_tpu_torch.engine import optim as popt
from gs_init_tpu_torch.engine.params import PARAM_NAMES, aux_from_numpy, aux_leaves, state_from_numpy
from gs_init_tpu_torch.engine.strategy import default as pstrat
from gs_init_tpu_torch.engine.train_step import Batch, init_aux_opt, make_train_step
from torch_parity import CPU, H, W, assert_close_scaled, n, scene, t


def _grads(fn_torch, fn_jax, args, cot_shape=None, rng=None):
    """Values and the VJP of a random cotangent, torch vs JAX, for every
    argument (numpy arrays). Returns (pv, jv, pgrads, jgrads)."""
    targs = [t(a).requires_grad_(True) for a in args]
    pv = fn_torch(*targs)
    cot = (rng or np.random.default_rng(1)).normal(size=tuple(pv.shape)).astype(np.float32)
    pg = torch.autograd.grad((pv * t(cot)).sum(), targs, allow_unused=True)
    jv, vjp = jax.vjp(jax.jit(fn_jax), *[jnp.asarray(a) for a in args])
    jg = vjp(jnp.asarray(cot))
    return n(pv), np.asarray(jv), [n(g) if g is not None else 0 * a for g, a in zip(pg, args)], jg


def _assert_grads(pg, jg, atol=1e-5):
    for i, (p, j) in enumerate(zip(pg, jg)):
        assert_close_scaled(p, j, atol, err_msg=f"grad of argument {i}")


def test_pose_functions_match_jax(rng):
    d6 = rng.normal(size=(7, 6)).astype(np.float32)
    pv, jv, pg, jg = _grads(pa.rotation_6d_to_matrix, ja.rotation_6d_to_matrix, [d6])
    np.testing.assert_allclose(pv, jv, atol=1e-6)
    _assert_grads(pg, jg)
    np.testing.assert_array_equal(n(pa.init_pose_params(5)), np.asarray(ja.init_pose_params(5)))
    noisy = pa.init_pose_params(5, std=0.1, generator=generator(0))
    assert noisy.shape == (5, 9) and 0 < float(noisy.abs().max()) < 1.0

    c2w = rng.normal(size=(3, 4, 4)).astype(np.float32)
    pose = (rng.normal(size=(5, 9)) * 0.1).astype(np.float32)
    ids = np.array([0, 2, 4])
    pv, jv, pg, jg = _grads(
        lambda c, p: pa.apply_pose_deltas(c, p, torch.as_tensor(ids)),
        lambda c, p: ja.apply_pose_deltas(c, p, jnp.asarray(ids)), [c2w, pose],
    )
    np.testing.assert_allclose(pv, jv, atol=1e-5)
    _assert_grads(pg, jg)


def _j_app(n_images=3, cap=20, sh_degree=2):
    return ja.init_appearance_params(jax.random.PRNGKey(0), n_images, cap, sh_degree=sh_degree)


def test_appearance_colors_match_jax(rng):
    japp = _j_app()
    # Non-zero embeddings and features, so every input carries signal.
    japp = japp._replace(embeds=jnp.asarray(rng.normal(size=(3, 16)), jnp.float32),
                         features=jnp.asarray(rng.normal(size=(20, 32)), jnp.float32))
    names = list(japp._fields)
    leaves = [np.asarray(x) for x in japp]
    dirs = rng.normal(size=(2, 20, 3)).astype(np.float32)
    ids = np.array([0, 2])
    for active in (0, 1, 2):
        pv, jv, pg, jg = _grads(
            lambda d, *p: pa.appearance_colors(pa.AppearanceParams(*p), torch.as_tensor(ids), d, active, 2),
            lambda d, *p: ja.appearance_colors(ja.AppearanceParams(*p), jnp.asarray(ids), d, active, 2),
            [dirs] + leaves,
        )
        np.testing.assert_allclose(pv, jv, atol=1e-5, err_msg=f"active degree {active}")
        _assert_grads(pg, jg)
    # The port's own init: JAX's shapes, zeros where JAX has zeros, weights
    # within the Glorot-uniform limit sqrt(6 / (fan_in + fan_out)).
    mine = pa.init_appearance_params(generator(0), 3, 20, sh_degree=2)
    for name, j in zip(names, _j_app()):
        m = n(getattr(mine, name))
        assert m.shape == j.shape, name
        if name.startswith("w"):
            limit = np.sqrt(6.0 / sum(m.shape))
            assert 0 < np.abs(m).max() <= limit and np.abs(np.asarray(j)).max() <= limit
        else:
            np.testing.assert_array_equal(m, np.asarray(j))


def test_bilateral_grid_matches_jax(rng):
    np.testing.assert_array_equal(
        n(pa.init_bilateral_grids(3, (8, 6, 4))), np.asarray(ja.init_bilateral_grids(3, (8, 6, 4)))
    )
    grids = (np.asarray(ja.init_bilateral_grids(3, (8, 6, 4)))
             + rng.normal(0, 0.1, (3, 4, 6, 8, 12))).astype(np.float32)
    rgb = rng.uniform(0, 1, (2, 12, 16, 3)).astype(np.float32)
    rgb[0, :2] = 0.0  # grey exactly 0 and 1: the clip's tie gradients
    rgb[1, :2] = 1.0
    ids = np.array([2, 0])
    pv, jv, pg, jg = _grads(
        lambda g, c: pa.slice_bilateral_grid(g, c, torch.as_tensor(ids)),
        lambda g, c: ja.slice_bilateral_grid(g, c, jnp.asarray(ids)), [grids, rgb],
    )
    np.testing.assert_allclose(pv, jv, atol=1e-5)
    _assert_grads(pg, jg)
    pv, jv, pg, jg = _grads(pa.total_variation_loss, ja.total_variation_loss, [grids])
    np.testing.assert_allclose(pv, jv, rtol=1e-5)
    _assert_grads(pg, jg)


def test_color_correct_matches_jax(rng):
    ys, xs = np.mgrid[0:24, 0:32] / 32.0
    ref = np.stack([0.5 + 0.4 * np.sin(3 * xs), 0.5 + 0.4 * np.cos(2 * ys), 0.3 + 0.3 * (xs + ys)], -1)
    ref = np.clip(ref + rng.normal(0, 0.02, ref.shape), 0, 1).astype(np.float32)
    img = np.clip(0.8 * ref**1.3 + 0.05, 0, 1).astype(np.float32)
    got = n(pa.color_correct(t(img), t(ref)))
    np.testing.assert_allclose(got, np.asarray(ja.color_correct(jnp.asarray(img), jnp.asarray(ref))), atol=1e-4)
    assert np.abs(got - ref).mean() < np.abs(img - ref).mean() / 3


def test_color_correct_constant_image(rng):
    """A flat image makes the quadratic expansion rank 1; the minimum-norm
    fit is then each channel's reference mean, in both packages."""
    ref = rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
    for value in (0.0, 0.4, 1.0):
        img = np.full_like(ref, value)
        got = n(pa.color_correct(t(img), t(ref)))
        want = np.asarray(ja.color_correct(jnp.asarray(img), jnp.asarray(ref)))
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=f"value {value}")
        np.testing.assert_allclose(got, np.broadcast_to(ref.reshape(-1, 3).mean(0), ref.shape), atol=1e-5)


def _cp4d_leaves(p):
    """Flat (name, array) list of a CP4DGridParams of either package."""
    out = [("fac0", p.fac0)]
    out += [(f"init{i}", x) for i, x in enumerate(p.facs_init)]
    out += [(f"resid{i}", x) for i, x in enumerate(p.facs_resid)]
    for i, (w, b) in enumerate(p.gray_w):
        out += [(f"gw{i}", w), (f"gb{i}", b)]
    return out


def _cp4d_build(module, flat, n_gray):
    it = iter(flat)
    fac0 = next(it)
    init = tuple(next(it) for _ in range(4))
    resid = tuple(next(it) for _ in range(4))
    gray = tuple((next(it), next(it)) for _ in range(n_gray))
    return module.CP4DGridParams(fac0=fac0, facs_init=init, facs_resid=resid, gray_w=gray)


@pytest.mark.parametrize("learn_gray", [False, True])
def test_cp4d_grid_matches_jax(rng, learn_gray):
    jp = ja.init_cp4d_grid(jax.random.PRNGKey(0), grid_x=6, grid_y=5, grid_z=4, grid_w=3,
                           learn_gray=learn_gray)
    # Residuals away from zero so the TV loss and every factor carry signal.
    jp = jp._replace(facs_resid=tuple(jnp.asarray(rng.normal(0, 0.1, f.shape), jnp.float32)
                                      for f in jp.facs_resid))
    names, arrs = zip(*_cp4d_leaves(jp))
    arrs = [np.asarray(a) for a in arrs]
    n_gray = len(jp.gray_w)
    xyz = rng.uniform(-2.5, 2.5, (40, 3)).astype(np.float32)  # some beyond the bound
    rgb = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    for p_fn, j_fn in (
        (pa.slice_cp4d_grid, ja.slice_cp4d_grid),
        (pa.cp4d_apply, ja.cp4d_apply),
    ):
        pv, jv, pg, jg = _grads(
            lambda x, c, *f: p_fn(_cp4d_build(pa, f, n_gray), x, c),
            lambda x, c, *f: j_fn(_cp4d_build(ja, f, n_gray), x, c),
            [xyz, rgb] + arrs,
        )
        np.testing.assert_allclose(pv, jv, atol=1e-5, err_msg=p_fn.__name__)
        _assert_grads(pg, jg)
    pv, jv, pg, jg = _grads(
        lambda *f: pa.cp4d_tv_loss(_cp4d_build(pa, f, n_gray)),
        lambda *f: ja.cp4d_tv_loss(_cp4d_build(ja, f, n_gray)), arrs,
    )
    np.testing.assert_allclose(pv, jv, rtol=1e-5)
    _assert_grads(pg, jg)
    # The port's own init: JAX's shapes, the identity in column 0.
    mine = pa.init_cp4d_grid(generator(0), grid_x=6, grid_y=5, grid_z=4, grid_w=3, learn_gray=learn_gray)
    for (name, m), (_, j) in zip(_cp4d_leaves(mine), _cp4d_leaves(
            ja.init_cp4d_grid(jax.random.PRNGKey(0), grid_x=6, grid_y=5, grid_z=4, grid_w=3,
                              learn_gray=learn_gray))):
        assert tuple(m.shape) == j.shape, name
    np.testing.assert_array_equal(n(mine.fac0[:, 0]), np.eye(3, 4, dtype=np.float32).reshape(12))
    out = pa.cp4d_apply(mine, t(xyz), t(rgb))
    if not learn_gray:
        np.testing.assert_allclose(n(out), rgb, atol=1e-4)  # identity at init
    assert float(pa.cp4d_tv_loss(mine)) == 0.0


# ---------------------------------------------------------------- the step

CAP, N_PTS, N_IMAGES = 64, 48, 2
CFG = dict(sh_degree=2, sh_degree_interval=2, max_gaussians=CAP, pair_capacity=8192, tile_size=16,
           rasterizer_impl="xla", max_steps=100, pose_opt_lr=1e-3)
GROUPS = {
    "pose": dict(pose_opt=True),
    "app": dict(app_opt=True),
    "grid": dict(use_bilateral_grid=True, tv_lambda=1.0),
}


@pytest.mark.parametrize("group", list(GROUPS))
def test_train_step_with_aux_group_matches_jax(rng, group):
    """Two steps with one aux group on, the JAX step (dense rasterizer)
    against the port's, from the same state; the aux group starts from the
    JAX package's initial values perturbed, carried across."""
    kw = GROUPS[group]
    jcfg = JConfig(**CFG, **kw, strategy=JStrategy())
    pcfg = Config(**CFG, **kw, strategy=DefaultStrategyConfig())
    sc = scene(rng, n_g=N_PTS)
    g = j_init(jnp.asarray(sc["means"]), jnp.asarray(sc["colors"]), CAP, 2, init_opacity=0.4)
    leaves = {k: np.array(getattr(g.params, k)) for k in PARAM_NAMES}
    leaves["shN"] = (rng.normal(size=leaves["shN"].shape) * 0.1).astype(np.float32)
    leaves["means"][~np.array(g.alive)] = (0.0, 0.0, -1.0)  # dead slots behind the camera
    # Anisotropic scales, so the rotations get real (not rounding-noise) gradients.
    leaves["scales"] = (leaves["scales"] + rng.normal(0, 0.3, leaves["scales"].shape)).astype(np.float32)
    alive = np.array(g.alive)
    pose = (rng.normal(size=(N_IMAGES, 9)) * 0.01).astype(np.float32) if "pose_opt" in kw else None
    app = None
    if "app_opt" in kw:
        japp = ja.init_appearance_params(jax.random.PRNGKey(1), N_IMAGES, CAP, sh_degree=2)
        app = {k: np.asarray(v) for k, v in japp._asdict().items()}
        app["embeds"] = (rng.normal(size=app["embeds"].shape) * 0.1).astype(np.float32)
        app["features"] = (rng.normal(size=app["features"].shape) * 0.1).astype(np.float32)
    grids = None
    if "use_bilateral_grid" in kw:
        grids = (np.asarray(ja.init_bilateral_grids(N_IMAGES)) + rng.normal(0, 0.01, (N_IMAGES, 8, 16, 16, 12))
                 ).astype(np.float32)
    jaux = JAux(pose=None if pose is None else jnp.asarray(pose),
                app=None if app is None else ja.AppearanceParams(**{k: jnp.asarray(v) for k, v in app.items()}),
                grids=None if grids is None else jnp.asarray(grids))
    paux = aux_from_numpy(pose, app, grids, CPU)

    pixels = rng.uniform(size=(1, H, W, 3)).astype(np.float32)
    c2w = np.linalg.inv(sc["viewmats"]).astype(np.float32)
    jb = JBatch(camtoworlds=jnp.asarray(c2w), Ks=jnp.asarray(sc["Ks"]), pixels=jnp.asarray(pixels),
                image_ids=jnp.ones((1,), jnp.int32))
    pb = Batch(camtoworlds=t(c2w), Ks=t(sc["Ks"]), pixels=t(pixels), image_ids=torch.ones((1,), dtype=torch.long))
    jacfg, pacfg = jopt.make_adam_config(jcfg, 2.0), popt.make_adam_config(pcfg, 2.0)
    j_step, p_step = j_make_step(jcfg, jacfg, W, H), make_train_step(pcfg, pacfg, W, H)

    jg = JState(params=JParams(**{k: jnp.asarray(v) for k, v in leaves.items()}), alive=jnp.asarray(alive))
    jad, js, jopt_state = jopt.init_adam_state(jg.params), jstrat.init_state(CAP), j_init_aux_opt(jaux)
    pg = state_from_numpy(leaves, alive, CPU)
    pad, ps, popt_state = popt.init_adam_state(pg.params), pstrat.init_state(CAP, CPU), init_aux_opt(paux)
    p0 = [n(x).copy() for x in aux_leaves(paux)]
    j0 = [np.asarray(x).copy() for x in jax.tree_util.tree_leaves(jaux)]
    for step in range(2):
        jg, jad, js, jaux, jopt_state, jm = j_step(jg, jad, js, jaux, jopt_state, jb, jnp.int32(step),
                                                   jax.random.PRNGKey(step))
        pg, pad, ps, paux, popt_state, pm = p_step(pg, pad, ps, paux, popt_state, pb, step)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    for k in PARAM_NAMES:
        assert_close_scaled(getattr(pad.mu, k), getattr(jad.mu, k), 1e-4, err_msg=f"mu {k}")
    (jname, jstate), = [(k, v) for k, v in jopt_state._asdict().items() if v is not None]
    pstate = getattr(popt_state, jname)
    assert pstate.count == int(jstate.count) == 2
    for moment in ("mu", "nu"):
        jm_ = jax.tree_util.tree_leaves(getattr(jstate, moment))
        pm_ = aux_leaves(type(paux)(**{jname: getattr(pstate, moment)}))
        assert len(pm_) == len(jm_) > 0
        for i, (p, j) in enumerate(zip(pm_, jm_)):
            assert_close_scaled(p, j, 1e-4, err_msg=f"{group} {moment} {i}")
    # Each aux leaf's move over the two steps, against JAX's, within 1e-3 of
    # its largest move (about 2 lr), so 500 times below one step's size.
    # Adam divides each moment by the root of the second, which lifts the
    # f32 rounding of the smallest grid gradients: measured 4.6e-4 there,
    # 4.5e-5 for the appearance MLP, 2e-6 for the pose deltas.
    pl, jl = aux_leaves(paux), jax.tree_util.tree_leaves(jaux)
    assert len(pl) == len(jl) == len(p0)
    for i, (p, j, a, b) in enumerate(zip(pl, jl, p0, j0)):
        np.testing.assert_array_equal(a, b)
        moved = np.asarray(j) - b
        assert np.abs(moved).max() > 0, f"{group} leaf {i} did not move"
        assert_close_scaled(n(p) - a, moved, 1e-3, err_msg=f"{group} move of leaf {i}")
    assert int(pm["pairs"]) == 0 and int(pm["overflow"]) == 0  # the dense rasterizer


@pytest.mark.parametrize("tree", ["tensor", "appearance"])
def test_simple_adam_update_matches_jax(rng, tree):
    """Three AdamW-style steps over a tensor and over an AppearanceParams,
    with a weight decay (0.5) that adds about half the parameter's size to
    every gradient. The moves of the params and both moments within 1e-6 of
    each leaf's max (the same f32 operations in the same order); without the
    weight decay the params would have moved elsewhere by far more."""
    if tree == "tensor":
        start = {"x": rng.normal(size=(5, 9)).astype(np.float32)}
        jtree = lambda d: jnp.asarray(d["x"])
        ptree = lambda d: t(d["x"])
    else:
        japp = ja.init_appearance_params(jax.random.PRNGKey(3), 3, 20, sh_degree=1)
        start = {k: (np.asarray(v) + rng.normal(0, 0.1, v.shape)).astype(np.float32)
                 for k, v in japp._asdict().items()}
        jtree = lambda d: ja.AppearanceParams(**{k: jnp.asarray(v) for k, v in d.items()})
        ptree = lambda d: pa.AppearanceParams(**{k: t(v) for k, v in d.items()})
    grads = [{k: rng.normal(0, 0.3, v.shape).astype(np.float32) for k, v in start.items()} for _ in range(3)]
    lr, wd = 1e-2, 0.5

    def run_port(weight_decay):
        pp = ptree(start)
        state = popt.simple_adam_init(pp)
        for g in grads:
            state = popt.simple_adam_update(pp, ptree(g), state, lr=lr, weight_decay=weight_decay)
        return pp, state

    jp = jtree(start)
    jstate = jopt.simple_adam_init(jp)
    for g in grads:
        jp, jstate = jopt.simple_adam_update(jp, jtree(g), jstate, lr=jnp.float32(lr), weight_decay=wd)
    pp, pstate = run_port(wd)
    assert pstate.count == int(jstate.count) == 3
    p0 = list(start.values())
    for name, pl, jl, base in (("move", pp, jp, p0), ("mu", pstate.mu, jstate.mu, None),
                               ("nu", pstate.nu, jstate.nu, None)):
        for i, (p, j) in enumerate(zip(popt.tensor_leaves(pl), jax.tree_util.tree_leaves(jl))):
            b = 0.0 if base is None else base[i]
            assert_close_scaled(n(p) - b, np.asarray(j) - b, 1e-6, err_msg=f"{name} {i}")
    no_wd, _ = run_port(0.0)
    for i, (a, b) in enumerate(zip(popt.tensor_leaves(no_wd), jax.tree_util.tree_leaves(jp))):
        assert np.abs(n(a) - np.asarray(b)).max() > 1e-3, f"weight decay had no effect on leaf {i}"
