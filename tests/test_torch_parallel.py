"""The port's camera / gaussian sharded train step (``parallel/shard.py``)
on meshes (2, 1), (1, 2) and (2, 2) of gloo ranks on the CPU, against the
port's one-device step and against the JAX package's
``make_sharded_train_step`` on the virtual 8-device CPU mesh.

The cases mirror ``tests/test_parallel.py``: the pose / appearance /
bilateral-grid groups, the regularisers with a random background (the
JAX key's draw handed over as a tensor), a background colour, the depth
loss, the sampling mask, plus the absgrad pair tap; then refine and MCMC
relocation on the gathered state, and the multihost helpers. The port's
steps run its tile path with the compositor's plain twins, as the card
runs the kernels; against JAX (dense oracle, ``rasterizer_impl="xla"``)
one case with every feature at once runs through the port's ``xla`` path
on each mesh. All inputs come from numpy (the JAX package's initial state).

Tolerances. Against the port's one-device step, those of the JAX mesh
tests (``tests/test_parallel.py:125``): loss within 1e-5 relative; means,
scales, opacities and sh0, grad2d and the aux leaves within 1e-5 absolute.
Against JAX (two libraries): loss within 1e-5 relative, grad2d and the
first Adam moments within 1e-4 of each leaf's max, each parameter within
1e-5 plus its Adam step's sign-flip slack, the bound of
``tests/test_torch_train_step.py``. Refine and relocation on the mesh
equal the one-device result exactly.
"""
import ast
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_init_tpu.config import Config as JConfig
from gs_init_tpu.engine.appearance import init_appearance_params, init_pose_params
from gs_init_tpu.engine.optim import init_adam_state, make_adam_config
from gs_init_tpu.engine.params import init_from_points
from gs_init_tpu.engine.strategy import default as jdstrat
from gs_init_tpu.engine.train_step import AuxParams as JAux
from gs_init_tpu.engine.train_step import Batch as JBatch
from gs_init_tpu.engine.train_step import init_aux_opt as j_init_aux_opt
from gs_init_tpu.parallel.shard import make_mesh as j_make_mesh
from gs_init_tpu.parallel.shard import make_sharded_train_step as j_sharded
from gs_init_tpu.parallel.shard import shardings
from gs_init_tpu_torch.config import Config, DefaultStrategyConfig
from gs_init_tpu_torch.datasets.synthetic import make_scene
from gs_init_tpu_torch.engine.params import PARAM_NAMES
from torch_dist import (
    assert_adam_steps_close, assert_step_match, global_mesh_info, mesh_jobs, project_pack_calls, run_step,
    spawn, strategy_on_mesh,
)
from torch_parity import assert_close_scaled

torch.set_num_threads(2)

CAP, W, H = 128, 32, 24
IDX = np.array([0, 3])
MESHES = [(2, 1), (1, 2), (2, 2)]
BASE = dict(max_steps=100, sh_degree=1, max_gaussians=CAP, pair_capacity=1 << 13, batch_size=2)
# name -> (config, batch extras)
CASES = {
    "base": ({}, ()),
    "pose": ({"pose_opt": True}, ()),
    "app": ({"app_opt": True}, ()),
    "grid": ({"use_bilateral_grid": True}, ()),
    "regs_bkgd": ({"random_bkgd": True, "opacity_reg": 0.01, "scale_reg": 0.01}, ()),
    "bg_color": ({"background_color": (1.0, 1.0, 1.0)}, ()),
    "depth": ({"depth_loss": True}, ("depth",)),
    "mask": ({}, ("mask",)),
    "absgrad": ({"strategy": DefaultStrategyConfig(absgrad=True)}, ()),
}
# Every feature but the sampling mask: with both a mask and the depth loss
# the JAX sharded steps take the expected depth from the masked alpha
# (shard.py:237), the single-device steps of both packages from the render
# (train_step.py:198), and the port's sharded step follows the latter.
ALL = ({"pose_opt": True, "app_opt": True, "use_bilateral_grid": True, "random_bkgd": True,
        "opacity_reg": 0.01, "scale_reg": 0.01, "depth_loss": True}, ("depth",))


@functools.lru_cache
def _scene():
    return make_scene(n_gaussians=48, n_cams=8, width=W, height=H, device="cpu")


@functools.lru_cache
def _initial_state():
    sc = _scene()
    return init_from_points(jnp.asarray(sc.points), jnp.asarray(sc.rgbs), CAP, 1)


def _inputs(cfg_kw, extras):
    """numpy inputs for both packages: the JAX package's initial state, the
    batch of cameras 0 and 3, the aux groups of tests/test_parallel.py."""
    sc = _scene()
    g = _initial_state()
    batch = dict(camtoworlds=sc.camtoworlds[IDX], Ks=sc.Ks[IDX], pixels=sc.images[IDX], image_ids=IDX)
    rng = np.random.default_rng(0)
    if "depth" in extras:
        pts = rng.integers(0, [W, H], (2, 6, 2)).astype(np.float32)
        vals = rng.uniform(1.0, 5.0, (2, 6)).astype(np.float32)
        vals[0, 4:] = 0.0  # padding rows
        batch.update(depth_points=pts, depth_values=vals)
    if "mask" in extras:
        sm = np.zeros((2, H, W, 1), np.float32)
        sm[:, : H // 2] = 1.0
        batch["sampling_mask"] = sm
    key = jax.random.PRNGKey(11)
    out = dict(params={k: np.asarray(v) for k, v in g.params._asdict().items()},
               alive=np.asarray(g.alive), batch=batch, step=5)
    if cfg_kw.get("pose_opt"):
        out["pose"] = np.asarray(init_pose_params(8, std=0.01, key=key))
    if cfg_kw.get("app_opt"):
        app = init_appearance_params(key, 8, CAP, feature_dim=8, embed_dim=4, sh_degree=1, mlp_width=16)
        out["app"] = {k: np.asarray(v) for k, v in app._asdict().items()}
    if cfg_kw.get("use_bilateral_grid"):
        noise = np.random.default_rng(11).normal(size=(8, 2, 4, 4, 12))
        out["grids"] = (np.eye(3, 4).reshape(1, 1, 1, 1, 12) + 0.01 * noise).astype(np.float32)
    if cfg_kw.get("random_bkgd"):
        out["bkgd"] = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (2, 3)))
    return out


def _step_job(cfg_kw, inputs, mesh_shape, impl="auto"):
    return ("step", dict(BASE, rasterizer_impl=impl, **cfg_kw), float(_scene().scene_scale),
            W, H, inputs, mesh_shape, False)


def _jax_sharded(cfg_kw, inputs, mesh_shape):
    """The JAX package's sharded step on the virtual CPU mesh, as
    tests/test_parallel.py runs it; returns its outputs as numpy."""
    sc = _scene()
    cfg = JConfig(**dict(BASE, rasterizer_impl="xla", **cfg_kw))
    acfg = make_adam_config(cfg, sc.scene_scale)
    p = {k: jnp.asarray(v) for k, v in inputs["params"].items()}
    from gs_init_tpu.engine.params import GaussianParams, GaussianState

    g = GaussianState(params=GaussianParams(**p), alive=jnp.asarray(inputs["alive"]))
    aux = JAux(pose=None if "pose" not in inputs else jnp.asarray(inputs["pose"]),
               grids=None if "grids" not in inputs else jnp.asarray(inputs["grids"]))
    if "app" in inputs:
        from gs_init_tpu.engine.appearance import AppearanceParams

        aux = aux._replace(app=AppearanceParams(**{k: jnp.asarray(v) for k, v in inputs["app"].items()}))
    mesh = j_make_mesh(*mesh_shape)
    gauss_s, data_s, repl_s = shardings(mesh)
    put = lambda tree, s: jax.tree.map(lambda x: jax.device_put(x, s), tree)
    adam = jax.tree.map(lambda x: jax.device_put(x, gauss_s if x.ndim > 0 else repl_s), init_adam_state(g.params))
    batch = JBatch(**{k: jnp.asarray(v) for k, v in inputs["batch"].items()})
    step = j_sharded(cfg, acfg, W, H, mesh)
    g2, a2, s2, aux2, aux_opt2, m = step(
        put(g, gauss_s), adam, put(jdstrat.init_state(CAP), gauss_s), put(aux, repl_s),
        put(j_init_aux_opt(aux), repl_s), put(batch, data_s), jnp.int32(5), jax.random.PRNGKey(0),
    )
    out = {"metric/loss": np.asarray(m["loss"]), "grad2d": np.asarray(s2.grad2d)}
    out.update({f"params/{k}": np.asarray(getattr(g2.params, k)) for k in PARAM_NAMES})
    out.update({f"mu/{k}": np.asarray(getattr(a2.mu, k)) for k in PARAM_NAMES})
    out.update({f"aux/{i}": np.asarray(x) for i, x in enumerate(jax.tree_util.tree_leaves(aux2))})
    mus = [jax.tree_util.tree_leaves(getattr(aux_opt2, k).mu) for k in ("pose", "app", "grids")
           if getattr(aux_opt2, k) is not None]
    out.update({f"auxmu/{i}": np.asarray(x) for i, x in enumerate(x for group in mus for x in group)})
    out["lrs"] = dict(acfg.lrs._asdict())
    out["b1"] = acfg.b1
    out["aux_lrs"] = ([cfg.pose_opt_lr * acfg.means_decay_gamma ** 5] if "pose" in inputs else []) + (
        [cfg.app_opt_lr] * 8 if "app" in inputs else []) + ([2e-3] if "grids" in inputs else [])
    return out


@pytest.fixture(scope="module")
def inputs():
    out = {name: _inputs(kw, extras) for name, (kw, extras) in CASES.items()}
    out["all"] = _inputs(*ALL)
    return out


@pytest.fixture(scope="module")
def one_rank(inputs):
    """The port's one-device step for every case (tile path)."""
    sc = _scene()
    return {name: run_step(Config(**dict(BASE, **kw)), float(sc.scene_scale), W, H, inputs[name])
            for name, (kw, _) in CASES.items()}


@pytest.fixture(scope="module")
def on_mesh(inputs):
    """One spawn of four ranks (a 2-rank mesh on ranks 0 and 1): every case
    on the tile path and the all-features case on the xla path on each
    mesh; on (2, 2) also refine, MCMC relocation and 30 training steps."""
    rng = np.random.default_rng(5)
    strat_in = dict(inputs["base"], eps=[rng.normal(size=(CAP, 3)).astype(np.float32) for _ in range(2)])
    sc = _scene()
    names = list(CASES) + ["all"]
    jobs = []
    for shape in MESHES:
        jobs += [_step_job(CASES[name][0], inputs[name], shape) for name in CASES]
        jobs.append(_step_job(ALL[0], inputs["all"], shape, impl="xla"))
    jobs += [("refine", strat_in, (2, 2)), ("mcmc", strat_in, (2, 2)),
             ("train", dict(BASE), float(sc.scene_scale), inputs["base"], sc.images, sc.camtoworlds, sc.Ks)]
    ranks = spawn(mesh_jobs, 4, jobs)
    out = {}
    for i, shape in enumerate(MESHES):
        per_rank = [r[i * len(names):(i + 1) * len(names)] for r in ranks[: shape[0] * shape[1]]]
        for r in per_rank[1:]:  # the gathered state is the same on every rank of the mesh
            for a, b in zip(per_rank[0], r):
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{shape} {k}")
        out[shape] = dict(zip(names, per_rank[0]))
    out[(2, 2)].update(zip(("refine", "mcmc", "train"), ranks[0][-3:]), strategy_inputs=strat_in)
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_matches_one_rank(on_mesh, one_rank, mesh_shape, case):
    got, want = on_mesh[mesh_shape][case], one_rank[case]
    assert_step_match(got, want, what=f"{mesh_shape} {case}")
    np.testing.assert_array_equal(got["count"], want["count"])
    # The worst data shard's pair count, at most the whole batch's.
    assert 0 < int(got["metric/pairs"]) <= int(want["metric/pairs"])
    assert int(got["metric/overflow"]) == int(want["metric/overflow"]) == 0


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_matches_jax(on_mesh, inputs, mesh_shape):
    """Every feature at once, the port's xla path against JAX's sharded
    step on the same mesh shape."""
    got, want = on_mesh[mesh_shape]["all"], _jax_sharded(ALL[0], inputs["all"], mesh_shape)
    what = f"{mesh_shape} all vs JAX"
    np.testing.assert_allclose(got["metric/loss"], want["metric/loss"], rtol=1e-5, err_msg=what)
    assert_close_scaled(got["grad2d"], want["grad2d"], 1e-4, err_msg=f"{what} grad2d")
    for k in ("means", "scales", "opacities", "sh0"):
        assert_adam_steps_close(got, want, want["lrs"][k], want["b1"], f"params/{k}", f"mu/{k}", what)
    for i, lr in enumerate(want["aux_lrs"]):
        assert_adam_steps_close(got, want, lr, 0.9, f"aux/{i}", f"auxmu/{i}", what)


def test_sharded_training_reduces_loss(on_mesh):
    """30 sharded steps on (2, 2) over alternating camera pairs reduce the
    loss by more than 10%, as tests/test_parallel.py asks of JAX."""
    losses = on_mesh[(2, 2)]["train"]
    assert losses[-1] < losses[0] * 0.9


@pytest.mark.parametrize("kind", ["refine", "mcmc"])
def test_strategy_on_the_mesh_matches_one_device(on_mesh, kind):
    """Refine (grow / split / prune) and MCMC relocation with its noise on
    the gathered state, kept per rank, equal the one-device result."""
    res = on_mesh[(2, 2)]
    want = strategy_on_mesh(kind, res["strategy_inputs"])
    got = res[kind]
    np.testing.assert_array_equal(got["alive"], want["alive"])
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_multihost_global_mesh():
    """Four ranks on two "hosts" of two: data across hosts, gauss within a
    host, ranks host-major, reshaped row-major (multihost.py:66-79 of JAX)."""
    res = spawn(global_mesh_info, 4)
    for r, (shape, at, ranks, sl, (rank, world)) in enumerate(res):
        assert shape == {"data": 2, "gauss": 2} and ranks == [[0, 1], [2, 3]]
        assert at == (r // 2, r % 2) and sl == slice(2 * r, 2 * r + 2) and (rank, world) == (r, 4)


def test_sharded_steps_render_through_the_one_card_ops(inputs):
    """The camera step and the band step (two bands on one rank) project,
    colour and pack once a step through ``ops/project_pack`` and composite
    through ``ops/render.composite``, as ``rasterize`` does; ``parallel/
    shard.py`` imports none of the composition that ``project_pack``
    replaced."""
    from gs_init_tpu_torch.ops import render
    from gs_init_tpu_torch.parallel import shard

    calls = spawn(project_pack_calls, 1, dict(BASE), float(_scene().scene_scale), W, H, inputs["base"])[0]
    assert calls == {"cameras": 1, "band": 1}
    assert shard.composite is render.composite
    tree = ast.parse(inspect.getsource(shard))
    imported = {a.asname or a.name for node in ast.walk(tree) if isinstance(node, (ast.Import, ast.ImportFrom))
                for a in node.names}
    assert "project_pack" in imported
    assert not imported & {"project_gaussians", "sh_to_color", "pack_table"}
