"""The port's trainer entry point and what one trainer run touches: the CLI
(presets, dot-path overrides, the reference spellings, ``adjust_steps``),
``trainer.main(..., device="cpu")`` for both presets with checkpoints, PLY
export, compression and the eval-only restart; checkpoints written by
either package's Runner and loaded by the other's, every array equal to 0
ulp; PLY and compressed splats read by the other package's reader; the
trajectories, patch crops and prefetch order against the JAX package's;
and pair-capacity shrinking, and regrowth after an overflow that no sync
point saw.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_init_tpu.config import Config as JConfig
from gs_init_tpu.config import MCMCStrategyConfig as JMCMC
from gs_init_tpu.datasets import parser as jparser
from gs_init_tpu.datasets import prefetch as jprefetch
from gs_init_tpu.datasets import traj as jtraj
from gs_init_tpu.engine.appearance import AppearanceParams as JApp
from gs_init_tpu.engine.optim import AdamState as JAdam
from gs_init_tpu.engine.params import GaussianParams as JParams
from gs_init_tpu.engine.params import GaussianState as JState
from gs_init_tpu.engine.runner import Runner as JRunner
from gs_init_tpu.engine.strategy.default import DefaultStrategyState as JStrat
from gs_init_tpu.engine.train_step import AuxParams as JAux
from gs_init_tpu.utils import compression as jcomp
from gs_init_tpu.utils import ply as jply
from gs_init_tpu_torch import trainer
from gs_init_tpu_torch.config import Config, DefaultStrategyConfig, MCMCStrategyConfig, parse_cli
from gs_init_tpu_torch.datasets import parser as pparser
from gs_init_tpu_torch.datasets import prefetch as pprefetch
from gs_init_tpu_torch.datasets import traj as ptraj
from gs_init_tpu_torch.datasets.synthetic import make_scene, write_colmap_scene
from gs_init_tpu_torch.engine.params import PARAM_NAMES, aux_leaves
from gs_init_tpu_torch.engine.runner import Runner
from gs_init_tpu_torch.utils import compression as pcomp
from gs_init_tpu_torch.utils import ply as pply
from torch_parity import CPU, n


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    sc = make_scene(n_gaussians=64, n_cams=8, width=64, height=48, device="cpu")
    return write_colmap_scene(str(tmp_path_factory.mktemp("trainer")), sc, n_points=48)


# -------------------------------------------------------------------- CLI


def test_cli_parsing(scene_dir):
    cfg = parse_cli(
        [
            "mcmc",
            f"--data_dir={scene_dir}",
            "--strategy.cap_max=1234",
            "--mdi.predictor=stub",
            "--steps_scaler", "0.5",
            "--max_steps=1000",
            "--eval_steps=[100,500]",
        ],
        trainer.build_presets(),
    )
    assert isinstance(cfg.strategy, MCMCStrategyConfig) and cfg.strategy.cap_max == 1234
    assert cfg.init_opa == 0.5 and cfg.init_scale == 0.1  # the mcmc preset
    assert cfg.opacity_reg == 0.01 and cfg.scale_reg == 0.01
    assert cfg.mdi.predictor == "stub"
    assert cfg.eval_steps == [100, 500]
    cfg.adjust_steps()
    assert cfg.max_steps == 500 and cfg.eval_steps == [50, 250]
    with pytest.raises(SystemExit):
        parse_cli(["nope"], trainer.build_presets())


def test_cli_reference_aliases(scene_dir):
    """Overrides written for the reference CLI work verbatim."""
    cfg = parse_cli(
        [
            "default",
            f"--data_dir={scene_dir}",
            "--random_background=true",
            "--save_final_ply=false",
            "--mdi.subsample_factor=7",
            "--mdi.ignore_cache=true",
            "--mdi.depth_grad_mask_thresh=0.05",
            "--mdi.limit_init_scale=true",
            "--mdi.use_num_sfm_points_mask=false",
            "--mdi.alignment.aligner=interp",
            "--mdi.alignment.interp.method=linear",
            "--mdi.alignment.ransac.max_iters=99",
            "--mdi.alignment.segmenter=slic",
            "--mdi.postprocess.outlier_removal=lof",
            "--mdi.depthanything.backbone=vitb",
            "--mdi.noise_std_scene_frac=none",
        ],
        trainer.build_presets(),
    )
    assert cfg.random_bkgd is True
    assert cfg.save_ply is False
    assert cfg.mdi.subsampling.method == "static"
    assert cfg.mdi.subsampling.factor == 7
    assert cfg.mdi.use_cache is False
    assert cfg.mdi.depth_gradient_mask is True
    assert cfg.mdi.depth_gradient_threshold == 0.05
    assert cfg.mdi.scale_clamp_quantile == 0.75
    assert cfg.mdi.subsampling.sfm_mask.enabled is False
    assert cfg.mdi.alignment.method == "interpolate"
    assert cfg.mdi.alignment.interp.method == "delaunay"
    assert cfg.mdi.alignment.ransac.max_iterations == 99
    assert cfg.mdi.alignment.segmentation.method == "slic"
    assert cfg.mdi.postprocess.lof_outlier_removal is True
    assert cfg.mdi.backbone == "vitb"
    assert cfg.mdi.noise_frac == 0.0
    cfg2 = parse_cli(["default", f"--data_dir={scene_dir}", "--mdi.subsample_factor=adaptive"],
                     trainer.build_presets())
    assert cfg2.mdi.subsampling.method == "adaptive"


@pytest.mark.parametrize("strategy", ["default", "mcmc"])
def test_adjust_steps_matches_jax(strategy):
    mk = lambda cls_cfg, cls_s: cls_cfg(
        steps_scaler=0.37, max_steps=30_000, eval_steps=[7_000, 30_000], save_steps=[123],
        ply_steps=[9_999], sh_degree_interval=1000, strategy=cls_s(),
    )
    from gs_init_tpu.config import DefaultStrategyConfig as JDefault

    j = mk(JConfig, JDefault if strategy == "default" else JMCMC)
    p = mk(Config, DefaultStrategyConfig if strategy == "default" else MCMCStrategyConfig)
    j.adjust_steps()
    p.adjust_steps()
    for name in ("max_steps", "eval_steps", "save_steps", "ply_steps", "sh_degree_interval"):
        assert getattr(p, name) == getattr(j, name), name
    assert vars(p.strategy) == vars(j.strategy)


def test_main_defaults_to_cuda(monkeypatch, scene_dir, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.main(["default", f"--data_dir={scene_dir}", f"--result_dir={tmp_path}"])


# --------------------------------------------------------------- training

COMMON = ["--data_factor=1", "--test_every=4", "--max_gaussians=128", "--pair_capacity=8192",
          "--tile_size=16", "--sh_degree=1", "--tb_every=10"]


@pytest.mark.parametrize(
    "preset,extra",
    [
        ("default", ["--strategy.refine_start_iter=5", "--strategy.refine_every=10",
                     "--pose_opt", "--use_bilateral_grid", "--pose_noise=0.01"]),
        ("mcmc", ["--strategy.refine_start_iter=5", "--strategy.refine_every=10",
                  "--strategy.cap_max=60", "--app_opt", "--patch_size=32"]),
    ],
)
def test_main_trains_and_restarts(scene_dir, tmp_path, preset, extra):
    """Both presets through main(..., device="cpu"): checkpoints at 10 and
    20, PLY and compression at 20; the eval-only restart from ckpt_20
    reproduces the run's eval PSNR and writes trajectory frames."""
    res = str(tmp_path / preset)
    argv = [preset, f"--data_dir={scene_dir}", f"--result_dir={res}", "--max_steps=20",
            "--eval_steps=[20]", "--save_steps=[10,20]", "--ply_steps=[20]", "--save_ply",
            "--compression=quantized", *COMMON, *extra]
    runner = trainer.main(argv, device="cpu")
    alive = int(runner.gstate.alive.sum())
    if preset == "mcmc":  # one relocation (step 10): the 5% tranche
        assert alive == int(np.float32(48) * np.float32(1.05)) <= 60
        assert runner.trainset[0]["image"].shape[:2] == (32, 32)
    for step in (10, 20):
        assert os.path.exists(os.path.join(res, "ckpts", f"ckpt_{step}.npz"))
    assert len(pply.read_ply_splats(os.path.join(res, "splats_20.ply"))[0]) == alive
    assert len(pcomp.decompress_splats(os.path.join(res, "compressed_20.npz"))[0]) == alive
    with open(os.path.join(res, "stats", "val_step20.json")) as f:
        stats = json.load(f)
    assert np.isfinite(stats["psnr"]) and ("cc_psnr" in stats) == ("--use_bilateral_grid" in extra)

    ckpt = os.path.join(res, "ckpts", "ckpt_20.npz")
    keep = [a for a in extra if not a.startswith(("--strategy", "--pose_noise", "--patch_size"))]
    again = trainer.main([preset, f"--data_dir={scene_dir}", f"--result_dir={res}_re", f"--ckpt=[{ckpt}]",
                          *COMMON, *keep], device="cpu")
    with open(os.path.join(f"{res}_re", "stats", "val_step20.json")) as f:
        assert json.load(f)["psnr"] == stats["psnr"]
    assert any(x.startswith("traj_20_") for x in os.listdir(os.path.join(f"{res}_re", "renders")))
    for k in PARAM_NAMES:
        assert torch.equal(getattr(again.gstate.params, k), getattr(runner.gstate.params, k))
    for a, b in zip(aux_leaves(again.aux), aux_leaves(runner.aux)):
        assert torch.equal(a, b)
    resumed = Runner(parse_cli(argv, trainer.build_presets()), device="cpu")
    assert resumed.load(os.path.join(res, "ckpts", "ckpt_10.npz")) == 10
    assert all(bool(torch.isfinite(v).all()) for v in resumed.train_iteration(11).values())


def test_pair_capacity_shrinks(scene_dir, tmp_path):
    """A grossly oversized pair capacity shrinks after step 0; training goes
    on with it, without overflow."""
    cfg = Config(data_dir=scene_dir, data_factor=1, result_dir=str(tmp_path), test_every=4,
                 max_gaussians=128, pair_capacity=1 << 18, tile_size=16, sh_degree=1)
    runner = Runner(cfg, device="cpu")
    runner.train_iteration(0)
    assert cfg.pair_capacity <= 1 << 15
    m = runner.train_iteration(1)
    assert np.isfinite(float(m["loss"])) and int(m["overflow"]) == 0


def test_overflow_between_logged_steps_regrows_the_table(scene_dir, tmp_path):
    """A step that overflows the pair table where no sync reads it (not a
    logged step, not the step after a refine) still regrows the table at
    the next logged step: its demand waits on the card."""
    def cfg(cap, steps):
        return Config(data_dir=scene_dir, data_factor=1, result_dir=str(tmp_path), test_every=4, max_steps=steps,
                      eval_steps=[], save_steps=[], tb_every=10, max_gaussians=128, pair_capacity=cap,
                      tile_size=16, sh_degree=1, data_prefetch=0, mesh="off", chunk_size=8)

    probe = Runner(cfg(1 << 16, 1), device="cpu")
    demand = []
    for i in range(len(probe.trainset)):
        probe._next_batch = lambda i=i: probe._build_batch([i])
        demand.append(int(probe.train_iteration(1)["pairs"]))
    lo, hi = int(np.argmin(demand)), int(np.argmax(demand))
    assert demand[lo] < demand[hi]
    cap = (demand[hi] - 1) // 8 * 8  # a multiple of the chunk that only view `hi` overflows
    assert demand[lo] <= cap, demand
    c = cfg(cap, 11)
    runner = Runner(c, device="cpu")
    order = iter([lo] * 3 + [hi] + [lo] * 7)
    runner._next_batch = lambda: runner._build_batch([next(order)])
    overflow = []
    real = runner.train_iteration
    runner.train_iteration = lambda step: _record(real, step, overflow)
    runner.train()
    assert [i for i, o in enumerate(overflow) if o > 0] == [3]
    assert c.pair_capacity >= demand[hi]  # regrown at step 10


def _record(real, step, overflow):
    m = real(step)
    overflow.append(int(m["overflow"]))
    return m


@pytest.mark.parametrize("cap", [1 << 14, 1 << 18, 1638400])
def test_retuned_pair_capacity_matches_jax_runner(cap):
    """The port's pure capacity rule gives the capacity the JAX Runner's
    ``_maybe_retune_capacity`` sets, over peaks from far below to far above
    ``cap``, with and without overflow (exact integers)."""
    from types import SimpleNamespace

    from gs_init_tpu_torch.engine.runner import retuned_pair_capacity

    for peak in (1, 900, 14152, 60000, 200_000, 431_607, 1_362_045, 3_000_000):
        for overflow in (0, 1, 5000):
            fake = SimpleNamespace(
                cfg=SimpleNamespace(auto_pair_capacity=True, rasterizer_impl="pallas", pair_capacity=cap),
                _pairs_max=0, _build_step_fn=lambda: None,
            )
            JRunner._maybe_retune_capacity(fake, {"pairs": peak - overflow, "overflow": overflow}, 0)
            assert retuned_pair_capacity(peak, overflow, cap) == fake.cfg.pair_capacity, (peak, overflow)


# ------------------------------------------------------ across packages


def _aux_cfg(scene_dir, result_dir, cls):
    return cls(data_dir=scene_dir, data_factor=1, result_dir=result_dir, test_every=4,
               max_gaussians=96, sh_degree=2, pose_opt=True, app_opt=True, use_bilateral_grid=True,
               bilateral_grid_shape=(4, 4, 2), mesh="off")


def _random_state(rng, cap, k_rest, n_images, grid_shape):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    params = dict(means=f(cap, 3), quats=f(cap, 4), scales=f(cap, 3), opacities=f(cap),
                  sh0=f(cap, 1, 3), shN=f(cap, k_rest, 3))
    gw, gh, gl = grid_shape
    return dict(
        params=params, mu={k: f(*v.shape) for k, v in params.items()},
        nu={k: np.abs(f(*v.shape)) for k, v in params.items()}, count=np.int32(rng.integers(1, 99)),
        alive=rng.uniform(size=cap) < 0.7,
        strategy=dict(grad2d=np.abs(f(cap)), count=np.abs(f(cap)), radii_max=np.abs(f(cap))),
        aux=[f(n_images, 9)] + [f(*s) for s in ((n_images, 16), (cap, 32), (57, 64), (64,), (64, 64),
                                                (64,), (64, 3), (3,))] + [f(n_images, gl, gh, gw, 12)],
    )


def _assert_state(st, params, mu, nu, count, alive, strategy, aux):
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(n(params[k]), st["params"][k])
        np.testing.assert_array_equal(n(mu[k]), st["mu"][k])
        np.testing.assert_array_equal(n(nu[k]), st["nu"][k])
    assert int(count) == int(st["count"])
    np.testing.assert_array_equal(n(alive), st["alive"])
    for k, v in st["strategy"].items():
        np.testing.assert_array_equal(n(strategy[k]), v)
    assert len(aux) == len(st["aux"])
    for a, b in zip(aux, st["aux"]):
        np.testing.assert_array_equal(n(a), b)


def test_checkpoints_load_across_packages(scene_dir, tmp_path, rng):
    """A checkpoint written by the JAX Runner loads into the port's Runner,
    and one written by the port's loads into the JAX Runner: params, Adam
    moments and count, alive, strategy statistics and every aux group (pose,
    appearance, bilateral grids) equal to 0 ulp."""
    jr = JRunner(_aux_cfg(scene_dir, str(tmp_path / "jax"), JConfig))
    pr = Runner(_aux_cfg(scene_dir, str(tmp_path / "port"), Config), device="cpu")
    shape = (pr.parser.num_images, pr.cfg.bilateral_grid_shape)
    # The JAX Runner's state, replaced by random arrays, saved, loaded here.
    st = _random_state(rng, 96, 8, shape[0], shape[1])
    J = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    jr.gstate = JState(params=JParams(**J(st["params"])), alive=jnp.asarray(st["alive"]))
    jr.adam = JAdam(mu=JParams(**J(st["mu"])), nu=JParams(**J(st["nu"])), count=jnp.asarray(st["count"]))
    jr.sstate = JStrat(**J(st["strategy"]))
    a = [jnp.asarray(x) for x in st["aux"]]
    jr.aux = JAux(pose=a[0], app=JApp(*a[1:9]), grids=a[9])
    assert pr.load(jr.save(7)) == 7
    ps = pr.gstate.params
    _assert_state(st, {k: getattr(ps, k) for k in PARAM_NAMES}, vars(pr.adam.mu), vars(pr.adam.nu),
                  pr.adam.count, pr.gstate.alive, vars(pr.sstate), aux_leaves(pr.aux))
    # And the reverse, from a fresh random state written by the port.
    st = _random_state(rng, 96, 8, shape[0], shape[1])
    from gs_init_tpu_torch.engine.params import aux_from_leaves, params_from_numpy, state_from_numpy
    from gs_init_tpu_torch.engine.strategy.default import strategy_from_numpy

    pr.gstate = state_from_numpy(st["params"], st["alive"], CPU)
    pr.adam.mu, pr.adam.nu = params_from_numpy(st["mu"], CPU), params_from_numpy(st["nu"], CPU)
    pr.adam.count = int(st["count"])
    pr.sstate = strategy_from_numpy(*st["strategy"].values(), CPU)
    pr.aux = aux_from_leaves(pr.aux, [torch.as_tensor(x) for x in st["aux"]])
    assert jr.load(pr.save(9)) == 9
    _assert_state(st, jr.gstate.params._asdict(), jr.adam.mu._asdict(), jr.adam.nu._asdict(), jr.adam.count,
                  jr.gstate.alive, jr.sstate._asdict(), jax.tree_util.tree_leaves(jr.aux))


def test_ply_and_compression_read_across_packages(tmp_path, rng):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    splats = (f(50, 3), f(50, 3), f(50, 4), f(50), f(50, 1, 3), f(50, 15, 3))
    for writer, reader, tag in ((pply, jply, "port"), (jply, pply, "jax")):
        path = str(tmp_path / f"{tag}.ply")
        writer.write_ply_splats(path, *splats)
        for got, want in zip(reader.read_ply_splats(path), splats):
            np.testing.assert_array_equal(got, want)
        pts = str(tmp_path / f"{tag}_pts.ply")
        writer.write_ply_points(pts, splats[0], rng.uniform(0, 1, (50, 3)))
        for got, want in zip(reader.read_ply_points(pts), writer.read_ply_points(pts)):
            np.testing.assert_array_equal(got, want)
        comp = str(tmp_path / f"{tag}.npz")
        (pcomp if tag == "port" else jcomp).compress_splats(comp, *splats)
        for got, want in zip((jcomp if tag == "port" else pcomp).decompress_splats(comp),
                             (pcomp if tag == "port" else jcomp).decompress_splats(comp)):
            np.testing.assert_array_equal(got, want)
    with open(str(tmp_path / "port.npz"), "rb") as a, open(str(tmp_path / "jax.npz"), "rb") as b:
        assert np.load(a)["shN"].tobytes() == np.load(b)["shN"].tobytes()


@pytest.mark.parametrize("name", ["interp", "ellipse_z", "ellipse_y", "spiral"])
def test_trajectories_match_jax(rng, name):
    from gs_init_tpu_torch.datasets.synthetic import look_at

    eyes = np.stack([np.cos(np.linspace(0, 2, 9)) * 3, rng.uniform(-0.3, 0.3, 9), np.sin(np.linspace(0, 2, 9)) * 3], -1)
    c2ws = np.stack([look_at(e, np.zeros(3)) for e in eyes])
    got = ptraj.get_path(name, c2ws, n_frames=30)
    np.testing.assert_array_equal(got, jtraj.get_path(name, c2ws, n_frames=30))
    assert got.shape[1:] == (4, 4) and np.isfinite(got).all()
    with pytest.raises(ValueError):
        ptraj.get_path("nope", c2ws)


def test_patch_crops_match_jax(scene_dir):
    """Random square crops with the principal-point shift: the port's
    crops from a RandomState(seed) equal the JAX package's from numpy's
    global generator seeded alike; a patch larger than the image raises."""
    pd = pparser.Dataset(pparser.Parser(scene_dir, test_every=4), "train", patch_size=16,
                         rng=np.random.RandomState(3))
    jd = jparser.Dataset(jparser.Parser(scene_dir, test_every=4), "train", patch_size=16)
    np.random.seed(3)
    for i in [0, 1, 2, 0, 3, 1]:
        got, want = pd[i], jd[i]
        assert got["image"].shape == (16, 16, 3)
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_array_equal(got["K"], want["K"])
    full = pparser.Dataset(pparser.Parser(scene_dir, test_every=4), "train")[0]
    assert full["K"][0, 2] - pd[0]["K"][0, 2] >= 0
    with pytest.raises(ValueError, match="patch_size"):
        pparser.Dataset(pd.parser, "train", patch_size=100)[0]


def test_image_cache_budget(scene_dir):
    """Decoded images are kept as uint8 within the byte budget; a cached
    read equals the first decode."""
    parser = pparser.Parser(scene_dir, test_every=4)
    one = 64 * 48 * 3
    ds = pparser.Dataset(parser, "train", cache_bytes=2 * one)
    first = [ds[i]["image"] for i in range(len(ds))]
    assert len(ds._img_cache) == 2 and ds._cache_used == 2 * one
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds[i]["image"], first[i])


def test_prefetch_order_matches_jax():
    """Same seed, same batches in the same order as the JAX prefetcher."""
    got, want = [], []
    for mod, out in ((pprefetch, got), (jprefetch, want)):
        pf = mod.BatchPrefetcher(lambda ids: list(ids), n_items=7, batch_size=3, depth=2, seed=5)
        try:
            out += [pf.get() for _ in range(9)]
        finally:
            pf.close()
    assert got == want
    assert sorted(sum(got[:7], [])[:21]) == sorted(list(range(7)) * 3)


def test_prefetch_raises_the_worker_error_and_joins():
    calls = []

    def build(ids):
        calls.append(ids)
        if len(calls) == 3:
            raise KeyError("boom")
        return ids

    pf = pprefetch.BatchPrefetcher(build, n_items=4, batch_size=1, depth=1, seed=0)
    try:
        with pytest.raises(RuntimeError, match="worker died") as err:
            for _ in range(5):
                pf.get()
        assert isinstance(err.value.__cause__, KeyError)
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_nerfstudio_parser_matches_jax(tmp_path):
    """A transforms.json scene (OpenGL poses, shared intrinsics, an adjacent
    COLMAP model): the port's NerfstudioParser gives the JAX package's
    cameras, points and scene scale, and open_dataset picks it."""
    from gs_init_tpu.datasets import nerfstudio as jns
    from gs_init_tpu_torch.datasets import nerfstudio as pns

    sc = make_scene(n_gaussians=32, n_cams=6, width=32, height=24, device="cpu")
    data_dir = write_colmap_scene(str(tmp_path), sc, n_points=24)
    gl2cv = np.diag([1.0, -1.0, -1.0, 1.0])
    meta = dict(
        fl_x=float(sc.Ks[0, 0, 0]), fl_y=float(sc.Ks[0, 1, 1]), cx=float(sc.Ks[0, 0, 2]),
        cy=float(sc.Ks[0, 1, 2]), w=sc.width, h=sc.height,
        frames=[{"file_path": f"images/img_{i:03d}.png",
                 "transform_matrix": (c2w.astype(np.float64) @ gl2cv).tolist()}
                for i, c2w in enumerate(sc.camtoworlds)],
    )
    with open(os.path.join(data_dir, "transforms.json"), "w") as f:
        json.dump(meta, f)
    got, want = pns.open_dataset(data_dir, test_every=3), jns.open_dataset(data_dir, test_every=3)
    assert isinstance(got, pns.NerfstudioParser) and got.num_images == want.num_images == 6
    for a, b in zip(got.images, want.images):
        assert a.name == b.name
        np.testing.assert_array_equal(a.camtoworld, b.camtoworld)
        np.testing.assert_array_equal(a.K, b.K)
    np.testing.assert_array_equal(got.points, want.points)
    assert got.scene_scale == want.scene_scale
    assert {k: v.tolist() for k, v in got.point_indices.items()} == {
        k: v.tolist() for k, v in want.point_indices.items()}
    os.remove(os.path.join(data_dir, "transforms.json"))
    assert type(pns.open_dataset(data_dir)) is pparser.Parser


def test_memory_stats_are_empty_on_the_cpu(caplog):
    """No device statistics on the CPU, as the JAX package reports none
    where the backend keeps none; the log line says so."""
    import logging

    from gs_init_tpu_torch.utils import mem

    assert mem.device_memory_stats("cpu") == {}
    assert mem.format_memory_stats("cpu") == "device memory stats unavailable"
    with caplog.at_level(logging.INFO, logger=mem.__name__):
        mem.log_memory("step 3", device="cpu")
    assert caplog.messages == ["[mem] step 3 device memory stats unavailable"]
