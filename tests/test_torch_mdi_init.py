"""Parity: the port's monocular-depth init end to end against the JAX
package — ``pts_and_rgb_from_monocular_depth`` on the same COLMAP scene
with the same stub predictions, and a port ``Runner`` with
``init_type="monocular_depth"`` whose initial gaussians match the JAX
Runner's; the depth cache (written by either package, read by the other);
three train steps; and the settings the port refuses.

The stub predicts the scene's surface depth under an affine distortion,
with the SfM points' own depths at their pixels, so every correspondence is
exact: every non-degenerate RANSAC hypothesis and its refit land on the
same (s, t), whichever hypotheses are drawn (the port draws its own).
Tolerances: point counts and colours exactly; points within 2e-4 of the
cloud's extent (each image's (s, t) is an f32 fit over ~40 points whose
normal equations the two packages sum in two orders: up to 7e-5 relative
apart, measured per image on this scene);
initial log-scales within 1e-3 abs from the two Runners (their clouds
differ by up to 2e-4 of the extent, which moves kNN distances near 0.1 by
up to 1e-3 relative) and within 1e-5 from the same cloud.
"""
import os

import numpy as np
import pytest
import torch

from gs_init_tpu.config import Config as JConfig
from gs_init_tpu.datasets.synthetic import make_scene, write_colmap_scene
from gs_init_tpu.engine.runner import Runner as JRunner
from gs_init_tpu.mdi.init import pts_and_rgb_from_monocular_depth as j_pts_and_rgb
from gs_init_tpu.mdi.predictors.stub import StubPredictor as JStub
from gs_init_tpu_torch.config import Config, check_slice
from gs_init_tpu_torch.datasets.parser import Parser
from gs_init_tpu_torch.engine.params import SH0_C, init_from_points
from gs_init_tpu_torch.engine.runner import Runner
from gs_init_tpu_torch.mdi.init import LowDepthAlignmentConfidenceError, pts_and_rgb_from_monocular_depth
from gs_init_tpu_torch.mdi.predictors.stub import StubPredictor
from torch_parity import CPU


@pytest.fixture(scope="module")
def colmap_scene(tmp_path_factory):
    scene = make_scene(n_gaussians=80, n_cams=8, width=64, height=48)
    return write_colmap_scene(str(tmp_path_factory.mktemp("mdi")), scene, n_points=64), scene


def sh0_to_rgb(sh0):
    return sh0 * SH0_C + 0.5


def _exact_depths(scene, data_dir):
    """Per camera, the scene's surface depth (NaN where it barely covers the
    pixel) with the depth of each SfM point the image observes written at
    its pixel, so that every correspondence is exactly affine in the
    prediction."""
    from gs_init_tpu_torch.datasets import colmap_io

    rec = colmap_io.read_reconstruction(os.path.join(data_dir, "sparse/0"))
    xyz = dict(zip(rec.point_ids.tolist(), rec.points_xyz))
    out = []
    for i, (c2w, sd, a) in enumerate(zip(scene.camtoworlds, scene.surface_depths, scene.alphas)):
        d = np.where(a > 0.3, sd, np.nan).astype(np.float32)
        w2c = np.linalg.inv(c2w)
        im = rec.images[i + 1]
        for pid, (x, y) in zip(im.point3D_ids.tolist(), im.xys):
            d[int(y), int(x)] = (xyz[pid] @ w2c[:3, :3].T + w2c[:3, 3])[2]
        out.append(d)
    return out


def _oracle_stub(cls, scene, parser):
    """The stub over ``_exact_depths``, in trainset order."""
    exact = _exact_depths(scene, parser.data_dir)
    depths = [exact[i] for i in parser.split_indices("train")]
    calls = iter(range(10**6))
    return cls(oracle=lambda image, intr: depths[next(calls) % len(depths)])


def _configs(data_dir, tmp_path, variant):
    cfgs = []
    for C in (JConfig, Config):
        c = C(data_dir=data_dir, data_factor=1, test_every=4, result_dir=str(tmp_path / "res"),
              init_type="monocular_depth")
        c.mdi.predictor = "stub"
        c.mdi.use_cache = False
        c.mdi.depth_gradient_mask = True
        c.mdi.subsampling.factor = 3
        if variant == "ransac":
            # With the default threshold (|error| < 0.1) every hypothesis
            # has no outlier on exact data, so the first drawn one is kept
            # with the f32 rounding of its 4-point fit (the refits cannot
            # beat zero outliers). At 1e-3 only the accurate ones count and
            # the refit over all points decides, as it does on real data.
            c.mdi.alignment.ransac.inlier_threshold = 1e-6
        elif variant == "lstsqrs_lof_native":
            c.mdi.alignment.method = "lstsqrs"
            c.mdi.postprocess.lof_outlier_removal = True
            c.mdi.postprocess.lof_neighbors = 8
            c.mdi.postprocess.merge_subsample = True
        elif variant == "interpolate_delaunay":
            c.mdi.alignment.method = "interpolate"
            c.mdi.alignment.interp.prealign = "lstsqrs"
            c.mdi.alignment.interp.rbf_grid_width = 32
        cfgs.append(c)
    return cfgs


@pytest.mark.parametrize("variant", ["ransac", "lstsqrs_lof_native", "interpolate_delaunay"])
def test_pts_and_rgb_matches_jax(colmap_scene, tmp_path, variant):
    from gs_init_tpu.datasets.parser import Parser as JParser

    data_dir, scene = colmap_scene
    jcfg, pcfg = _configs(data_dir, tmp_path, variant)
    jparser, pparser = JParser(data_dir, factor=1, test_every=4), Parser(data_dir, factor=1, test_every=4)
    jp, jc = j_pts_and_rgb(jcfg, jparser, model=_oracle_stub(JStub, scene, jparser))
    per_image = []
    pp, pc = pts_and_rgb_from_monocular_depth(
        pcfg, pparser, model=_oracle_stub(StubPredictor, scene, pparser), device=CPU,
        per_image=per_image,
    )
    assert pp.dtype == np.float32 and pp.shape == jp.shape and len(pp) > 100
    np.testing.assert_array_equal(pc, jc)
    extent = float(np.abs(jp).max())
    np.testing.assert_allclose(pp / extent, jp / extent, atol=2e-4)
    assert len(per_image) == len(pparser.split_indices("train"))
    assert sum(r["points"] for r in per_image) + len(pparser.points) >= len(pp)
    # Every image's fit undoes the stub's 0.37 up to the parser's one
    # similarity scale (the Delaunay map's fit is near 1 too).
    ratio = np.array([r["scale"] for r in per_image]) * 0.37
    assert np.ptp(ratio) < (1e-2 if variant == "interpolate_delaunay" else 5e-4) * ratio.mean()


def test_runner_initial_state_matches_jax(colmap_scene, tmp_path):
    data_dir, _ = colmap_scene
    states = []
    for C, R, kw in ((JConfig, JRunner, {}), (Config, Runner, dict(device="cpu"))):
        cfg = C(data_dir=data_dir, data_factor=1, test_every=4, init_type="monocular_depth",
                result_dir=str(tmp_path / R.__module__), max_steps=3, eval_steps=[], save_steps=[],
                sh_degree=1, max_gaussians=2048, pair_capacity=1 << 14, mesh="off",
                rasterizer_impl="xla" if C is JConfig else "auto")
        cfg.mdi.predictor = "stub"
        cfg.mdi.cache_dir = str(tmp_path / "cache")  # the JAX run writes it, the port's reads it
        cfg.mdi.alignment.method = "lstsqrs"
        cfg.mdi.subsampling.factor = 6
        cfg.mdi.scale_clamp_quantile = 0.9
        runner = R(cfg, **kw)
        p = runner.gstate.params
        states.append(({k: np.asarray(getattr(p, k)) for k in ("means", "scales", "opacities", "sh0")},
                       np.asarray(runner.gstate.alive), runner))
    (jp, ja, _), (pp, pa, prunner) = states
    np.testing.assert_array_equal(pa, ja)
    alive = ja
    assert 50 < alive.sum() < 2048
    extent = float(np.abs(jp["means"][alive]).max())
    np.testing.assert_allclose(pp["means"][alive] / extent, jp["means"][alive] / extent, atol=2e-4)
    np.testing.assert_allclose(pp["sh0"][alive], jp["sh0"][alive], atol=1e-5)
    np.testing.assert_allclose(pp["opacities"], jp["opacities"], atol=1e-6)
    np.testing.assert_allclose(pp["scales"][alive], jp["scales"][alive], atol=1e-3)
    # From the same cloud (the JAX Runner's), the same scales.
    same = init_from_points(
        torch.as_tensor(jp["means"][alive]), torch.as_tensor(sh0_to_rgb(jp["sh0"][alive, 0])),
        2048, 1, init_opacity=0.1, scale_clamp_quantile=0.9,
    )
    np.testing.assert_allclose(same.params.scales.numpy()[alive], jp["scales"][alive], atol=1e-5)
    # The 0.9 quantile clamp caps the largest scales at one value.
    assert (pp["scales"][alive][:, 0] == pp["scales"][alive][:, 0].max()).sum() >= alive.sum() // 20

    n_files = sum(f.endswith(".npz") for _, _, fs in os.walk(tmp_path / "cache") for f in fs)
    assert n_files == len(prunner.trainset)

    class Boom:
        name = "stub"

        def predict_depth_batch(self, images, intr):
            raise AssertionError("the depth cache should have been used")

    pts, _ = pts_and_rgb_from_monocular_depth(prunner.cfg, prunner.parser, model=Boom(), device=CPU)
    assert len(pts) == alive.sum()

    losses = [float(prunner.train_iteration(step)["loss"]) for step in range(3)]
    assert np.isfinite(losses).all()


def test_monocular_depth_settings_the_port_refuses(colmap_scene, tmp_path):
    data_dir, _ = colmap_scene

    def cfg(**mdi):
        c = Config(data_dir=data_dir, init_type="monocular_depth")
        c.mdi.predictor = "stub"
        for k, v in mdi.items():
            setattr(c.mdi, k, v)
        return c

    check_slice(cfg())
    for mdi, what in (
        (dict(export_ply=True), "PLY export"),
        (dict(pts_output_dir=str(tmp_path)), "PLY export"),
    ):
        with pytest.raises(NotImplementedError, match=what):
            check_slice(cfg(**mdi))
    c = cfg()
    c.mdi.alignment.segmentation.method = "sam"
    with pytest.raises(NotImplementedError, match="SAM"):
        Runner(c, device="cpu")
    for ported in ("metric3d", "depth_anything_v2", "moge", "unidepth", "depth_pro"):
        check_slice(cfg(predictor=ported))  # every depth network runs; metric3d is the default
    c = cfg(export_ply=True)
    c.init_type = "sfm"
    check_slice(c)  # mdi settings are not read unless the init uses them


def test_runner_and_init_default_to_cuda(colmap_scene, monkeypatch):
    data_dir, _ = colmap_scene
    cfg = Config(data_dir=data_dir, data_factor=1, test_every=4, init_type="monocular_depth")
    cfg.mdi.predictor = "stub"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Runner(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pts_and_rgb_from_monocular_depth(cfg, Parser(data_dir, test_every=4))


def test_every_image_skipped_raises(colmap_scene, tmp_path):
    data_dir, _ = colmap_scene
    cfg = Config(data_dir=data_dir, data_factor=1, test_every=4, init_type="monocular_depth")
    cfg.mdi.predictor = "stub"
    cfg.mdi.use_cache = False
    cfg.mdi.alignment.min_valid_sfm_fraction = 1.01
    with pytest.raises(LowDepthAlignmentConfidenceError):
        pts_and_rgb_from_monocular_depth(cfg, Parser(data_dir, test_every=4), device=CPU)
