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
cloud's extent (each image's (s, t) is a fit over ~40 points whose normal
equations the JAX package sums in float32 and the port in float64: up to
7e-5 relative apart, measured per image on this scene), for every
configuration of the init: RANSAC and MSAC, least squares with LOF and
either merge, the interpolated scale map over Delaunay or the RBF, SLIC
regions and the adaptive stride;
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
from gs_init_tpu_torch.config import Config
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
        elif variant == "msac":
            c.mdi.alignment.method = "msac"
            c.mdi.alignment.ransac.inlier_threshold = 1e-6  # as "ransac"
        elif variant == "interpolate_rbf":
            c.mdi.alignment.method = "interpolate"
            c.mdi.alignment.interp.method = "rbf"
            c.mdi.alignment.interp.prealign = "lstsqrs"
            c.mdi.alignment.interp.rbf_grid_width = 32
        elif variant == "slic":
            c.mdi.alignment.segmentation.method = "slic"
            c.mdi.alignment.segmentation.merge_min_sfm_points = 3
            c.mdi.alignment.ransac.inlier_threshold = 1e-6
        elif variant == "adaptive":
            c.mdi.alignment.method = "lstsqrs"
            c.mdi.subsampling.method = "adaptive"
        elif variant == "voxel":
            c.mdi.alignment.method = "lstsqrs"
            c.mdi.postprocess.lof_outlier_removal = True
            c.mdi.postprocess.lof_neighbors = 8
            c.mdi.postprocess.merge_subsample = True
            c.mdi.postprocess.merge_impl = "voxel"
        cfgs.append(c)
    return cfgs


@pytest.mark.parametrize("variant", ["ransac", "lstsqrs_lof_native", "interpolate_delaunay", "msac", "interpolate_rbf",
                                     "slic", "adaptive", "voxel"])
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
    # similarity scale (the Delaunay map's fit is near 1 too). Under SLIC
    # an image whose regions all hold too few SfM points keeps no point
    # (and reports the degenerate fit (1, 0)).
    fitted = np.array([r["points"] > 0 for r in per_image])
    assert fitted.all() or (variant == "slic" and fitted.mean() >= 0.5)
    ratio = np.array([r["scale"] for r in per_image])[fitted] * 0.37
    assert np.ptp(ratio) < (1e-2 if variant.startswith("interpolate") else 5e-4) * ratio.mean()


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


def test_monocular_depth_settings_the_port_refuses(colmap_scene, tmp_path, monkeypatch):
    """Nothing is refused any more: SAM segmentation runs (a Runner on
    random weights of a narrow SAM, through to a train step), and so does
    ``data_parallel=2`` with the mdi init, whose only meaning is the
    learning-rate batch factor (sqrt 2 here, ``engine/optim.py``)."""
    from gs_init_tpu_torch.mdi import segmentation_sam
    from gs_init_tpu_torch.mdi.predictors import sam_convert

    data_dir, _ = colmap_scene

    def cfg(**mdi):
        c = Config(data_dir=data_dir, data_factor=1, test_every=4, init_type="monocular_depth",
                   result_dir=str(tmp_path / "res"), max_steps=1, eval_steps=[], save_steps=[])
        c.mdi.predictor = "stub"
        for k, v in mdi.items():
            setattr(c.mdi, k, v)
        return c

    c = cfg(use_cache=False)
    seg = c.mdi.alignment.segmentation
    seg.method, seg.sam_variant, seg.sam_img_size = "sam", "tiny", 128
    seg.sam_allow_random_weights = True
    monkeypatch.setenv("GS_TPU_CHECKPOINT_DIR", str(tmp_path / "no_weights"))
    monkeypatch.setitem(sam_convert.SAM_VARIANTS, "tiny",
                        dict(dim=32, depth=2, num_heads=2, global_attn_indexes=(1,)))
    segmentation_sam._cached_generator.cache_clear()
    try:
        runner = Runner(c, device="cpu")
    finally:
        segmentation_sam._cached_generator.cache_clear()
    assert int(runner.gstate.alive.sum()) > len(runner.parser.points)
    assert np.isfinite(float(runner.train_iteration(0)["loss"]))
    c2 = cfg()
    c2.data_parallel = 2
    runner2 = Runner(c2, device="cpu")
    assert runner2.mesh is None
    for k, lr in runner.acfg.lrs.items():
        assert runner2.acfg.lrs[k] == pytest.approx(lr * np.sqrt(2.0), rel=1e-12)
    assert np.isfinite(float(runner2.train_iteration(0)["loss"]))


def test_init_cloud_export_matches_jax(colmap_scene, tmp_path):
    """export_ply and pts_output_per_image write the JAX package's files:
    the same names, point counts and colours, points within 2e-4 of the
    cloud's extent (as test_pts_and_rgb_matches_jax holds the cloud)."""
    from gs_init_tpu.datasets.parser import Parser as JParser
    from gs_init_tpu_torch.utils.ply import read_ply_points

    data_dir, scene = colmap_scene
    jcfg, pcfg = _configs(data_dir, tmp_path, "ransac")
    for c, sub in ((jcfg, "jax"), (pcfg, "port")):
        c.mdi.export_ply = True
        c.mdi.pts_output_per_image = True
        c.mdi.pts_output_dir = str(tmp_path / sub)
    jparser, pparser = JParser(data_dir, factor=1, test_every=4), Parser(data_dir, factor=1, test_every=4)
    j_pts_and_rgb(jcfg, jparser, model=_oracle_stub(JStub, scene, jparser))
    pts, rgb = pts_and_rgb_from_monocular_depth(pcfg, pparser, model=_oracle_stub(StubPredictor, scene, pparser),
                                                device=CPU)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert "mdi_init_points.ply" in names and len(names) == len(pparser.split_indices("train")) + 1
    for name in names:
        (pp, pc), (jp, jc) = (read_ply_points(str(tmp_path / sub / name)) for sub in ("port", "jax"))
        assert pp.shape == jp.shape and len(pp) > 0
        np.testing.assert_array_equal(pc, jc)
        extent = float(np.abs(jp).max())
        np.testing.assert_allclose(pp / extent, jp / extent, atol=2e-4, err_msg=name)
    final = read_ply_points(str(tmp_path / "port" / "mdi_init_points.ply"))
    np.testing.assert_array_equal(final[0], pts)
    np.testing.assert_array_equal(np.round(final[1] * 255), (np.clip(rgb, 0, 1) * 255).astype(np.uint8))


def test_pts_only_exits_after_the_write(colmap_scene, tmp_path):
    data_dir, scene = colmap_scene
    _, pcfg = _configs(data_dir, tmp_path, "ransac")
    pcfg.mdi.pts_only = True
    parser = Parser(data_dir, factor=1, test_every=4)
    with pytest.raises(SystemExit) as exit_info:
        pts_and_rgb_from_monocular_depth(pcfg, parser, model=_oracle_stub(StubPredictor, scene, parser),
                                         device=CPU)
    assert exit_info.value.code == 0
    assert os.path.getsize(tmp_path / "res" / "mdi_init_points.ply") > 0


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


class _Boom:
    """A predictor that must not be asked: every image is in the cache."""

    name = "stub"

    def predict_depth_batch(self, images, intr):
        raise AssertionError("the depth cache should have been used")


def _with_normals(stub):
    """The stub, now returning a unit normal map beside its depth, as
    Metric3D does (a fixed field of directions per image size)."""
    real = stub.predict_depth

    def predict_depth(image, intrinsics):
        out = real(image, intrinsics)
        h, w = out.depth.shape
        yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
        n = np.stack([0.3 * xx, 0.2 * yy, -np.ones_like(xx)], -1)
        return out._replace(normal=(n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32))

    stub.predict_depth = predict_depth
    return stub


def test_port_cache_with_normals_read_by_jax(colmap_scene, tmp_path):
    """The other direction of ``test_runner_initial_state_matches_jax``:
    the port writes the cache with a predictor that returns normals, and
    the JAX init reads it with a predictor that raises. Its entries hold
    the port's depth, mask and normals to the bit, and its cloud equals
    the one of a JAX init that predicted (points and colours)."""
    from gs_init_tpu.datasets.parser import Dataset as JDataset
    from gs_init_tpu.datasets.parser import Parser as JParser
    from gs_init_tpu.mdi.init import _predict_or_cached as j_predict_or_cached

    data_dir, scene = colmap_scene
    jcfg, pcfg = _configs(data_dir, tmp_path, "lstsqrs_lof_native")
    for c in (jcfg, pcfg):
        c.mdi.use_cache = True
        c.mdi.cache_dir = str(tmp_path / "cache")
    jparser, pparser = JParser(data_dir, factor=1, test_every=4), Parser(data_dir, factor=1, test_every=4)
    pstub = _with_normals(_oracle_stub(StubPredictor, scene, pparser))
    pts_and_rgb_from_monocular_depth(pcfg, pparser, model=pstub, device=CPU)
    files = sorted(p for p in (tmp_path / "cache").rglob("*") if p.is_file())
    assert len(files) == len(pparser.split_indices("train"))
    assert all(p.suffix == ".npz" for p in files)  # no *.tmp left behind

    items = [it for it in JDataset(jparser, "train")]
    cached = j_predict_or_cached(jcfg, _Boom(), items)
    want = _with_normals(_oracle_stub(StubPredictor, scene, pparser))
    for it, (depth, mask, normal) in zip(items, cached):
        ref = want.predict_depth(it["image"], None)
        np.testing.assert_array_equal(depth, ref.depth)
        np.testing.assert_array_equal(mask, ref.mask)
        assert normal is not None and normal.dtype == np.float32
        np.testing.assert_array_equal(normal, ref.normal)

    jp, jc = j_pts_and_rgb(jcfg, jparser, model=_Boom())
    jcfg.mdi.use_cache = False
    wp, wc = j_pts_and_rgb(jcfg, jparser, model=_with_normals(_oracle_stub(JStub, scene, jparser)))
    assert len(jp) > 100
    np.testing.assert_array_equal(jp, wp)
    np.testing.assert_array_equal(jc, wc)


def test_cached_depth_of_another_shape_is_refused_by_both(colmap_scene, tmp_path):
    """The cache key, ``<cache_dir>/<predictor>/<dataset>/<image>.npz``,
    names neither the backbone nor ``data_factor``, so an entry written at
    another ``data_factor`` is found under the same key (ROADMAP, reference
    caveats). Both packages then refuse it alike: the init raises (a
    broadcast of the cached depth against the image fails), the predictor
    is not asked, and the entry stays on disk as it was: neither package
    takes it for a corrupted entry to recompute."""
    from gs_init_tpu.datasets.parser import Parser as JParser

    data_dir, _ = colmap_scene
    jcfg, pcfg = _configs(data_dir, tmp_path, "lstsqrs_lof_native")
    for c in (jcfg, pcfg):
        c.mdi.use_cache = True
        c.mdi.cache_dir = str(tmp_path / "cache")
    parser = Parser(data_dir, factor=1, test_every=4)
    train = [parser.images[int(i)] for i in parser.split_indices("train")]
    h, w = train[0].height, train[0].width
    d = tmp_path / "cache" / "stub" / os.path.basename(os.path.normpath(data_dir))
    d.mkdir(parents=True)
    # An entry at half the image's size: what a data_factor twice as large writes.
    for im in train:
        np.savez(d / (im.name.replace("/", "_") + ".npz"), depth=np.full((h // 2, w // 2), 2.0, np.float32),
                 mask=np.ones((h // 2, w // 2), bool))
    before = {p.name: p.read_bytes() for p in d.iterdir()}
    with pytest.raises((TypeError, ValueError)):  # jax.numpy's broadcast
        j_pts_and_rgb(jcfg, JParser(data_dir, factor=1, test_every=4), model=_Boom())
    with pytest.raises(RuntimeError, match="must match the size"):  # torch's broadcast
        pts_and_rgb_from_monocular_depth(pcfg, parser, model=_Boom(), device=CPU)
    assert {p.name: p.read_bytes() for p in d.iterdir()} == before
