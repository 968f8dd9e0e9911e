"""Parity: the port's alignment pipeline and point-cloud postprocessing
against the JAX package — interpolated alignment (Delaunay and RBF scale
maps), SLIC / region merging / margin (the numpy copies: exact),
``align_depth`` with SLIC, the minimal extents, the voxel merge, and the
port's own build of the native KD-split merge against the JAX package's.

Tolerances: the numpy copies and the native merge exactly; masks exactly;
aligned depths within 1e-5 relative on the Delaunay path (scipy on the
same inputs, then a bilinear upsampling and an f32 closed-form fit) and
within 1e-3 relative on the RBF path, whose dense f32 TPS solve over pixel
coordinates has a condition number near 1e9 in both packages (the
interpolant, not its weights, is what agrees); minimal extents within 1e-6
relative. ``align_depth`` with SLIC fits each small region on its own: its
predicted depths span 0.1-0.3, and there the f32 normal equations lose
three digits in either package (over 20 draws at a span of 0.1 each
package's scale was up to 1.2e-3 from a float64 least-squares fit), so its
aligned depths agree within 5e-3 relative; its masks exactly.
"""
import jax
import numpy as np
import pytest
import torch

from gs_init_tpu.config import DepthAlignmentConfig as JDepthAlignmentConfig
from gs_init_tpu.mdi import postprocess as jpost
from gs_init_tpu.mdi import segmentation as jseg
from gs_init_tpu.mdi.alignment.interp import align_interpolate as j_align_interpolate
from gs_init_tpu.mdi.alignment.pipeline import align_depth as j_align_depth
from gs_init_tpu.native import subsampling as jnative
from gs_init_tpu_torch import native
from gs_init_tpu_torch.config import DepthAlignmentConfig
from gs_init_tpu_torch.mdi import postprocess as ppost
from gs_init_tpu_torch.mdi import segmentation as pseg
from gs_init_tpu_torch.mdi.alignment.interp import align_interpolate
from gs_init_tpu_torch.mdi.alignment.pipeline import INVALID_DEPTH, align_depth
from torch_parity import CPU, jax_hypotheses


def _varying_scale(rng, h=48, w=64, m=250):
    """A depth map under a spatially varying multiplicative distortion and
    SfM correspondences on it (tests/test_alignment_pipeline.py)."""
    xs, ys = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    true = (2.0 + 0.01 * xs + 0.02 * ys).astype(np.float32)
    pred = (true / (1.0 + 0.5 * xs / w)).astype(np.float32)
    px, py = rng.uniform(0, w - 1, m), rng.uniform(0, h - 1, m)
    pix = np.stack([px, py], -1).astype(np.float32)
    gt = true[py.astype(int), px.astype(int)]
    pred_at = pred[py.astype(int), px.astype(int)]
    return true, pred, pix, gt, pred_at


@pytest.mark.parametrize("method,rtol", [("delaunay", 1e-5), ("rbf", 1e-3)])
def test_align_interpolate(rng, method, rtol):
    true, pred, pix, gt, pred_at = _varying_scale(rng)
    valid = np.ones(len(gt), bool)
    cfgs = []
    for C in (JDepthAlignmentConfig, DepthAlignmentConfig):
        c = C()
        c.interp.method = method
        c.interp.prealign = "lstsqrs"
        c.interp.rbf_grid_width = 32
        cfgs.append(c)
    want = j_align_interpolate(pred, pred_at, gt, pix, valid, jax.random.PRNGKey(0), cfgs[0])
    got = align_interpolate(pred, pred_at, gt, pix, valid, cfgs[1], device=CPU)
    np.testing.assert_allclose(got, want, rtol=rtol)
    assert np.median(np.abs(got - true) / true) < 0.04


def test_align_interpolate_ransac_prealign(rng):
    """The RANSAC pre-alignment with the JAX package's hypotheses."""
    true, pred, pix, gt, pred_at = _varying_scale(rng)
    valid = np.ones(len(gt), bool)
    key = jax.random.PRNGKey(2)
    jc, pc = JDepthAlignmentConfig(), DepthAlignmentConfig()
    for c in (jc, pc):
        c.ransac.max_iterations = 300
        c.interp.rbf_grid_width = 32
    want = j_align_interpolate(pred, pred_at, gt, pix, valid, key, jc)
    idx = torch.as_tensor(jax_hypotheses(key, valid, 300), dtype=torch.int64)
    got = align_interpolate(pred, pred_at, gt, pix, valid, pc, idx=idx, device=CPU)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _two_planes(rng, h=40, w=60, m=300):
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    true = 2.0 + 0.01 * xs + 0.02 * ys
    true[:, w // 2:] += 4.0
    true = true.astype(np.float32)
    pred = true.copy()
    pred[:, : w // 2] = true[:, : w // 2] * 0.5 + 0.3
    pred[:, w // 2:] = true[:, w // 2:] * 1.5 - 1.0
    px, py = rng.uniform(0, w - 1, m), rng.uniform(0, h - 1, m)
    pix = np.stack([px, py], -1).astype(np.float32)
    return true, pred, pix, true[py.astype(int), px.astype(int)]


def test_slic_merge_margin_exact(rng):
    true, pred, pix, _ = _two_planes(rng)
    mask = rng.uniform(size=pred.shape) > 0.05
    for kw in (dict(n_segments=12), dict(n_segments=30, compactness=0.05)):
        lp, lj = pseg.slic_depth(pred, mask, **kw), jseg.slic_depth(pred, mask, **kw)
        np.testing.assert_array_equal(lp, lj)
    mp = pseg.merge_regions(lp, pred / 5.0, pix, gradient_threshold=0.01, min_sfm_points=2)
    mj = jseg.merge_regions(lj, pred / 5.0, pix, gradient_threshold=0.01, min_sfm_points=2)
    np.testing.assert_array_equal(mp, mj)
    assert 2 <= len(np.unique(mp)) < len(np.unique(lp))
    np.testing.assert_array_equal(pseg.region_margin_mask(mp, 60.0), jseg.region_margin_mask(mj, 60.0))


@pytest.mark.parametrize("propagate", [False, True])
def test_align_depth_with_slic(rng, propagate):
    true, pred, pix, gt = _two_planes(rng)
    jc, pc = JDepthAlignmentConfig(), DepthAlignmentConfig()
    for c in (jc, pc):
        c.method = "lstsqrs"
        c.segmentation.method = "slic"
        c.segmentation.slic_n_segments = 12
        c.segmentation.merge_gradient_threshold = 0.01
        c.segmentation.region_margin = 60.0
        c.segmentation.propagate_mask = propagate
    args = (pred, np.ones(pred.shape, bool), pix, gt, np.ones(len(gt), bool))
    ja, jm = j_align_depth(*args, jax.random.PRNGKey(0), jc)
    pa, pm = align_depth(*args, pc, device=CPU)
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_array_equal(pa == INVALID_DEPTH, ja == INVALID_DEPTH)
    np.testing.assert_allclose(pa, ja, rtol=5e-3)  # narrow per-region fits (module docstring)
    assert np.median(np.abs(pa[pm] - true[pm]) / true[pm]) < 0.02


def test_minimal_extents(rng):
    pts = np.stack(
        [rng.uniform(-0.4, 0.4, 300), rng.uniform(-0.3, 0.3, 300), rng.uniform(-1, 5, 300)], -1
    ).astype(np.float32)
    vm = np.repeat(np.eye(4, dtype=np.float32)[None], 2, 0)
    vm[1, 0, 3] = 0.3
    K = np.array([[[100.0, 0, 32], [0, 90.0, 24], [0, 0, 1]]] * 2, np.float32)
    want = jpost.compute_minimal_gaussian_extents(pts, vm, K, [64, 64], [48, 48])
    got = ppost.compute_minimal_gaussian_extents(pts, vm, K, [64, 64], [48, 48], device=CPU)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (got == -1).any() and (got > 0).any()


def _clusters(rng):
    centers = rng.uniform(-5, 5, (20, 3)).astype(np.float32)
    pts = (centers[:, None, :] + rng.normal(0, 0.01, (20, 12, 3))).reshape(-1, 3).astype(np.float32)
    rgbs = rng.uniform(0, 1, (240, 3)).astype(np.float32)
    ext = rng.uniform(0.01, 0.5, 240).astype(np.float32)
    ext[:5] = -1.0  # unobserved
    return pts, rgbs, ext


def test_voxel_merge(rng):
    pts, rgbs, ext = _clusters(rng)
    for got, want in zip(ppost.voxel_merge_subsample(pts, rgbs, ext, 1.5),
                         jpost.voxel_merge_subsample(pts, rgbs, ext, 1.5)):
        np.testing.assert_array_equal(got, want)


def test_native_merge_matches_jax_native(rng):
    pts, rgbs, ext = _clusters(rng)
    for kw in (dict(), dict(max_aspect_ratio=2.0, extent_multiplier=3.0)):
        gp, gc = native.subsample_pointcloud(pts, rgbs, ext, **kw)
        wp, wc = jnative.subsample_pointcloud(pts, rgbs, ext, **kw)
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gc, wc)
        assert 0 < len(gp) < len(pts)
    gp, _ = ppost.native_merge_subsample(pts, rgbs, ext)
    assert native.lib_path().parent.name == "_build" and native.lib_path().exists()
    with pytest.raises(ValueError):
        native.subsample_pointcloud(pts[:, :2], rgbs, ext)


def test_native_build_failure_raises(tmp_path, monkeypatch, rng):
    """A failed build raises; the merge does not fall back to voxels."""
    bad = tmp_path / "subsampling.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    pts, rgbs, ext = _clusters(rng)
    with pytest.raises(RuntimeError, match="building native/subsampling.cpp failed"):
        ppost.native_merge_subsample(pts, rgbs, ext)
