"""Parity at scale: the port's repairs of the monocular-depth init's
garden-scale faults against the JAX package, on inputs made with numpy
from a seed, with small block sizes so that several blocks are visited.

- ``ops/knn.knn_self`` (the bounded block search with indices) against the
  brute force ``knn`` of both packages: the port's distances within 1e-5
  abs in float32 and 1e-12 in float64, squared distances within 8 float32
  ulp of |p|^2 + d^2 of the JAX package's (|x|^2 + |y|^2 - 2 x.y in two
  BLAS orders, as ``test_torch_mdi.test_mean_knn_dist_visits_only_
  neighbouring_blocks``), indices equal wherever the float32 distances do
  not tie (float64 points: no ties, all equal).
- ``ops/lof.lof_scores`` through it against the JAX ``lof_scores`` (XLA on
  the CPU): rtol 1e-5, as ``test_torch_mdi.test_lof_scores``. That
  rounding is relative to |p|^2, so the cloud's blobs overlap within a
  few units of the origin (12 tight clusters at |p| ~ 10 put neighbours so
  near that the two orders move LOF by up to 7e-5).
- ``mdi/alignment/interp._scale_outliers`` against the JAX function on 600
  distinct pixels with injected outliers: masks equal; and at M = 20,000
  the port's host allocations (tracemalloc) stay under 200 MB, where the
  JAX form's [M, M] float32 matrix alone is 1.6 GB.
- ``mdi/postprocess.compute_minimal_gaussian_extents`` in blocks smaller
  than the cloud against the JAX function: rtol 1e-6.
- ``mdi/segmentation.slic_depth`` and ``merge_regions`` (numpy reductions)
  against the JAX package's loops, NaN depths included: labels equal.
- The float64 fits: ``weighted_scale_shift`` and ``tps_interpolate_grid``
  against the JAX functions in float64 (``jax.enable_x64``) on the same
  inputs (1e-6), on inputs where the JAX functions in float32, as the
  package runs them, are off by more than 100 times that.
"""
import tracemalloc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_init_tpu.mdi import postprocess as jpost
from gs_init_tpu.mdi import segmentation as jseg
from gs_init_tpu.mdi.alignment import interp as jinterp
from gs_init_tpu.mdi.alignment import lstsqrs as jlsq
from gs_init_tpu.ops import knn as jknn
from gs_init_tpu.ops import lof as jlof
from gs_init_tpu.ops import rbf as jrbf
from gs_init_tpu_torch.mdi import postprocess as ppost
from gs_init_tpu_torch.mdi import segmentation as pseg
from gs_init_tpu_torch.mdi.alignment import interp as pinterp
from gs_init_tpu_torch.mdi.alignment.lstsqrs import weighted_scale_shift
from gs_init_tpu_torch.ops import knn as pknn
from gs_init_tpu_torch.ops import lof as plof
from gs_init_tpu_torch.ops import rbf as prbf
from torch_parity import CPU, n, t


def clustered(rng, n_pts, n_clusters=12, spread=0.2):
    """Gaussian clusters of unequal size: a surface-like cloud's blocks."""
    centres = rng.normal(size=(n_clusters, 3)) * 3
    return centres[rng.integers(0, n_clusters, n_pts)] + rng.normal(size=(n_pts, 3)) * spread


def untied(pts, d, ulps=8):
    """[N, k] mask of the entries whose squared distance lies more than
    `ulps` float32 ulp of |p|^2 + d^2 from every other entry's of its row:
    the order among nearer ones is each package's rounding and top-k."""
    d2 = d.astype(np.float64) ** 2
    tol = ulps * np.finfo(np.float32).eps * ((pts.astype(np.float64) ** 2).sum(-1, keepdims=True) + d2)
    near = np.abs(d2[:, :, None] - d2[:, None, :]) <= tol[:, :, None]
    return near.sum(-1) == 1


# ---------------------------------------------------------------- kNN, LOF


@pytest.mark.parametrize("k", [9, 41])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_knn_self_matches_knn(rng, k, dtype):
    pts = clustered(rng, 3000)
    p = torch.as_tensor(pts, dtype=dtype)
    want_d, want_i = pknn.knn(p, p, k, chunk=256, point_chunk=512)
    got_d, got_i = pknn.knn_self(p, k, chunk=128)  # 24 blocks
    if dtype == torch.float64:
        np.testing.assert_allclose(n(got_d), n(want_d), atol=1e-12)
        np.testing.assert_array_equal(n(got_i), n(want_i))
        return
    np.testing.assert_allclose(n(got_d), n(want_d), atol=1e-5)
    # The k-th column can tie with the (k+1)-th one, which knn_self does not see.
    ok = untied(pts, n(pknn.knn(p, p, k + 1)[0]))[:, :k]
    np.testing.assert_array_equal(n(got_i)[ok], n(want_i)[ok])
    assert ok.mean() > 0.95
    # And the JAX package's brute force, the same neighbours.
    p32 = pts.astype(np.float32)
    jd, ji = jknn.knn(jnp.asarray(p32), jnp.asarray(p32), k=k, chunk=256, point_chunk=512)
    jd = np.asarray(jd, np.float64)
    ulp = np.finfo(np.float32).eps * ((p32.astype(np.float64) ** 2).sum(-1, keepdims=True) + jd**2)
    assert (np.abs(n(got_d).astype(np.float64) ** 2 - jd**2) <= 8 * ulp).all()
    np.testing.assert_array_equal(n(got_i)[ok], np.asarray(ji)[ok])


def test_knn_self_in_two_dimensions(rng):
    """Pixel coordinates (2-D) take the Morton order over a zero third axis."""
    pix = rng.uniform(0, [1296, 840], (2000, 2))
    p = torch.as_tensor(pix)
    want_d, want_i = pknn.knn(p, p, 9)
    got_d, got_i = pknn.knn_self(p, 9, chunk=64)
    np.testing.assert_array_equal(n(got_i), n(want_i))
    np.testing.assert_allclose(n(got_d), n(want_d), atol=1e-9)


@pytest.mark.parametrize("k", [10, 40])
def test_lof_scores_on_a_clustered_cloud_matches_jax(rng, k):
    blobs = rng.uniform(-1, 1, (12, 3))[rng.integers(0, 12, 2500)] + rng.normal(0, 0.3, (2500, 3))
    pts = np.concatenate([blobs, rng.uniform(-4, 4, (40, 3))]).astype(np.float32)
    js = np.asarray(jlof.lof_scores(jnp.asarray(pts), k=k, chunk=256))
    ps = n(plof.lof_scores(t(pts), k=k, chunk=128))
    np.testing.assert_allclose(ps, js, rtol=1e-5)
    assert (ps[-40:] > 1.5).mean() > 0.5  # the scattered points score as outliers
    assert (ps[:-40] < 1.5).mean() > 0.95


# ---------------------------------------------------------------- scale outliers


def scale_factors(rng, m, n_out):
    """m distinct pixels with smooth scale factors and n_out outliers."""
    pix = rng.uniform(0, [1296, 840], (m, 2)).astype(np.float32)
    f = (1.0 + 0.05 * np.sin(pix[:, 0] / 300) + 0.03 * np.cos(pix[:, 1] / 200)).astype(np.float32)
    out = rng.choice(m, n_out, replace=False)
    f[out] *= rng.choice([0.5, 1.8], n_out).astype(np.float32)
    valid = rng.uniform(size=m) > 0.05
    return pix, f, valid, out


@pytest.mark.parametrize("knn_k,lof_k", [(8, 20), (4, 10)])
def test_scale_outliers_matches_jax(rng, knn_k, lof_k):
    pix, f, valid, out = scale_factors(rng, 600, 30)
    kw = dict(knn_k=knn_k, knn_threshold=2.0, lof_k=lof_k, lof_threshold=1.5)
    want = jinterp._scale_outliers(pix, f, valid, **kw)
    got = pinterp._scale_outliers(pix, f, valid, device=CPU, **kw)
    np.testing.assert_array_equal(got, want)
    assert not got[out[valid[out]]].any() and got.sum() > 400


def test_scale_outliers_allocates_no_square_block(rng):
    pix, f, valid, _ = scale_factors(rng, 20_000, 200)
    tracemalloc.start()
    try:
        keep = pinterp._scale_outliers(pix, f, valid, device=CPU)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 200e6, f"{peak / 1e6:.0f} MB on the host"
    assert keep.sum() > 0.9 * valid.sum()


# ---------------------------------------------------------------- minimal extents


@pytest.mark.parametrize("block", [64, 1000, 1 << 16])
def test_minimal_extents_in_blocks_match_jax(rng, monkeypatch, block):
    monkeypatch.setattr(ppost, "EXTENT_BLOCK", block)
    n_pts, n_cams = 1000, 5
    pts = np.stack(
        [rng.uniform(-0.5, 0.5, n_pts), rng.uniform(-0.4, 0.4, n_pts), rng.uniform(-1, 5, n_pts)], -1
    ).astype(np.float32)
    vm = np.repeat(np.eye(4, dtype=np.float32)[None], n_cams, 0)
    vm[:, 0, 3] = np.linspace(-0.3, 0.3, n_cams)
    vm[:, 2, 3] = np.linspace(0.0, 0.8, n_cams)
    K = np.array([[[100.0, 0, 32], [0, 90.0, 24], [0, 0, 1]]] * n_cams, np.float32)
    K[:, 0, 0] += np.arange(n_cams) * 7.0
    want = jpost.compute_minimal_gaussian_extents(pts, vm, K, [64] * n_cams, [48] * n_cams)
    got = ppost.compute_minimal_gaussian_extents(pts, vm, K, [64] * n_cams, [48] * n_cams, device=CPU)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (got == -1).any() and (got > 0).any()


# ---------------------------------------------------------------- SLIC and region merging


@pytest.mark.parametrize("h,w,seed", [(120, 160, 1), (97, 131, 2), (210, 280, 3)])
def test_slic_and_merge_regions_match_jax(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    depth = (2 + np.sin(xx / (w / 8)) + 0.5 * np.cos(yy / (h / 9)) + (xx > w * 0.55)
             + rng.normal(0, 0.01, (h, w))).astype(np.float32)
    mask = rng.uniform(size=(h, w)) > 0.02
    depth[~mask & (xx < w // 3)] = np.nan  # NaN gradients on some borders
    sfm = np.stack([rng.uniform(0, w * 0.6, 600), rng.uniform(0, h, 600)], 1).astype(np.float32)
    labels = pseg.slic_depth(depth, mask)
    np.testing.assert_array_equal(labels, jseg.slic_depth(depth, mask))
    got = pseg.merge_regions(labels, depth, sfm)
    np.testing.assert_array_equal(got, jseg.merge_regions(labels, depth, sfm))
    assert 1 < len(np.unique(got)) < len(np.unique(labels))


# ---------------------------------------------------------------- float64 fits


@pytest.mark.parametrize("spread", [0.05, 0.005])
def test_weighted_scale_shift_on_a_narrow_depth_range(rng, spread):
    """A region on one surface patch: depths 2.5 +- spread, exactly affine.
    The port against the JAX function in float64 (jax.enable_x64) on the
    same float32 inputs, within 1e-6; the JAX function in float32, as the
    package runs it, is off by more than 1e-4."""
    gt = 2.5 + rng.uniform(-spread, spread, (20, 12))
    pred = (0.37 * 0.8 * gt + 1.3).astype(np.float32)
    gt = gt.astype(np.float32)
    w = np.ones_like(gt)
    with jax.enable_x64(True):
        s64, t64 = (np.asarray(x) for x in jlsq.weighted_scale_shift(
            *(jnp.asarray(a.astype(np.float64)) for a in (pred, gt, w))))
        assert s64.dtype == np.float64
    s, t_ = weighted_scale_shift(t(pred), t(gt), t(w))
    np.testing.assert_allclose(n(s), s64, rtol=1e-6)
    np.testing.assert_allclose(n(t_), t64, rtol=1e-6, atol=1e-6)
    s32, _ = jlsq.weighted_scale_shift(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(w))
    assert np.abs(np.asarray(s32) / s64 - 1).max() > 1e-4


def test_tps_grid_in_float64(rng, monkeypatch):
    """Clustered centres at pixel coordinates with values near 1, a few of
    them invalid: a system that float32 cannot solve to the values' own
    digits. The port against the JAX function in float64 (jax.enable_x64)
    on the same inputs, within 1e-6 of the map (the port upsamples in
    float32); the JAX function in float32 is off by more than 1e-4. The
    grid is evaluated in several blocks."""
    m, h, w = 1200, 840, 1296
    c = rng.uniform([300, 200], [1000, 640], (8, 2))
    pix = (c[rng.integers(0, 8, m)] + rng.normal(0, 40, (m, 2))).astype(np.float32)
    f = (1 + rng.normal(0, 3e-4, m)).astype(np.float32)
    valid = rng.uniform(size=m) > 0.05
    with jax.enable_x64(True):
        want = np.asarray(jrbf.tps_interpolate_grid(
            jnp.asarray(pix.astype(np.float64)), jnp.asarray(f.astype(np.float64)), jnp.asarray(valid), h, w,
            grid_width=128))
        assert want.dtype == np.float64
    monkeypatch.setattr(prbf, "EVAL_BLOCK", 2048)  # 128 x 83 queries: 6 blocks
    got = n(prbf.tps_interpolate_grid(t(pix), t(f), torch.as_tensor(valid), h, w, grid_width=128))
    np.testing.assert_allclose(got, want, atol=1e-6)
    want32 = np.asarray(jrbf.tps_interpolate_grid(jnp.asarray(pix), jnp.asarray(f), jnp.asarray(valid), h, w,
                                                  grid_width=128))
    assert np.abs(want32 - want).max() > 1e-4
