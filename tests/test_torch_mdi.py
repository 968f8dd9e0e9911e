"""Parity: the port's monocular-depth-init building blocks against the JAX
package on the same numpy inputs — kNN, LOF, the thin-plate spline and its
bilinear upsampling, least-squares and RANSAC/MSAC alignment (with the JAX
package's hypothesis draws passed in), the four subsampling masks,
``points_from_depth`` and ``masks_and_unproject``.

Tolerances: 1e-5 abs/rel for elementwise values; exact for masks and
indices. kNN distances within 1e-5 abs (|x|^2 + |y|^2 - 2 x.y in two BLAS
orders). World points within 1e-5 of their scale (a 3x3 inverse and two
products in two orders). Two closed forms are looser, for the reason
stated at each: a (s, t) fit is 2x2 normal equations, summed in float32 by
the JAX package (in float64 by the port), solved through differences of
products that cancel (det = a00 a11 - a01^2 loses about log10(mean^2 /
var) of the prediction's float32 digits): 1e-5 where the depths span a
wide range, 1e-4 after a LO refit over a hundred points, 1e-3 for depths
in [2.2, 2.6] (mean^2 / var ~ 400). The TPS solve is a dense f32 system
whose condition grows with the squared coordinates: 7e4 for centres in [0,
6], so its weights and affine part agree to the forward-error bound cond x
eps = 5e-3 of their largest, and the interpolant they define (the port's
grid solves in float64) to 1e-4 of the values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_init_tpu.mdi import points_from_depth as jpfd
from gs_init_tpu.mdi import subsampling as jsub
from gs_init_tpu.mdi.alignment.lstsqrs import weighted_scale_shift as j_wss
from gs_init_tpu.mdi.alignment.ransac import ransac_scale_shift as j_ransac
from gs_init_tpu.ops import knn as jknn
from gs_init_tpu.ops import lof as jlof
from gs_init_tpu.ops import rbf as jrbf
from gs_init_tpu_torch.mdi import points_from_depth as ppfd
from gs_init_tpu_torch.mdi import subsampling as psub
from gs_init_tpu_torch.mdi.alignment.lstsqrs import weighted_scale_shift
from gs_init_tpu_torch.mdi.alignment.ransac import ransac_scale_shift, sample_hypotheses
from gs_init_tpu_torch.ops import knn as pknn
from gs_init_tpu_torch.ops import lof as plof
from gs_init_tpu_torch.ops import rbf as prbf
from torch_parity import assert_close_scaled, jax_hypotheses, n, t


# ---------------------------------------------------------------- kNN, LOF


@pytest.mark.parametrize("m,n_pts,k,chunk,point_chunk", [(70, 90, 5, 32, 40), (50, 50, 9, 2048, 16384)])
def test_knn(rng, m, n_pts, k, chunk, point_chunk):
    q = rng.normal(size=(m, 3)).astype(np.float32)
    p = rng.normal(size=(n_pts, 3)).astype(np.float32)
    jd, ji = jknn.knn(jnp.asarray(q), jnp.asarray(p), k=k, chunk=chunk, point_chunk=point_chunk)
    pd, pi = pknn.knn(t(q), t(p), k=k, chunk=chunk, point_chunk=point_chunk)
    np.testing.assert_array_equal(n(pi), n(ji))
    np.testing.assert_allclose(n(pd), n(jd), atol=1e-5)


@pytest.mark.parametrize("chunk", [128, 4096])
def test_mean_knn_dist_visits_only_neighbouring_blocks(rng, chunk):
    """The kNN scale init over a cloud of many blocks (a dense ball, a wall
    and a ground plane of a clustered scene, and one far outlier) equals
    the blocked brute force ``knn`` over every pair, and the JAX package's
    ``mean_knn_dist``."""
    ball = rng.normal(0, 0.35, (1200, 3))
    ang = rng.uniform(0, 2 * np.pi, 1000)
    wall = np.stack([6 * np.cos(ang), rng.uniform(-2.2, 2.2, 1000), 6 * np.sin(ang)], -1)
    ground = np.stack([rng.uniform(-6, 6, 800), np.full(800, 2.3), rng.uniform(-6, 6, 800)], -1)
    p = np.concatenate([ball, wall, ground, [[30.0, -20.0, 10.0]]]).astype(np.float32)
    got = n(pknn.mean_knn_dist(t(p), k=3, chunk=chunk))
    d, _ = pknn.knn(t(p), t(p), k=4, chunk=128, point_chunk=512)
    np.testing.assert_allclose(got, n(torch.sqrt((d[:, 1:] ** 2).mean(-1))), rtol=1e-6)
    # Against JAX: |x|^2 + |y|^2 - 2 x.y in two BLAS orders rounds apart by
    # a few ulp of |x|^2 (1.8 measured), far above 1e-5 of a neighbour's
    # distance on the wall.
    want = np.asarray(jknn.mean_knn_dist(jnp.asarray(p), k=3)).astype(np.float64)
    ulp = np.finfo(np.float32).eps * ((p.astype(np.float64) ** 2).sum(-1) + want**2)
    assert (np.abs(got.astype(np.float64) ** 2 - want**2) <= 8 * ulp).all()
    assert got[-1] > 10 * np.median(got)  # the outlier's neighbours lie in far blocks


def test_lof_scores(rng):
    cluster = rng.normal(0, 0.1, (120, 3)).astype(np.float32)
    outliers = rng.uniform(3, 5, (6, 3)).astype(np.float32)
    pts = np.concatenate([cluster, outliers])
    js = np.asarray(jlof.lof_scores(jnp.asarray(pts), k=10, chunk=64))
    ps = n(plof.lof_scores(t(pts), k=10, chunk=64))
    np.testing.assert_allclose(ps, js, rtol=1e-5)
    np.testing.assert_array_equal(
        n(plof.lof_inlier_mask(t(pts), k=10, threshold=1.5)),
        np.asarray(jlof.lof_inlier_mask(jnp.asarray(pts), k=10, threshold=1.5)),
    )
    assert not n(plof.lof_inlier_mask(t(pts), k=10))[120:].any()


# ---------------------------------------------------------------- TPS


def test_tps_fit_and_eval(rng):
    centers = rng.uniform(0, 6, (30, 2)).astype(np.float32)
    # A smooth field with noise, as the per-point scale factors are.
    vals = (1.0 + 0.05 * centers[:, 0] - 0.03 * centers[:, 1] + rng.normal(0, 0.01, 30)).astype(np.float32)
    valid = np.arange(30) < 24  # six padded centres
    jw, jp = jrbf.tps_fit(jnp.asarray(centers), jnp.asarray(vals), jnp.asarray(valid), smoothing=1e-3)
    pw, pp = prbf.tps_fit(t(centers), t(vals), torch.as_tensor(valid), smoothing=1e-3)
    for got, want in ((pw, jw), (pp, jp)):  # cond 7e4 (module docstring)
        assert_close_scaled(got, want, 5e-3)
    assert np.abs(n(pw)[24:]).max() < 1e-6
    q = rng.uniform(0, 6, (40, 2)).astype(np.float32)
    assert_close_scaled(
        prbf.tps_eval(t(centers), pw, pp, t(q)),
        jrbf.tps_eval(jnp.asarray(centers), jw, jp, jnp.asarray(q)), 1e-4,
    )


@pytest.mark.parametrize("h,w,gh,gw", [(48, 64, 17, 23), (30, 41, 30, 41), (9, 50, 2, 7)])
def test_upsample_bilinear_matches_jax_resize(rng, h, w, gh, gw):
    """F.interpolate(bilinear, align_corners=False) against
    jax.image.resize(bilinear) at non-integer ratios, borders included."""
    coarse = rng.normal(size=(gh, gw)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(coarse), (h, w), "bilinear"))
    np.testing.assert_allclose(n(prbf.upsample_bilinear(t(coarse), h, w)), want, atol=1e-5)


def test_tps_interpolate_grid(rng):
    h, w = 40, 60
    centers = rng.uniform(0, [w, h], (50, 2)).astype(np.float32)
    vals = (0.01 * centers[:, 0] + 0.02 * centers[:, 1] + 1.0 + rng.normal(0, 0.01, 50)).astype(np.float32)
    valid = np.arange(50) < 45
    want = np.asarray(jrbf.tps_interpolate_grid(
        jnp.asarray(centers), jnp.asarray(vals), jnp.asarray(valid), h, w, 32, smoothing=1e-3
    ))
    got = n(prbf.tps_interpolate_grid(t(centers), t(vals), torch.as_tensor(valid), h, w, 32, smoothing=1e-3))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ alignment


def test_weighted_scale_shift(rng):
    d = rng.uniform(1, 5, (3, 200)).astype(np.float32)
    gt = (2.5 * d + 0.7).astype(np.float32)
    gt[:, :50] += 3.0
    w = (rng.uniform(size=d.shape) > 0.3).astype(np.float32)
    w[2] = 0.0  # degenerate: (1, 0)
    js, jt = j_wss(jnp.asarray(d), jnp.asarray(gt), jnp.asarray(w))
    ps, pt = weighted_scale_shift(t(d), t(gt), t(w))
    np.testing.assert_allclose(n(ps), np.asarray(js), rtol=1e-5)
    np.testing.assert_allclose(n(pt), np.asarray(jt), rtol=1e-5, atol=1e-5)
    assert n(ps)[2] == 1.0 and n(pt)[2] == 0.0


def _outliers(rng):
    m = 400
    d = rng.uniform(1, 5, m).astype(np.float32)
    gt = 0.8 * d + 0.3
    gt[rng.choice(m, 120, replace=False)] += rng.uniform(1, 10, 120)
    d = np.concatenate([d, np.zeros(56, np.float32)])  # padding must not count
    gt = np.concatenate([gt, np.full(56, 1e6)]).astype(np.float32)
    return d, gt, np.arange(456) < 400, 500, False


def _narrow(rng):  # tests/test_mdi.py: a positive-scale prior case
    m = 60
    d = rng.uniform(2.2, 2.6, m).astype(np.float32)
    gt = 0.9 * d - 1.2
    gt[rng.choice(m, 40, replace=False)] += rng.uniform(0.05, 0.5, 40)
    return d, gt.astype(np.float32), np.ones(m, bool), 800, False


_narrow.rtol = 1e-3  # depths in [2.2, 2.6]: the normal equations cancel (module docstring)


def _anti(rng):  # every hypothesis has s <= 0: the median-ratio fallback
    d = rng.uniform(1.0, 5.0, 64).astype(np.float32)
    return d, (-0.8 * d + 6.0).astype(np.float32), np.ones(64, bool), 400, False


def _msac(rng):
    d = rng.uniform(1, 5, 200).astype(np.float32)
    gt = 1.5 * d - 0.2
    gt[:40] += 5.0
    return d, gt.astype(np.float32), np.ones(200, bool), 400, True


@pytest.mark.parametrize("case", [_outliers, _narrow, _anti, _msac], ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("seed", [0, 3])
def test_ransac_with_jax_hypotheses(rng, case, seed):
    d, gt, valid, num_hyp, msac = case(rng)
    key = jax.random.PRNGKey(seed)
    js, jt, jin = j_ransac(
        jnp.asarray(d), jnp.asarray(gt), jnp.asarray(valid), key, num_hyp=num_hyp, msac=msac
    )
    idx = jax_hypotheses(key, valid, num_hyp)
    ps, pt, pin = ransac_scale_shift(
        t(d), t(gt), torch.as_tensor(valid), idx=torch.as_tensor(idx, dtype=torch.int64),
        num_hyp=num_hyp, msac=msac,
    )
    rtol = getattr(case, "rtol", 1e-5)
    np.testing.assert_allclose(float(ps), float(js), rtol=rtol)
    np.testing.assert_allclose(float(pt), float(jt), rtol=rtol, atol=1e-5)
    np.testing.assert_array_equal(n(pin), np.asarray(jin))
    assert float(ps) > 0.0
    if case is _anti:
        assert float(pt) == 0.0


def test_sample_hypotheses_uniform_over_valid():
    valid = torch.zeros(50, dtype=torch.bool)
    valid[[3, 7, 8, 20, 49]] = True
    g = torch.Generator().manual_seed(0)
    idx = sample_hypotheses(valid, 4000, 4, g)
    assert idx.shape == (4000, 4)
    counts = torch.bincount(idx.reshape(-1), minlength=50)
    assert set(torch.nonzero(counts).flatten().tolist()) == {3, 7, 8, 20, 49}
    assert float(counts[valid].float().std() / counts[valid].float().mean()) < 0.05
    assert not sample_hypotheses(torch.zeros(5, dtype=torch.bool), 3, 4, g).any()  # none valid


# ---------------------------------------------------------------- masks


def test_static_mask():
    np.testing.assert_array_equal(n(psub.static_mask(20, 30, 7)), np.asarray(jsub.static_mask(20, 30, 7)))


def test_adaptive_mask(rng):
    h, w = 60, 90
    depth = (np.linspace(1, 10, w)[None, :] + rng.normal(0, 0.3, (h, w))).astype(np.float32)
    mask = rng.uniform(size=(h, w)) > 0.1
    depth[~mask] = 1e4  # masked pixels must not move the IQR range
    want = np.asarray(jsub.adaptive_mask(jnp.asarray(depth), jnp.asarray(mask), 2, 8))
    got = n(psub.adaptive_mask(t(depth), torch.as_tensor(mask), 2, 8))
    np.testing.assert_array_equal(got, want)
    assert got[:, -w // 3:].mean() > 2 * got[:, : w // 3].mean()


def test_sfm_density_mask(rng):
    xy = np.concatenate([np.full((50, 2), 1.0), rng.uniform(-5, 100, (60, 2))]).astype(np.float32)
    valid = rng.uniform(size=110) > 0.2
    want = np.asarray(jsub.sfm_density_mask(jnp.asarray(xy), jnp.asarray(valid), 97, 131, 10, 3))
    got = n(psub.sfm_density_mask(t(xy), torch.as_tensor(valid), 97, 131, 10, 3))
    np.testing.assert_array_equal(got, want)
    assert not got[:5, :5].any() and got.mean() > 0.5


def test_depth_gradient_mask(rng):
    depth = (3.0 + rng.normal(0, 0.01, (20, 24))).astype(np.float32)
    depth[:, 12:] += 4.0
    depth[2:5, 18:] = np.nan  # a masked-out patch
    want = np.asarray(jsub.depth_gradient_mask(jnp.asarray(depth), 0.2))
    got = n(psub.depth_gradient_mask(t(depth), 0.2))
    np.testing.assert_array_equal(got, want)
    assert not got[10, 12] and not got[3, 18] and got[10, 3]


# ------------------------------------------------------ points from depth


def _view(rng, width=64, height=48):
    """A slanted plane seen by one camera, SfM points on it (some off-frame
    and some padding), and a noise-free affine-distorted prediction."""
    f = 0.9 * width
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1, -0.2, 0.3]
    ys, xs = np.mgrid[0:height, 0:width] + 0.5
    true = 1.0 + 0.05 * xs + 0.06 * ys
    true[:, 40:] += 2.0  # a step, which the depth-gradient mask cuts
    true = true.astype(np.float32)
    pred = (0.37 * true + 1.3).astype(np.float32)
    pmask = np.ones((height, width), bool)
    pmask[:, :3] = False
    m = 80
    px = rng.uniform(-6, width + 6, m)
    py = rng.uniform(0, height, m)
    z = true[np.clip(py.astype(int), 0, height - 1), np.clip(px.astype(int), 0, width - 1)]
    cam = np.stack([(px - K[0, 2]) / f * z, (py - K[1, 2]) / f * z, z], -1)
    world = cam + c2w[:3, 3]
    sfm = np.zeros((96, 3), np.float32)
    sfm[:m] = world
    valid = np.arange(96) < m
    return pred, pmask, c2w, K, sfm, valid, width, height


@pytest.mark.parametrize("align", ["lstsqrs", "ransac"])
@pytest.mark.parametrize("sub", ["static", "adaptive"])
def test_points_from_depth(rng, align, sub):
    pred, pmask, c2w, K, sfm, valid, w, h = _view(rng)
    kw = dict(
        width=w, height=h, align_method=align, subsample_method=sub, subsample_factor=3,
        min_stride=2, max_stride=6, use_grad_mask=True, grad_threshold=0.5,
        use_sfm_density_mask=True, ransac_iters=300,
    )
    key = jax.random.PRNGKey(7)
    J = jnp.asarray
    jo = jpfd.points_from_depth(J(pred), J(pmask), J(c2w), J(K), J(sfm), J(valid), key, **kw)
    idx = None
    if align == "ransac":
        pix, _, ok = jpfd.project_sfm_points(J(sfm), J(valid), jnp.linalg.inv(J(c2w)), J(K), w, h)
        corr_ok = ok & jpfd._sample_depth_at(J(pmask), pix)
        idx = torch.as_tensor(jax_hypotheses(key, corr_ok, 300), dtype=torch.int64)
    po = ppfd.points_from_depth(
        t(pred), torch.as_tensor(pmask), t(c2w), t(K), t(sfm), torch.as_tensor(valid), idx, **kw
    )
    assert abs(float(po.scale) - 1 / 0.37) < 1e-3  # noise-free: the distortion undone
    # A refit over ~80 points: 1e-4 (module docstring).
    np.testing.assert_allclose(float(po.scale), float(jo.scale), rtol=1e-4)
    np.testing.assert_allclose(float(po.shift), float(jo.shift), rtol=1e-4)
    np.testing.assert_allclose(float(po.valid_sfm_fraction), float(jo.valid_sfm_fraction), rtol=1e-6)
    np.testing.assert_array_equal(n(po.mask), np.asarray(jo.mask))
    assert n(po.mask).sum() > 20
    pw, jw = n(po.pts_world), np.asarray(jo.pts_world)
    np.testing.assert_allclose(pw / np.abs(jw).max(), jw / np.abs(jw).max(), atol=1e-5)


def test_masks_and_unproject(rng):
    pred, pmask, c2w, K, sfm, valid, w, h = _view(rng)
    J = jnp.asarray
    pix, _, ok = jpfd.project_sfm_points(J(sfm), J(valid), jnp.linalg.inv(J(c2w)), J(K), w, h)
    aligned = (pred - 1.3) / 0.37
    aligned[5:9, 10:20] = -42.0  # a region the alignment left invalid
    amask = pmask & (aligned > 0)
    kw = dict(width=w, height=h, subsample_factor=2, use_grad_mask=True, use_sfm_density_mask=True)
    jw, jm = jpfd.masks_and_unproject(J(aligned), J(amask), J(c2w), J(K), pix, ok, **kw)
    pw, pm = ppfd.masks_and_unproject(
        t(aligned), torch.as_tensor(amask), t(c2w), t(K), t(pix), torch.as_tensor(np.asarray(ok)), **kw
    )
    np.testing.assert_array_equal(n(pm), np.asarray(jm))
    jw = np.asarray(jw)
    np.testing.assert_allclose(n(pw) / np.abs(jw).max(), jw / np.abs(jw).max(), atol=1e-5)
