"""Parity: small public functions of the JAX package and their port
counterparts, on the same numpy inputs from a seed.

``init_from_points(fixed_scale=...)`` skips the kNN search in both; the
cloud here fits the capacity, so neither draws a subset and every buffer
but the random quaternions is compared. ``color_correct`` takes
``num_iters`` and ``eps`` in both and is compared at each setting. The JAX
package fits it by an SVD in the inputs' precision and the port by a
float64 pseudo-inverse of the normal matrix (float32 outputs agree to 1e-4,
``tests/test_torch_appearance.py``), so here both run in float64, where
the two solves agree to rounding. ``sh0_to_rgb``, ``covariance_3d`` and
``view_directions`` are float32 on both sides.

Tolerance: 1e-6 relative to each output's largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_init_tpu.engine import appearance as ja
from gs_init_tpu.engine import params as jp
from gs_init_tpu.ops import projection as jproj
from gs_init_tpu_torch.engine import appearance as pa
from gs_init_tpu_torch.engine import params as pp
from gs_init_tpu_torch.ops import projection as pproj
from torch_parity import n, t

RTOL = 1e-6


def _init_from_points(fixed_scale, quantile):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(48, 3)).astype(np.float32)
    rgb = rng.uniform(0, 1, (48, 3)).astype(np.float32)
    kw = dict(sh_degree=1, init_opacity=0.3, init_scale=0.5, scale_clamp_quantile=quantile,
              fixed_scale=fixed_scale)
    j = jp.init_from_points(jnp.asarray(pts), jnp.asarray(rgb), 64, **kw)
    p = pp.init_from_points(t(pts), t(rgb), 64, **kw)
    names = ("means", "scales", "opacities", "sh0", "shN")
    got = [n(p.alive)] + [n(getattr(p.params, k)) for k in names]
    want = [np.asarray(j.alive)] + [np.asarray(getattr(j.params, k)) for k in names]
    return got, want


def _color_correct(num_iters, eps):
    rng = np.random.default_rng(1)
    ys, xs = np.mgrid[0:24, 0:32] / 32.0
    ref = np.stack([0.5 + 0.4 * np.sin(3 * xs), 0.5 + 0.4 * np.cos(2 * ys), 0.3 + 0.3 * (xs + ys)], -1)
    ref = np.clip(ref + rng.normal(0, 0.02, ref.shape), 0, 1)
    img = np.clip(0.8 * ref**1.3 + 0.05, 0, 1)
    kw = {} if num_iters is None else dict(num_iters=num_iters, eps=eps)
    with jax.enable_x64(True):
        want = np.asarray(ja.color_correct(jnp.asarray(img), jnp.asarray(ref), **kw))
    got = n(pa.color_correct(torch.as_tensor(img), torch.as_tensor(ref), **kw))
    assert want.dtype == got.dtype == np.float64
    return [got], [want]


def _sh0_to_rgb():
    sh0 = np.random.default_rng(2).normal(size=(40, 1, 3)).astype(np.float32)
    return [n(pp.sh0_to_rgb(t(sh0)))], [np.asarray(jp.sh0_to_rgb(jnp.asarray(sh0)))]


def _covariance_3d():
    rng = np.random.default_rng(3)
    quats = rng.normal(size=(2, 20, 4)).astype(np.float32)
    scales = rng.uniform(0.01, 0.5, (2, 20, 3)).astype(np.float32)
    got = n(pproj.covariance_3d(t(quats), t(scales)))
    want = np.asarray(jproj.covariance_3d(jnp.asarray(quats), jnp.asarray(scales)))
    return [got], [want]


def _view_directions():
    rng = np.random.default_rng(4)
    means = rng.normal(size=(40, 3)).astype(np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    c2w[:, :3, :] = rng.normal(size=(3, 3, 4))
    got = n(pproj.view_directions(t(means), t(c2w)))
    want = np.asarray(jproj.view_directions(jnp.asarray(means), jnp.asarray(c2w)))
    return [got], [want]


CASES = {
    "init_from_points-fixed_scale": lambda: _init_from_points(0.05, 0.0),
    "init_from_points-fixed_scale-clamped": lambda: _init_from_points(0.3, 0.9),
    "color_correct-defaults": lambda: _color_correct(None, None),
    "color_correct-num_iters-eps": lambda: _color_correct(2, 1e-3),
    "sh0_to_rgb": _sh0_to_rgb,
    "covariance_3d": _covariance_3d,
    "view_directions": _view_directions,
}


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax(case):
    got, want = CASES[case]()
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (i, g.shape, w.shape, g.dtype, w.dtype)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=RTOL, err_msg=f"{case}, output {i}")


def test_fixed_scale_skips_the_knn(monkeypatch):
    """Each gaussian's log-scale is log(fixed_scale * init_scale), and the
    kNN search never runs."""
    def boom(*a, **kw):
        raise AssertionError("fixed_scale should skip the kNN search")

    monkeypatch.setattr(pp, "mean_knn_dist", boom)
    pts = torch.as_tensor(np.random.default_rng(5).normal(size=(30, 3)), dtype=torch.float32)
    g = pp.init_from_points(pts, torch.full((30, 3), 0.5), 32, sh_degree=0, init_scale=2.0, fixed_scale=0.25)
    np.testing.assert_array_equal(n(g.params.scales[:30]), np.full((30, 3), np.log(np.float32(0.5)), np.float32))
    assert int(g.alive.sum()) == 30
