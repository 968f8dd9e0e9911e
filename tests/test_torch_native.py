"""Parity: the port's native bindings (``gs_init_tpu_torch/native.py``)
against the JAX package's (``gs_init_tpu/native/subsampling.py``); both
build the same ``native/subsampling.cpp``.

- ``compute_min_extents`` on the inputs of
  ``tests/test_native.py::test_min_extents_matches_jax``, against JAX's
  binding and against the port's ``mdi/postprocess``
  ``compute_minimal_gaussian_extents``: rtol 1e-5, -1 behind the camera;
- ``subsample_pointcloud`` with each ``split_strategy``: the same points,
  colours and count as JAX's (one C function, so equal to the bit).
"""
import numpy as np
import pytest
import torch

from gs_init_tpu.native import subsampling as jnative
from gs_init_tpu_torch import native
from gs_init_tpu_torch.mdi.postprocess import compute_minimal_gaussian_extents

torch.set_num_threads(2)  # tier-1 runs several pytest workers per box


def _cameras():
    vm = np.eye(4, dtype=np.float32)[None]
    K = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]], np.float32)[None]
    return vm, K, [64], [48]


def test_compute_min_extents_matches_jax(rng):
    pts = np.stack(
        [rng.uniform(-0.2, 0.2, 500), rng.uniform(-0.15, 0.15, 500), rng.uniform(1, 5, 500)], -1,
    ).astype(np.float32)
    pts[:20, 2] = -3.0  # behind the camera: seen by none
    vm, K, w, h = _cameras()
    got = native.compute_min_extents(pts, vm, K, w, h)
    assert got.dtype == np.float32 and got.shape == (500,)
    np.testing.assert_allclose(got, jnative.compute_min_extents(pts, vm, K, w, h), rtol=1e-5)
    np.testing.assert_allclose(got, compute_minimal_gaussian_extents(pts, vm, K, w, h, device="cpu"), rtol=1e-5)
    assert (got[:20] == -1).all()
    np.testing.assert_allclose(got[20:], 2 * pts[20:, 2] / 100.0, rtol=1e-5)


def test_compute_min_extents_over_several_cameras(rng):
    """Many cameras (each point's minimum over those that see it) and more
    points than the C function's threaded split (4,096): against both."""
    n, c = 6000, 5
    pts = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    vms, Ks = [], []
    for i in range(c):
        a = 2 * np.pi * i / c
        eye = np.array([4 * np.cos(a), 0.3 * i, 4 * np.sin(a)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd])
        vm = np.eye(4)
        vm[:3, :3], vm[:3, 3] = R, -R @ eye
        vms.append(vm)
        f = 80.0 + 10 * i
        Ks.append([[f, 0, 40], [0, f + 5, 30], [0, 0, 1]])
    vms, Ks = np.asarray(vms, np.float32), np.asarray(Ks, np.float32)
    w, h = [80] * c, [60] * c
    got = native.compute_min_extents(pts, vms, Ks, w, h)
    np.testing.assert_allclose(got, jnative.compute_min_extents(pts, vms, Ks, w, h), rtol=1e-5)
    np.testing.assert_allclose(got, compute_minimal_gaussian_extents(pts, vms, Ks, w, h, device="cpu"), rtol=1e-5)
    assert 0 < (got == -1).sum() < n  # some points no camera sees, most seen


@pytest.mark.parametrize("strategy", ["spatial_median", "equal_num_pts", "max_gap"])
def test_subsample_pointcloud_matches_jax(strategy):
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal(0, 0.05, (300, 3)), rng.normal(2, 0.05, (200, 3)),
                          rng.uniform(-3, 3, (100, 3))]).astype(np.float32)
    rgbs = rng.uniform(0, 1, (600, 3)).astype(np.float32)
    ext = rng.uniform(0.05, 0.3, 600).astype(np.float32)
    p, c = native.subsample_pointcloud(pts, rgbs, ext, 1.1, 2.0, split_strategy=strategy)
    jp, jc = jnative.subsample_pointcloud(pts, rgbs, ext, 1.1, 2.0, split_strategy=strategy)
    assert 0 < len(p) < len(pts)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(c, jc)
    if strategy == "spatial_median":  # the default, as every existing caller has it
        dp, dc = native.subsample_pointcloud(pts, rgbs, ext, 1.1, 2.0)
        np.testing.assert_array_equal(dp, p)
        np.testing.assert_array_equal(dc, c)


def test_subsample_pointcloud_refuses_an_unknown_strategy():
    z = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError, match="split_strategy"):
        native.subsample_pointcloud(z, z, np.ones(4, np.float32), split_strategy="median")
