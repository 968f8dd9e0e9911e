"""The port's separable filters (``utils/image_filtering.py``) against the
JAX package's on the same numpy images: Gaussian blur at several sigmas,
box blur, and the Gaussian-derivative gradients. Tolerance 1e-6 absolute
on images in [0, 1] (the same f32 taps summed in another order; 1.2e-7
measured)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_init_tpu.utils import image_filtering as J
from gs_init_tpu_torch.utils import image_filtering as P
from torch_parity import n, t

torch.set_num_threads(2)

IMG = np.random.default_rng(0).uniform(0, 1, (37, 52)).astype(np.float32)


@pytest.mark.parametrize("sigma", [0.3, 1.0, 2.5])
def test_gaussian_filter_matches_jax(sigma):
    want = np.asarray(J.gaussian_filter2d(jnp.asarray(IMG), sigma))
    np.testing.assert_allclose(n(P.gaussian_filter2d(t(IMG), sigma)), want, atol=1e-6)


@pytest.mark.parametrize("size", [3, 7])
def test_box_blur_matches_jax(size):
    want = np.asarray(J.box_blur2d(jnp.asarray(IMG), size))
    np.testing.assert_allclose(n(P.box_blur2d(t(IMG), size)), want, atol=1e-6)


@pytest.mark.parametrize("sigma", [1.0, 2.0])
def test_spatial_gradient_matches_jax(sigma):
    want = [np.asarray(x) for x in J.spatial_gradient_first_order(jnp.asarray(IMG), sigma)]
    got = [n(x) for x in P.spatial_gradient_first_order(t(IMG), sigma)]
    for g, w in zip(got, want):
        assert g.shape == IMG.shape
        np.testing.assert_allclose(g, w, atol=1e-6)
