"""The port's SIFT descriptor prep (``mdi/descriptors.py``) against the JAX
package's on the same numpy inputs: grayscale, border gate, patch gather,
descriptors with and without RootSIFT, and the end-to-end prep.

Tolerance: descriptors within 1e-6 absolute (unit-norm 128-vectors; the
einsum and the norms sum in other orders; 3.0e-8 measured); the gather,
gate and grayscale exactly or to f32 rounding (1e-7)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_init_tpu.mdi import descriptors as J
from gs_init_tpu_torch.mdi import descriptors as P
from torch_parity import n, t

torch.set_num_threads(2)


@pytest.mark.parametrize("rootsift", [True, False])
def test_sift_matches_jax(rootsift):
    patches = np.random.default_rng(0).uniform(0, 1, (7, 32, 32)).astype(np.float32)
    want = np.asarray(J.sift_descriptors(jnp.asarray(patches), rootsift=rootsift))
    got = n(P.sift_descriptors(t(patches), rootsift=rootsift))
    assert got.shape == (7, 128)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_patches_border_and_gray_match_jax():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (40, 48, 3)).astype(np.float32)
    np.testing.assert_allclose(n(P.rgb_to_grayscale(t(img))), np.asarray(J.rgb_to_grayscale(jnp.asarray(img))),
                               atol=1e-7)
    gray = img[..., 0]
    # Centres near and at the edges: starts as jax.lax.dynamic_slice takes
    # them (a negative one counts from the end, then clamped).
    yx = np.array([[20, 24], [16, 17], [2, 45], [39, 0]])
    want = np.asarray(J.extract_patches(jnp.asarray(gray), jnp.asarray(yx), 32))
    np.testing.assert_array_equal(n(P.extract_patches(t(gray), torch.as_tensor(yx), 32)), want)
    for h, w, b in ((40, 48, 16), (30, 30, 16), (64, 48, 8)):
        np.testing.assert_array_equal(P.border_mask(h, w, b), J.border_mask(h, w, b))


def test_prepare_descriptors_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    mask = rng.uniform(size=48 * 64) < 0.05
    d_want, g_want = J.prepare_descriptors(img, mask)
    d_got, g_got = P.prepare_descriptors(img, mask)
    np.testing.assert_array_equal(g_got, g_want)
    assert d_got.shape == d_want.shape and d_got.dtype == np.float32 and len(d_got) > 0
    np.testing.assert_allclose(d_got, d_want, atol=1e-6)
    d_t, g_t = P.prepare_descriptors(t(img), torch.as_tensor(mask))  # tensors in, numpy out
    np.testing.assert_array_equal(d_t, d_got)
    empty, gated = P.prepare_descriptors(img, np.zeros(48 * 64, bool))
    assert empty.shape == (0, 128) and not gated.any()
