"""Parity: the port's projection and SH colours against the JAX package,
values and gradients (torch.autograd against jax.grad).

Tolerances: f32 values within 1e-5 relative (2e-4 absolute for pixel
coordinates of ~100 px); gradients within 1e-4 of their max magnitude.
Integer radii and extents must match exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_init_tpu.ops.projection import project_gaussians as j_project
from gs_init_tpu.ops.projection import quat_to_rotmat as j_quat_to_rotmat
from gs_init_tpu.ops.sh import sh_to_color as j_sh_to_color
from gs_init_tpu_torch.ops.projection import project_gaussians, quat_to_rotmat
from gs_init_tpu_torch.ops.sh import num_sh_bases, sh_to_color
from torch_parity import H, W, assert_close_scaled, n, scene, t

KEYS = ("means", "quats", "scales", "opacities")


def _weights(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize(
    "camera_model,antialiased",
    [("pinhole", False), ("pinhole", True), ("ortho", False), ("fisheye", False)],
)
def test_projection_values_and_grads(rng, camera_model, antialiased):
    sc = scene(rng, n_g=32)
    if camera_model == "ortho":
        sc["Ks"] = sc["Ks"].copy()
        sc["Ks"][0, 0, 0] = sc["Ks"][0, 1, 1] = 40.0  # pixels per world unit
    kw = dict(antialiased=antialiased, camera_model=camera_model, radius_clip=0.5)
    # A random linear functional of the differentiable outputs.
    w = {k: _weights(rng, s) for k, s in (("m", (1, 32, 2)), ("c", (1, 32, 3)), ("d", (1, 32)), ("o", (1, 32)))}

    def j_fn(*leaves):
        p = j_project(*leaves, jnp.asarray(sc["viewmats"]), jnp.asarray(sc["Ks"]), W, H, **kw)
        s = (p.means2d * w["m"]).sum() + (p.conics * w["c"]).sum()
        return s + (p.depths * w["d"]).sum() + (p.opacities * w["o"]).sum(), p

    (_, jp), jg = jax.value_and_grad(j_fn, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(sc[k]) for k in KEYS)
    )
    leaves = [t(sc[k]).requires_grad_(True) for k in KEYS]
    pp = project_gaussians(*leaves, t(sc["viewmats"]), t(sc["Ks"]), W, H, **kw)
    s = (pp.means2d * t(w["m"])).sum() + (pp.conics * t(w["c"])).sum()
    s = s + (pp.depths * t(w["d"])).sum() + (pp.opacities * t(w["o"])).sum()
    pg = torch.autograd.grad(s, leaves)

    np.testing.assert_array_equal(n(pp.radii), n(jp.radii))
    np.testing.assert_array_equal(n(pp.extents), n(jp.extents))
    assert (n(pp.radii) > 0).sum() > 8  # the scene is mostly visible
    np.testing.assert_allclose(n(pp.means2d), n(jp.means2d), rtol=1e-5, atol=2e-4)
    np.testing.assert_allclose(n(pp.conics), n(jp.conics), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(n(pp.depths), n(jp.depths), rtol=1e-6)
    np.testing.assert_allclose(n(pp.opacities), n(jp.opacities), rtol=1e-5)
    for name, a, b in zip(KEYS, pg, jg):
        assert_close_scaled(a, b, 1e-4, err_msg=name)


def test_quat_to_rotmat(rng):
    q = rng.normal(size=(16, 4)).astype(np.float32)
    np.testing.assert_allclose(
        n(quat_to_rotmat(t(q))), n(j_quat_to_rotmat(jnp.asarray(q))), atol=1e-6
    )


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_values_and_grads(rng, degree):
    k = num_sh_bases(degree)
    coeffs = rng.normal(size=(24, 16, 3)).astype(np.float32) * 0.4
    dirs = rng.normal(size=(24, 3)).astype(np.float32)
    mask = np.ones((k,), np.float32)
    mask[(k + 1) // 2 :] = 0.0  # a partial degree schedule
    w = _weights(rng, (24, 3))

    def j_fn(c, d):
        return (j_sh_to_color(c, d, degree, basis_mask=jnp.asarray(mask)) * w).sum()

    jv = j_sh_to_color(jnp.asarray(coeffs), jnp.asarray(dirs), degree, basis_mask=jnp.asarray(mask))
    jg = jax.grad(j_fn, argnums=(0, 1))(jnp.asarray(coeffs), jnp.asarray(dirs))
    c, d = t(coeffs).requires_grad_(True), t(dirs).requires_grad_(True)
    pv = sh_to_color(c, d, degree, basis_mask=t(mask))
    pg = torch.autograd.grad((pv * t(w)).sum(), (c, d), allow_unused=True)
    pg = [torch.zeros_like(x) if g is None else g for g, x in zip(pg, (c, d))]
    np.testing.assert_allclose(n(pv), n(jv), rtol=1e-5, atol=1e-6)
    for name, a, b in zip(("coeffs", "dirs"), pg, jg):
        assert_close_scaled(a, b, 1e-5, err_msg=name)


@pytest.mark.parametrize("antialiased", [False, True])
def test_gaussian_on_the_camera_plane_has_finite_gradients(rng, antialiased):
    """A gaussian whose camera-space depth is exactly 0 (one of a 10^6-point
    init cloud over 161 cameras was) is culled, and its parameters get zero
    gradients through the render, not NaN: the JAX projection's arithmetic
    at that depth gives NaN (1/tz = inf, then inf - inf), which Adam then
    writes into the gaussian's mean, quaternion and scales."""
    from gs_init_tpu_torch.ops.render import rasterize

    sc = scene(rng, n_g=24)
    sc["means"][0] = [0.1, -0.2, 0.0]  # tz == 0 under the identity camera
    sc["means"][1] = [0.1, -0.2, 0.004]  # in front, before the near plane
    leaves = [t(sc[k]).requires_grad_(True) for k in KEYS]
    colors = t(sc["colors"]).requires_grad_(True)
    out, alpha, _ = rasterize(*leaves, colors, t(sc["viewmats"]), t(sc["Ks"]), W, H, tile_size=16,
                              rasterize_mode="antialiased" if antialiased else "classic")
    grads = torch.autograd.grad((out * t(_weights(rng, tuple(out.shape)))).sum() + alpha.sum(), leaves + [colors])
    for name, g in zip(KEYS + ("colors",), grads):
        assert torch.isfinite(g).all(), name
        assert (g[:2] == 0).all(), name
    assert (grads[0][2:] != 0).any()
