"""Parity: the port's ``rasterize`` against the JAX one (Pallas compositor in
interpret mode, f32 wire) with backgrounds, masks, RGB+ED, the
``means2d_dummy`` and ``pair_dummy`` gradient taps and the SH degree mask;
the forward also against the JAX dense oracle (``impl="xla"``). Then SSIM
and PSNR values and gradients.

Tolerances: renders within 1e-5 of the Pallas path (f32 rounding of two
summation orders) and within 5e-4 of the dense oracle (it composites past
the termination point, as tests/test_rasterize_pallas.py allows); gradients
within 1e-4 of their max magnitude; SSIM/PSNR within f32 rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_init_tpu.ops.render import rasterize as j_rasterize
from gs_init_tpu.ops.ssim import psnr as j_psnr, ssim as j_ssim
from gs_init_tpu_torch.ops.render import rasterize
from gs_init_tpu_torch.ops.ssim import psnr, ssim
from torch_parity import H, W, assert_close_scaled, n, scene, t

KW = dict(tile_size=16, pair_capacity=8192, chunk_size=128)
JKW = dict(KW, impl="pallas", wire8=False, sort_bf16=False)
KEYS = ("means", "quats", "scales", "opacities", "colors")


def test_rasterize_taps_backgrounds_masks(rng):
    sc = scene(rng, n_g=40)
    c = 1
    bg = np.array([[0.2, 0.3, 0.4]], np.float32)
    mask = (rng.uniform(size=(c, H, W)) > 0.2)
    target = rng.uniform(size=(c, H, W, 4)).astype(np.float32)
    kw = dict(render_mode="RGB+ED", backgrounds=jnp.asarray(bg), masks=jnp.asarray(mask))

    def j_loss(m, q, s, o, col, dummy, pd, impl_kw):
        render, alpha, _ = j_rasterize(
            m, q, s, o, col, jnp.asarray(sc["viewmats"]), jnp.asarray(sc["Ks"]), W, H,
            means2d_dummy=dummy, pair_dummy=pd,
            **kw, **impl_kw,
        )
        return jnp.mean((render - target) ** 2) + 0.1 * jnp.mean(alpha), (render, alpha)

    jin = [jnp.asarray(sc[k]) for k in KEYS]
    jin += [jnp.zeros((c, 40, 2)), jnp.zeros((c * 40, 2))]
    (jl, (jr, ja)), jg = jax.value_and_grad(
        lambda *a: j_loss(*a, JKW), argnums=tuple(range(7)), has_aux=True
    )(*jin)

    pin = [t(sc[k]).requires_grad_(True) for k in KEYS]
    pin += [torch.zeros((c, 40, 2), requires_grad=True), torch.zeros((c * 40, 2), requires_grad=True)]
    pr, pa, info = rasterize(
        *pin[:5], t(sc["viewmats"]), t(sc["Ks"]), W, H, means2d_dummy=pin[5], pair_dummy=pin[6],
        render_mode="RGB+ED", backgrounds=t(bg), masks=torch.as_tensor(mask), **KW,
    )
    pl = torch.mean((pr - t(target)) ** 2) + 0.1 * torch.mean(pa)
    pg = torch.autograd.grad(pl, pin)

    assert int(info.overflow) == 0
    np.testing.assert_allclose(n(pa), n(ja), atol=1e-5)
    np.testing.assert_allclose(n(pr)[..., :3], n(jr)[..., :3], atol=1e-5)
    sig = n(ja)[..., 0] > 1e-2  # expected depth is only defined where alpha is
    np.testing.assert_allclose(n(pr)[..., 3][sig], n(jr)[..., 3][sig], rtol=1e-4)
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-5)
    names = list(KEYS) + ["means2d_dummy", "absgrad"]
    for name, a, b in zip(names, pg, jg):
        assert float(np.abs(n(b)).max()) > 0, name
        assert_close_scaled(a, b, 1e-4, err_msg=name)

    # The dense JAX oracle agrees on the forward (it has no termination).
    jr_ref, ja_ref, _ = j_rasterize(
        *jin[:5], jnp.asarray(sc["viewmats"]), jnp.asarray(sc["Ks"]), W, H,
        impl="xla", **kw,
    )
    np.testing.assert_allclose(n(pa), n(ja_ref), atol=2e-4)
    np.testing.assert_allclose(n(pr)[..., :3], n(jr_ref)[..., :3], atol=5e-4)


def test_rasterize_sh_mask(rng):
    sc = scene(rng, n_g=24)
    sh = (rng.normal(size=(24, 16, 3)) * 0.3).astype(np.float32)
    sh_mask = np.array([1.0] * 4 + [0.0] * 12, np.float32)  # degree 1 active
    jr, _, _ = j_rasterize(
        *(jnp.asarray(sc[k]) for k in KEYS[:4]), jnp.asarray(sh),
        jnp.asarray(sc["viewmats"]), jnp.asarray(sc["Ks"]), W, H,
        sh_degree=3, sh_mask=jnp.asarray(sh_mask), **JKW,
    )
    pr, _, _ = rasterize(
        *(t(sc[k]) for k in KEYS[:4]), t(sh), t(sc["viewmats"]), t(sc["Ks"]), W, H,
        sh_degree=3, sh_mask=t(sh_mask), **KW,
    )
    np.testing.assert_allclose(n(pr), n(jr), atol=1e-5)


def test_rasterize_raises_on_dense_oracle(rng):
    """The dense oracle is ported: ``impl="xla"`` renders what the tile
    compositor renders on a sparse scene (no tile stops early, so within
    f32 rounding), with no binning; an unknown impl raises."""
    sc = scene(rng, n_g=4)
    args = [t(sc[k]) for k in KEYS] + [t(sc["viewmats"]), t(sc["Ks"]), W, H]
    ref, ref_alpha, info = rasterize(*args, impl="xla", **KW)
    tiled, tiled_alpha, _ = rasterize(*args, impl="pallas", **KW)
    assert info.binning is None and int(info.overflow) == 0 and float(ref_alpha.max()) > 0.1
    np.testing.assert_allclose(n(ref), n(tiled), atol=1e-5)
    np.testing.assert_allclose(n(ref_alpha), n(tiled_alpha), atol=1e-5)
    with pytest.raises(ValueError, match="unknown rasterizer impl"):
        rasterize(*args, impl="dense", **KW)


def test_ssim_psnr_values_and_grads(rng):
    # Flat regions included: the variance terms must not cancel.
    a = rng.uniform(size=(2, 40, 36, 3)).astype(np.float32)
    a[:, :20, :18] = 0.5
    b = np.clip(a + rng.normal(scale=0.05, size=a.shape), 0, 1).astype(np.float32)
    js, jg = jax.value_and_grad(j_ssim)(jnp.asarray(a), jnp.asarray(b))
    ta = t(a).requires_grad_(True)
    ps = ssim(ta, t(b))
    (pg,) = torch.autograd.grad(ps, ta)
    np.testing.assert_allclose(float(ps.detach()), float(js), rtol=1e-5)
    assert_close_scaled(pg, jg, 1e-4, err_msg="dssim")
    np.testing.assert_allclose(
        float(psnr(t(a), t(b))), float(j_psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5
    )
