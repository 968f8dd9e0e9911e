"""ops/ssim.py's autograd Function: its plain twins against autograd and the
JAX package, and on the card the CUDA pair (K6 ``ssim_fwd``, K7
``ssim_bwd``) against the twins.

The twins' backward runs autograd's backward through the plain ops
operation for operation (the mean's, the formula's, the transposed blur with
its horizontal pass first, the products' and the concatenation's), so the
Function's gradient equals autograd's through the SSIM the port had before
the kernels (``ssim_before`` below) to the bit, in float32 and float64. The
kernels round every operation as the twins do, in their order, so on the
card their maps and gradient equal the twins' (and autograd's) to the bit
and their mean is the twins' within float32 rounding of its sum.

This module imports no JAX at its top, so that the card tests run on a
machine without it: ``python -m pytest -m card tests/test_torch_ssim_kernel.py``.
"""
import numpy as np
import pytest
import torch

from gs_init_tpu_torch import kernels
from gs_init_tpu_torch.ops import ssim as S
from torch_parity import assert_close_scaled

# [B, H, W, C]: garden's 840x1296 at a tenth; odd sides, neither a multiple
# of the kernels' 32-pixel tile; the 11x11 minimum; a batch of two.
SHAPES = [(1, 84, 130, 3), (1, 45, 77, 3), (1, 11, 11, 3), (2, 40, 36, 3)]
# The train cells' images, and the odd shapes again.
CARD_SHAPES = [(1, 840, 1296, 3), (1, 45, 77, 3), (1, 11, 11, 3), (2, 40, 36, 3), (1, 843, 1301, 3)]


def images(shape, seed=0):
    """A smooth textured prediction with a flat patch (where the variance
    terms cancel) and a noisy target, float64 numpy in [0, 1]."""
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([0.5 + 0.3 * np.sin(xx / (5.0 + ch) + b) * np.cos(yy / 7.0) for ch in range(c)], -1)
    a = np.broadcast_to(a, shape).copy() + rng.normal(scale=0.02, size=shape)
    a[:, : h // 2, : w // 3] = 0.5
    target = np.clip(a + rng.normal(scale=0.05, size=shape), 0, 1)
    return np.clip(a, 0, 1), target


def ssim_before(img0, img1, c1=0.01**2, c2=0.03**2, window_size=11, sigma=1.5):
    """The port's SSIM before K6 / K7, verbatim: the autograd reference."""
    w = S._gaussian_window(window_size, sigma)
    b, h, wd, c = img0.shape
    i0 = img0.permute(0, 3, 1, 2)
    i1 = img1.permute(0, 3, 1, 2)
    stacked = torch.cat([i0, i1, i0 * i0, i1 * i1, i0 * i1], dim=1).reshape(b * 5 * c, h, wd)
    blurred = S._blur_valid(stacked, w)
    blurred = blurred.reshape(b, 5, c, *blurred.shape[1:])
    mu0, mu1, e00, e11, e01 = (blurred[:, i] for i in range(5))
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = e00 - mu00
    s11 = e11 - mu11
    s01 = e01 - mu01
    m = ((2 * mu01 + c1) * (2 * s01 + c2)) / ((mu00 + mu11 + c1) * (s00 + s11 + c2))
    return torch.mean(m)


def function_grad(img0, img1, scale=1.7, fn=S.ssim, **kw):
    x = img0.clone().requires_grad_(True)
    value = fn(x, img1, **kw)
    (g,) = torch.autograd.grad(scale * value, x)
    return value.detach(), g


@pytest.mark.parametrize("shape", SHAPES)
def test_twins_match_autograd_and_jax(shape):
    import jax
    import jax.numpy as jnp
    from gs_init_tpu.ops.ssim import ssim as j_ssim

    a, b = images(shape)
    for dtype in (torch.float64, torch.float32):
        x0, x1 = torch.tensor(a, dtype=dtype), torch.tensor(b, dtype=dtype)
        v, g = function_grad(x0, x1)
        rv, rg = function_grad(x0, x1, fn=ssim_before)
        assert torch.equal(v, rv) and torch.equal(g, rg), dtype
    # float32 against jax.grad of the JAX package's ssim.
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    jv, jg = jax.value_and_grad(lambda x: 1.7 * j_ssim(x, jnp.asarray(b32)))(jnp.asarray(a32))
    np.testing.assert_allclose(1.7 * float(v), float(jv), rtol=1e-5)
    assert_close_scaled(g, jg, 1e-5, err_msg="float32, against jax.grad")


def test_other_windows_on_the_cpu():
    """The twins take any window; the kernels only 11 taps."""
    a, b = images((1, 30, 41, 3), seed=2)
    x0, x1 = torch.tensor(a, dtype=torch.float32), torch.tensor(b, dtype=torch.float32)
    for kw in (dict(window_size=7, sigma=1.0), dict(window_size=11, sigma=2.5), dict(c1=1e-3, c2=5e-3)):
        v, g = function_grad(x0, x1, **kw)
        rv, rg = function_grad(x0, x1, fn=ssim_before, **kw)
        assert torch.equal(v, rv) and torch.equal(g, rg), kw


def test_strided_view_of_a_four_channel_render():
    """``render[..., :3]`` of an RGB+depth render: the gradient reaches the
    colour channels as from a contiguous copy, and none the fourth."""
    a, b = images((1, 45, 77, 3), seed=1)
    render = torch.cat([torch.tensor(a, dtype=torch.float32), torch.rand(1, 45, 77, 1)], -1)
    render.requires_grad_(True)
    value = S.ssim(render[..., :3], torch.tensor(b, dtype=torch.float32))
    (g,) = torch.autograd.grad(value, render)
    v, want = function_grad(torch.tensor(a, dtype=torch.float32), torch.tensor(b, dtype=torch.float32), 1.0)
    assert float(value.detach()) == float(v)
    assert torch.equal(g[..., :3], want)
    assert torch.equal(g[..., 3], torch.zeros_like(g[..., 3]))


def test_target_requiring_a_gradient_raises():
    a, b = images((1, 20, 24, 3))
    x, y = torch.tensor(a), torch.tensor(b).requires_grad_(True)
    with pytest.raises(ValueError, match="img1"):
        S.ssim(x.requires_grad_(True), y)
    with pytest.raises(ValueError, match="img1"):
        S.ssim(torch.tensor(a), y)
    with torch.no_grad():  # no gradient asked for: nothing to refuse
        assert float(S.ssim(x, y)) == float(ssim_before(x, y))


def test_value_without_a_gradient_is_the_plain_value():
    a, b = images((2, 40, 36, 3))
    x, y = torch.tensor(a, dtype=torch.float32), torch.tensor(b, dtype=torch.float32)
    assert S.ssim_fwd_plain(x, y, 1e-4, 9e-4, S._gaussian_window(), False)[1] is None
    with torch.no_grad():
        assert torch.equal(S.ssim(x.requires_grad_(True), y), ssim_before(x, y))
    assert torch.equal(S.ssim(x.detach(), y), ssim_before(x.detach(), y))


def test_kernel_path_checks_its_inputs():
    """The CUDA wrappers refuse what K6 / K7 do not take, before any launch."""
    x = torch.zeros(1, 16, 16, 3)
    w = S._gaussian_window()
    with pytest.raises(ValueError, match="CUDA device"):
        S._check_images(x, x, w)
    with pytest.raises(ValueError, match="11-tap"):
        S._check_images(x, x, S._gaussian_window(7))
    with pytest.raises(ValueError, match="H, W >= 11"):
        S._check_images(x[:, :10], x[:, :10], w)
    with pytest.raises(ValueError, match="one shape"):
        S._check_images(x, x[..., :2], w)


# ------------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K6 and K7 are CUDA kernels with no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernels_match_twins_on_the_card(shape):
    """K6's value and maps and K7's gradient against the twins on the card:
    the maps and gradient to the bit (and the gradient to autograd's through
    the plain ops), the mean within its sum's rounding; the same bits over two
    calls; one launch of each a call."""
    dev = _card()
    a, b = images(shape)
    x0 = torch.tensor(a, dtype=torch.float32, device=dev)
    x1 = torch.tensor(b, dtype=torch.float32, device=dev)
    w = S._gaussian_window()
    c1, c2 = 0.01**2, 0.03**2
    want_v, want_m = S.ssim_fwd_plain(x0, x1, c1, c2, w, True)
    got_v, got_m = S.ssim_fwd(x0, x1, c1, c2, w, True)
    assert torch.equal(got_m, want_m), f"maps {float((got_m - want_m).abs().max()):.3e} off"
    assert abs(float(got_v) - float(want_v)) <= 1e-6 * abs(float(want_v))
    grad = torch.tensor(1.7, device=dev)
    want_g = S.ssim_bwd_plain(grad, x0, x1, want_m, c1, c2, w)
    got_g = S.ssim_bwd(grad, x0, x1, got_m, c1, c2, w)
    assert torch.equal(got_g, want_g), f"gradient {float((got_g - want_g).abs().max()):.3e} off"

    l0 = dict(kernels.LAUNCHES)
    v1, g1 = function_grad(x0, x1)
    v2, g2 = function_grad(x0, x1)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - l0[k] for k in ("ssim_fwd", "ssim_bwd")} == {"ssim_fwd": 2, "ssim_bwd": 2}
    assert torch.equal(v1, v2) and torch.equal(g1, g2)
    assert torch.equal(v1, got_v) and torch.equal(g1, want_g)
    _, auto_g = function_grad(x0, x1, fn=ssim_before)
    assert torch.equal(g1, auto_g), f"gradient {float((g1 - auto_g).abs().max()):.3e} off autograd's"


@pytest.mark.card
def test_strided_render_on_the_card():
    """``render[..., :3]`` of a 4-channel render at the train cells' shape:
    K6 / K7 read the view where it lies, as from a contiguous copy."""
    dev = _card()
    a, b = images((1, 840, 1296, 3), seed=2)
    render = torch.cat([torch.tensor(a, dtype=torch.float32), torch.rand(1, 840, 1296, 1)], -1).to(dev)
    x1 = torch.tensor(b, dtype=torch.float32, device=dev)
    render.requires_grad_(True)
    value = S.ssim(render[..., :3], x1)
    (g,) = torch.autograd.grad(value, render)
    v, want = function_grad(render.detach()[..., :3].contiguous(), x1, 1.0)
    assert torch.equal(value.detach(), v)
    assert torch.equal(g[..., :3], want) and not g[..., 3].any()


@pytest.mark.card
def test_eval_path_writes_no_maps_on_the_card():
    """Without a gradient K6 runs once and allocates no map: the call's
    peak memory stays under the bytes of one [B, C, Ho, Wo] map."""
    dev = _card()
    a, b = images((1, 840, 1296, 3))
    x0 = torch.tensor(a, dtype=torch.float32, device=dev).requires_grad_(True)
    x1 = torch.tensor(b, dtype=torch.float32, device=dev)
    map_bytes = 3 * 830 * 1286 * 4
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    l0 = dict(kernels.LAUNCHES)
    with torch.no_grad():
        value = S.ssim(x0, x1)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) - base < map_bytes
    assert {k: kernels.LAUNCHES[k] - l0[k] for k in ("ssim_fwd", "ssim_bwd")} == {"ssim_fwd": 1, "ssim_bwd": 0}
    want, _ = S.ssim_fwd_plain(x0.detach(), x1, 0.01**2, 0.03**2, S._gaussian_window(), False)
    assert abs(float(value) - float(want)) <= 1e-6 * abs(float(want))
