"""Parity: the port's tile compositor (plain PyTorch versions of the CUDA
kernels) against the JAX Pallas compositor in interpret mode.

Both sides get the same projected gaussians (the JAX projection, as numpy);
each bins and packs them itself, then composites. Forward rows 0-5 must
agree to f32 rounding of two summation orders (atol 2e-6), row 6 (chunks
processed) exactly; backward dtable and absgrad within 2e-5 of their max
magnitude (the JAX side reduces gradient records by a sort and a cumsum
difference, the port by index_add, so the sums round differently).
The scan probe's plain version is held against the JAX probe kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_init_tpu.ops.projection import project_gaussians as j_project
from gs_init_tpu.ops.rasterize import render_tiles as j_render_tiles
from gs_init_tpu.ops.sh import sh_to_color as j_sh_to_color
from gs_init_tpu.ops.tiles import bin_gaussians as j_bin, pack_table as j_pack
from gs_init_tpu_torch.ops import rasterize as prast
from gs_init_tpu_torch.ops.project_pack import pack_table
from gs_init_tpu_torch.ops.tiles import bin_gaussians
from torch_parity import H, W, assert_close_scaled, deep_stack, n, scene, t

TILE, CHUNK, CAP = 16, 128, 8192


def _case(rng, kind):
    sc = deep_stack(rng) if kind == "deep" else scene(rng)
    proj = j_project(
        *(jnp.asarray(sc[k]) for k in ("means", "quats", "scales", "opacities", "viewmats", "Ks")),
        W, H, antialiased=(kind == "antialiased"),
    )
    if kind == "SH":
        sh = rng.normal(size=(sc["means"].shape[0], 16, 3)).astype(np.float32) * 0.3
        dirs = jnp.asarray(sc["means"])[None] - 0.0  # identity camera at the origin
        colors = j_sh_to_color(jnp.asarray(sh)[None], dirs, 3)
    else:
        colors = jnp.asarray(sc["colors"])[None]
    return proj, colors


def _jax_side(proj, colors, want_depth, g_out):
    b = j_bin(proj.means2d, proj.radii, proj.depths, W, H, TILE, CAP, chunk=CHUNK,
              extents=proj.extents)
    table = j_pack(proj.means2d, proj.conics, proj.opacities, colors, proj.depths)
    num_tiles = b.num_tiles_x * b.num_tiles_y
    pair_dummy = jnp.zeros((table.shape[0], 2), jnp.float32)

    def f(tbl, pd):
        return j_render_tiles(
            tbl, pd, b.gid_sorted, b.row_order, b.tile_starts, b.out_starts,
            b.gauss_offsets, b.gauss_counts, num_tiles, b.num_tiles_x, b.num_tiles_y,
            TILE, CHUNK, want_depth, True, False, False,
        )

    out, vjp = jax.vjp(f, table, pair_dummy)
    dtable, dpair = vjp(jnp.asarray(g_out))
    return b, table, out, dtable, dpair


def _port_binning(proj, colors):
    b = bin_gaussians(
        t(proj.means2d), t(proj.radii, torch.int32), t(proj.depths), W, H, TILE, CAP,
        chunk=CHUNK, extents=t(proj.extents, torch.int32),
    )
    table = pack_table(t(proj.means2d), t(proj.conics), t(proj.opacities), t(colors), t(proj.depths))
    return b, table


def _g_out(rng, num_tiles, want_depth):
    g = rng.normal(size=(num_tiles, 8, TILE * TILE)).astype(np.float32)
    g[:, 6:] = 0.0  # chunk count and spare rows carry no gradient
    if not want_depth:
        g[:, prast.ROW_DEPTH] = 0.0
    return g


@pytest.mark.parametrize("kind", ["RGB", "RGB+ED", "antialiased", "SH", "deep"])
def test_compositor_matches_pallas(rng, kind):
    proj, colors = _case(rng, kind)
    want_depth = kind in ("RGB+ED", "deep")
    pb, ptable = _port_binning(proj, colors)
    num_tiles = pb.num_tiles_x * pb.num_tiles_y
    g_out = _g_out(rng, num_tiles, want_depth)
    jb, jtable, jout, jdtable, jdpair = _jax_side(proj, colors, want_depth, g_out)

    # Same table (conic diagonal pre-halved) and the same pairs per tile.
    np.testing.assert_array_equal(n(ptable)[:, :10], n(jtable)[:, :10])
    starts = n(pb.tile_starts)
    np.testing.assert_array_equal(starts, n(jb.tile_starts))
    assert int(pb.overflow) == int(jb.overflow) == 0
    gp, gj = n(pb.gid_sorted), n(jb.gid_sorted)
    for k in range(num_tiles):
        seg = slice(starts[k], starts[k + 1])
        assert sorted(gp[seg]) == sorted(gj[seg]), k

    out = prast.composite_fwd(
        ptable, pb.gid_sorted, pb.tile_starts, num_tiles, pb.num_tiles_x, pb.num_tiles_y, TILE, CHUNK
    )
    np.testing.assert_allclose(n(out)[:, :6], n(jout)[:, :6], atol=2e-6, rtol=0)
    np.testing.assert_array_equal(n(out)[:, 6], n(jout)[:, 6])
    if kind == "deep":
        # The replay must actually skip chunks: some tile stopped early.
        _, _, c0, nchunks = prast._chunk_windows(pb.tile_starts, CHUNK)
        assert (n(out)[:, 6, 0] < n(nchunks)).any()

    dtable, absgrad = prast.composite_bwd(
        ptable, pb.gid_sorted, pb.tile_starts, out, t(g_out), num_tiles,
        pb.num_tiles_x, pb.num_tiles_y, TILE, CHUNK, True,
    )
    if not want_depth:
        dtable[:, prast.PACK_DEPTH] = 0.0
    for c, name in enumerate(["mx", "my", "ca", "cb", "cc", "opa", "r", "g", "b", "depth"]):
        assert_close_scaled(dtable[:, c], n(jdtable)[:, c], 2e-5, err_msg=name)
    assert_close_scaled(absgrad, jdpair, 2e-5, err_msg="absgrad")


def test_plain_backward_equals_autograd(rng):
    """The explicit front-to-back replay equals autograd through the plain
    forward (which differentiates the same chunk walk), on a scene whose
    tiles terminate early."""
    sc = deep_stack(rng)
    proj = j_project(
        *(jnp.asarray(sc[k]) for k in ("means", "quats", "scales", "opacities", "viewmats", "Ks")),
        W, H,
    )
    b, table = _port_binning(proj, jnp.asarray(sc["colors"])[None])
    num_tiles = b.num_tiles_x * b.num_tiles_y
    g_out = t(_g_out(rng, num_tiles, True))
    args = (b.gid_sorted, b.tile_starts, num_tiles, b.num_tiles_x, b.num_tiles_y, TILE, CHUNK)
    tbl = table.double().requires_grad_(True)
    out = prast.composite_fwd_plain(tbl, *args)
    (want,) = torch.autograd.grad((out * g_out.double()).sum(), tbl)
    got, _ = prast.composite_bwd_plain(
        table.double(), b.gid_sorted, b.tile_starts, out.detach(), g_out.double(),
        num_tiles, b.num_tiles_x, b.num_tiles_y, TILE, CHUNK,
    )
    for c in range(10):
        assert_close_scaled(got[:, c], want[:, c], 1e-9, err_msg=f"column {c}")


def test_cpu_tensors_take_the_plain_path():
    """On CPU tensors the wrappers take the plain versions and never count
    a kernel launch."""
    from gs_init_tpu_torch import kernels

    kernels.reset_launch_counts()
    table = torch.zeros((4, 16))
    gid = torch.zeros((128,), dtype=torch.int32)
    starts = torch.zeros((2,), dtype=torch.int32)
    out = prast.composite_fwd(table, gid, starts, 1, 1, 1, TILE, CHUNK)
    assert out.shape == (1, 8, TILE * TILE)
    assert float(out[0, prast.ROW_T].min()) == 1.0
    prast.check_scan("cpu")
    from gs_init_tpu_torch.ops.project_pack import project_pack

    eye = torch.eye(4)[None]
    K = torch.tensor([[[10.0, 0.0, 2.0], [0.0, 10.0, 2.0], [0.0, 0.0, 1.0]]])
    means = torch.tensor([[0.0, 0.0, 2.0]])
    table, radii, _, _ = project_pack(means, torch.tensor([[1.0, 0.0, 0.0, 0.0]]), torch.full((1, 3), 0.1),
                                      torch.tensor([0.9]), torch.zeros((1, 1, 3)), eye, K, 4, 4, sh_degree=0)
    assert table.shape == (1, 16) and int(radii[0, 0]) > 0
    from gs_init_tpu_torch.ops.ssim import ssim

    img = torch.rand((1, 12, 13, 3), requires_grad=True)
    torch.autograd.grad(ssim(img, torch.rand((1, 12, 13, 3))), img)
    assert kernels.LAUNCHES == {
        "composite_fwd": 0, "composite_bwd": 0, "scan_probe": 0, "project_pack_fwd": 0, "project_pack_bwd": 0,
        "ssim_fwd": 0, "ssim_bwd": 0,
    }


def _jax_probe(x, m):
    """The JAX package's scan probe kernel (rasterize.py _PROBE_SRC), run by
    pallas_call in interpret mode."""
    from jax.experimental import pallas as pl
    from gs_init_tpu.ops.rasterize import _hs_scan

    def k(x_ref, m_ref, o_ref, p_ref):
        o_ref[...] = _hs_scan(x_ref[...], reverse=False, exclusive=True)
        p_ref[...] = _hs_scan(m_ref[...], exclusive=True, mul=True)

    shape = jax.ShapeDtypeStruct(x.shape, jnp.float32)
    return pl.pallas_call(k, out_shape=[shape, shape], interpret=True)(
        jnp.asarray(x), jnp.asarray(m)
    )


@pytest.mark.parametrize("kind", ["probe", "random"])
def test_scan_probe_matches_pallas(rng, kind):
    """The scan probe's plain version against the JAX probe kernel: the
    sum within 1e-5 of its max magnitude, the product within 1e-5 relative
    per element (a tree and a sequential order each round up to n-1 times)."""
    if kind == "probe":
        x, m = (n(a) for a in prast.scan_probe_inputs("cpu"))
    else:
        x = rng.normal(size=(96, 40)).astype(np.float32)
        m = rng.uniform(0.5, 1.0, (96, 40)).astype(np.float32)
    js, jq = _jax_probe(x, m)
    s, q = prast.scan_probe(t(x), t(m))
    assert s.shape == q.shape == x.shape
    assert_close_scaled(s, js, 1e-5, err_msg="prefix sum")
    np.testing.assert_allclose(n(q), n(jq), rtol=1e-5, atol=0, err_msg="prefix product")
    np.testing.assert_array_equal(n(s)[0], 0.0)
    np.testing.assert_array_equal(n(q)[0], 1.0)


def _bounds_case(rng, kind, n=192):
    """Pairs [n, 6] (mx, my, 0.5a, b, 0.5c, opacity) around a 32x32 tile at
    the origin: conics from covariances with eigenvalues lam and lam *
    ratio (px^2) at random angles."""
    lo, hi, rmax = {
        "random": (0.3, 1e3, 1e2), "near_degenerate": (0.3, 1e2, 1e6),
        "opacity_edges": (0.3, 1e3, 1e2), "huge": (1e4, 1e7, 1e3), "tiny": (1e-4, 0.3, 1e2),
    }[kind]
    lam1 = np.exp(rng.uniform(np.log(lo), np.log(hi), n))
    lam2 = lam1 * np.exp(rng.uniform(0.0, np.log(rmax), n))
    th = rng.uniform(0.0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    a = c * c / lam1 + s * s / lam2
    cc = s * s / lam1 + c * c / lam2
    b = c * s * (1.0 / lam1 - 1.0 / lam2)
    opa = rng.uniform(0.0, 1.0, n)
    if kind == "opacity_edges":
        near_min = rng.uniform(size=n) < 0.5
        opa = np.where(near_min, prast.ALPHA_MIN * (1.0 + rng.uniform(-1e-3, 1e-3, n)),
                       1.0 - rng.uniform(0.0, 1e-3, n))
    if kind == "tiny":  # near pixel centres, so that some composite
        mx = rng.integers(0, 32, n) + 0.5 + rng.uniform(-0.05, 0.05, n)
        my = rng.integers(0, 32, n) + 0.5 + rng.uniform(-0.05, 0.05, n)
    else:
        mx, my = rng.uniform(-24.0, 56.0, n), rng.uniform(-24.0, 56.0, n)
    return np.stack([mx, my, 0.5 * a, 2.0 * b, 0.5 * cc, opa], -1).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "near_degenerate", "opacity_edges", "huge", "tiny"])
def test_pair_bounds_contain_composited_pixels(kind):
    """Every pixel at which the exact alpha test passes has sigma <= s_cut
    and lies inside the pair's box (pair_bounds, the CUDA kernels' cull)."""
    rng = np.random.default_rng(["random", "near_degenerate", "opacity_edges", "huge", "tiny"].index(kind))
    rows = t(_bounds_case(rng, kind))[None]  # [1, n, 6]
    col = torch.arange(32, dtype=torch.float32) + 0.5
    px = col[None, :].expand(32, 32).reshape(1, 1, -1)
    py = col[:, None].expand(32, 32).reshape(1, 1, -1)
    alpha, aux = prast._alpha_terms(rows, torch.ones(rows.shape[:2], dtype=torch.bool), px, py)
    ok = alpha > 0
    s_cut, hx, hy = prast.pair_bounds(rows)
    dx, dy = aux["dx"], aux["dy"]
    sigma = aux["ca"] * dx * dx + aux["cc"] * dy * dy + aux["cb"] * dx * dy
    assert int(ok.sum()) > 0
    assert not bool((ok & (sigma > s_cut[..., None])).any())
    assert not bool((ok & ((px.double() - rows[..., 0:1].double()).abs() > hx[..., None])).any())
    assert not bool((ok & ((py.double() - rows[..., 1:2].double()).abs() > hy[..., None])).any())
    if kind in ("random", "tiny"):  # the box does cull
        inside = ((px.double() - rows[..., 0:1].double()).abs() <= hx[..., None]) & (
            (py.double() - rows[..., 1:2].double()).abs() <= hy[..., None])
        assert int(inside.sum()) < inside.numel()


def test_pair_bounds_special_rows():
    """Opacity below 1/255 (and zeroed out-of-range rows) never composite;
    non-finite or degenerate conics get an unbounded box."""
    nan, inf = float("nan"), float("inf")
    rows = torch.tensor([
        [5.0, 5.0, 0.1, 0.0, 0.1, 0.5 / 255.0],  # opacity below 1/255
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],  # a zeroed row
        [nan, 5.0, 0.1, 0.0, 0.1, 0.5],  # non-finite mean
        [5.0, 5.0, 0.1, 0.2, 0.1, 0.5],  # D = 0: degenerate
        [5.0, 5.0, -0.1, 0.0, 0.1, 0.5],  # not positive definite
        [5.0, 5.0, 0.5, 0.0, 0.5, 1.0],  # ordinary: sigma <= ln 255
    ])
    s_cut, hx, hy = prast.pair_bounds(rows)
    assert s_cut[0] == s_cut[1] == -inf and hx[0] == hy[1] == -1.0
    assert s_cut[2] == inf and hx[2] == hy[2] == inf
    assert torch.isfinite(s_cut[3:]).all() and (hx[3:5] == inf).all()
    np.testing.assert_allclose(float(s_cut[5]), np.log(255.0), rtol=2e-3)
    np.testing.assert_allclose(float(hx[5]), np.sqrt(np.log(255.0) / 0.5), rtol=2e-3)


def test_tile_order_longest_first():
    """Tiles by descending count, ties in tile order."""
    counts = torch.tensor([2, 5, 0, 5, 1, 2])
    order = prast.tile_order(counts)
    assert order.dtype == torch.int32
    assert order.tolist() == [1, 3, 0, 5, 4, 2]


def test_launch_order_default_and_given():
    """Both compositor wrappers launch in the order they are given (the
    autograd op passes one order to both), else by descending chunk count;
    an order of the wrong type or length raises."""
    starts = torch.tensor([0, 100, 100, 700, 1000], dtype=torch.int32)  # chunk 128
    assert prast._launch_order(starts, 128, None).tolist() == [2, 3, 0, 1]
    given = torch.tensor([3, 2, 1, 0], dtype=torch.int32)
    assert prast._launch_order(starts, 128, given).tolist() == [3, 2, 1, 0]
    for bad in (given.long(), given[:3]):
        with pytest.raises(ValueError):
            prast._launch_order(starts, 128, bad)
