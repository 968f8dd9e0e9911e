"""ops/project_pack.py: the backward's closed form against autograd, and
rasterize's CPU path against the composition it replaced.

``project_pack_bwd_plain`` is the specification the CUDA backward (K5)
transcribes. It is held against autograd through ``project_pack_plain`` (the
composition projection -> SH colours -> pack_table) in float64, where two
orders of the same sums agree to ~1e-13: within 1e-6 relative with a floor of
1e-12. The card-only test at the end holds the kernels against the plain
versions at the train cells' shapes (``chip_smoke.check_project_pack``).
"""
import numpy as np
import pytest
import torch

from gs_init_tpu_torch.ops import project_pack as ppk
from gs_init_tpu_torch.ops.project_pack import pack_table
from gs_init_tpu_torch.ops.projection import project_gaussians
from gs_init_tpu_torch.ops.rasterize import render_tiles, unpack_tiles
from gs_init_tpu_torch.ops.render import rasterize
from gs_init_tpu_torch.ops.sh import sh_to_color
from gs_init_tpu_torch.ops.tiles import bin_gaussians

W, H = 64, 48
NEAR = 0.01
LEAVES = ("means", "quats", "scales", "opacities", "colors", "viewmats")


def _rotation(rng, angle):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def make_case(seed=0, n=48, c=2, camera_model="pinhole", sh_degree=3, colors="sh", edges=False,
              dtype=torch.float64):
    """Gaussians in front of ``c`` cameras (camera 0 the identity); with
    ``edges``, gaussians on and behind the near plane, beyond the 1.3
    tan-fov clamp, long thin ones, colours clamped at 0 and dead slots."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.6, 0.6, n), rng.uniform(1.5, 4.0, n)], -1)
    quats = rng.normal(size=(n, 4))
    scales = rng.uniform(0.03, 0.3, (n, 3))
    opac = rng.uniform(0.05, 0.95, n)
    alive = np.ones(n, bool)
    sh0 = rng.normal(0.0, 0.5, (n, 1, 3))
    shn = rng.normal(0.0, 0.3, (n, 15, 3))
    if edges:
        means[0] = [0.1, 0.05, NEAR]  # on the near plane: culled, run at depth 1
        means[1] = [0.2, -0.1, -0.5]  # behind the camera
        if camera_model != "fisheye":  # whose forward is NaN there
            means[2] = [0.0, 0.0, 0.0]  # at the camera centre
        means[3] = [3.0, 0.1, 1.0]  # tx / tz beyond the clamp
        means[4] = [-0.2, -2.5, 1.0]  # ty / tz beyond the clamp
        scales[5:9] = [[0.6, 0.002, 0.002], [0.002, 0.5, 0.003], [0.4, 0.4, 0.001], [0.001, 0.002, 0.7]]
        sh0[9:12] = -3.0  # colours clamped at 0
        alive[12:15] = False
    vm = np.tile(np.eye(4), (c, 1, 1))
    for i in range(1, c):
        vm[i, :3, :3] = _rotation(rng, 0.15)
        vm[i, :3, 3] = rng.uniform(-0.2, 0.2, 3)
    f = 20.0 if camera_model == "ortho" else 0.9 * W
    Ks = np.tile(np.array([[f, 0, W / 2 + 0.3], [0, f * 1.05, H / 2 - 0.2], [0, 0, 1]]), (c, 1, 1))
    t = lambda x: torch.tensor(x, dtype=dtype)
    case = dict(means=t(means), quats=t(quats), scales=t(scales), opacities=t(opac), viewmats=t(vm), Ks=t(Ks),
                alive=torch.tensor(alive))
    if colors == "sh":
        case.update(colors=t(np.concatenate([sh0, shn], 1)), sh_degree=sh_degree)
    elif colors == "rgb":
        case.update(colors=t(rng.uniform(0, 1, (n, 3))), sh_degree=None)
    else:  # one colour per camera and gaussian, as the appearance MLP gives
        case.update(colors=t(rng.uniform(0, 1, (c, n, 3))), sh_degree=None)
    return case


def check_backward(case, camera_model="pinhole", antialiased=False, want_viewmats=True, sh_mask=None,
                   eps2d=0.3, seed=1):
    """Autograd through project_pack_plain against project_pack_bwd_plain on
    one random cotangent of the table; returns the autograd forward."""
    leaves = {k: case[k].clone().requires_grad_(True) for k in LEAVES if case.get(k) is not None}
    if not want_viewmats:
        leaves["viewmats"].requires_grad_(False)
    kw = dict(sh_degree=case["sh_degree"], near_plane=NEAR, sh_mask=sh_mask, eps2d=eps2d,
              antialiased=antialiased, camera_model=camera_model)
    table, radii, extents, depths = ppk.project_pack_plain(
        leaves["means"], leaves["quats"], leaves["scales"], leaves["opacities"], leaves["colors"],
        leaves["viewmats"], case["Ks"], W, H, alive=case["alive"], **kw,
    )
    g = torch.randn(table.shape, generator=torch.Generator().manual_seed(seed), dtype=table.dtype)
    g[:, 10:] = 0.0
    names = [k for k in LEAVES if k in leaves and leaves[k].requires_grad]
    want = dict(zip(names, torch.autograd.grad((table * g).sum(), [leaves[k] for k in names])))
    got = dict(zip(LEAVES, ppk.project_pack_bwd_plain(
        g, case["means"], case["quats"], case["scales"], case["opacities"], case["colors"], case["viewmats"],
        case["Ks"], W, H, want_viewmats=want_viewmats, **kw,
    )))
    for k in LEAVES:
        if k in want:
            assert got[k] is not None, k
            torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-12, msg=lambda m, k=k: f"{k}: {m}")
            assert bool(torch.isfinite(want[k]).all()), k
        else:
            assert got[k] is None, k
    return table, radii, extents, depths


@pytest.mark.parametrize("camera_model", ["pinhole", "ortho", "fisheye"])
@pytest.mark.parametrize("antialiased", [False, True], ids=["classic", "antialiased"])
def test_backward_matches_autograd_by_camera(camera_model, antialiased):
    case = make_case(seed=3, camera_model=camera_model)
    _, radii, _, _ = check_backward(case, camera_model, antialiased)
    assert int((radii > 0).sum()) > 40  # most of the scene is visible


@pytest.mark.parametrize("degree,active", [(0, 1), (1, 1), (1, 4), (2, 4), (2, 9), (3, 9), (3, 16)])
def test_backward_sh_degree_and_mask(degree, active):
    """The degree schedule rides a basis mask: bases past ``active`` are 0."""
    case = make_case(seed=4, sh_degree=degree)
    nb = (degree + 1) ** 2
    mask = (torch.arange(nb) < active).to(torch.float64)
    check_backward(case, sh_mask=mask)


@pytest.mark.parametrize("colors", ["rgb", "rgb_per_camera"])
def test_backward_colours(colors):
    check_backward(make_case(seed=5, colors=colors))


@pytest.mark.parametrize("c", [1, 2])
@pytest.mark.parametrize("want_viewmats", [True, False], ids=["viewmats_grad", "no_viewmats_grad"])
def test_backward_cameras_and_viewmats(c, want_viewmats):
    check_backward(make_case(seed=6, c=c), want_viewmats=want_viewmats)


@pytest.mark.parametrize("camera_model,antialiased", [("pinhole", False), ("pinhole", True), ("fisheye", True)])
def test_backward_edges(camera_model, antialiased):
    """Near plane, behind the camera, at its centre, beyond the clamp,
    colours clamped at 0, dead slots; the edges all show in the forward."""
    case = make_case(seed=7, c=1, edges=True, camera_model=camera_model)
    table, radii, extents, depths = check_backward(case, camera_model, antialiased)
    assert int(radii[0, 0]) == 0 and int(radii[0, 1]) == 0  # on and behind the near plane
    assert not bool(radii[0, 12:15].any())  # dead
    if camera_model == "pinhole":
        tz = depths[0].detach()
        tx = case["means"][:, 0]
        lim = 1.3 * 0.5 * W / float(case["Ks"][0, 0, 0])
        assert float(tx[3] / tz[3]) > lim and float(case["means"][4, 1] / tz[4]) < -1.3 * 0.5 * H / float(
            case["Ks"][0, 1, 1])
    rgb = table[:, 6:9].detach()
    assert bool((rgb[9:12] == 0).any())  # a colour clamped at 0


def test_backward_det_not_positive():
    """eps2d below 0 with long thin gaussians: det <= 0 takes det_safe's
    other branch (and the antialiased compensation its clamp)."""
    case = make_case(seed=8, c=1, edges=True)
    for aa in (False, True):
        check_backward(case, antialiased=aa, eps2d=-0.3)
    proj = project_gaussians(case["means"], case["quats"], case["scales"], case["opacities"], case["viewmats"],
                             case["Ks"], W, H, near_plane=NEAR, eps2d=-0.3)
    # det_safe = 1 where det <= 0, so the conic is (c, -b, a) there and its
    # own determinant is det; elsewhere it is 1 / det > 0.
    k = proj.conics
    assert int((k[..., 0] * k[..., 2] - k[..., 1] ** 2 <= 0).sum()) >= 3


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_backward_sh_with_only_the_degree_s_coefficients(degree):
    """SH coefficients [N, (degree + 1)^2, 3], not the 16 of degree 3: the
    kernels index the coefficients by their count, not by 16."""
    case = make_case(seed=9, sh_degree=degree)
    case["colors"] = case["colors"][:, : (degree + 1) ** 2].contiguous()
    check_backward(case)


def _old_rasterize(means, quats, scales, opacities, colors, viewmats, Ks, width, height, *, sh_degree, sh_mask,
                   alive, means2d_dummy, pair_dummy, render_mode, backgrounds, antialiased, pair_capacity):
    """rasterize's tile path as it was composed before project_pack."""
    proj = project_gaussians(means, quats, scales, opacities, viewmats, Ks, width, height, near_plane=NEAR,
                             antialiased=antialiased, alive=alive)
    means2d = proj.means2d + means2d_dummy
    c = viewmats.shape[0]
    if sh_degree is not None:
        centers = -torch.einsum("cji,cj->ci", viewmats[:, :3, :3], viewmats[:, :3, 3])
        dirs = means[None, :, :] - centers[:, None, :]
        cam_colors = sh_to_color(colors[None].expand((c,) + colors.shape), dirs, sh_degree, basis_mask=sh_mask)
    else:
        cam_colors = colors[None].expand((c,) + colors.shape)
    binning = bin_gaussians(means2d, proj.radii, proj.depths, width, height, 16, pair_capacity, chunk=32,
                            extents=proj.extents)
    table = pack_table(means2d, proj.conics, proj.opacities, cam_colors, proj.depths)
    nt = c * binning.num_tiles_x * binning.num_tiles_y
    out = render_tiles(table, pair_dummy, binning.gid_sorted, binning.tile_starts, nt, binning.num_tiles_x,
                       binning.num_tiles_y, 16, 32, render_mode == "RGB+ED", True)
    color, alpha, depth = unpack_tiles(out, c, binning.num_tiles_x, binning.num_tiles_y, 16, width, height)
    color = color + (1.0 - alpha)[..., None] * backgrounds[:, None, None, :]
    if render_mode == "RGB+ED":
        color = torch.cat([color, (depth / torch.clamp(alpha, min=1e-10))[..., None]], -1)
    return color, alpha[..., None], proj.radii


@pytest.mark.parametrize("colors,render_mode,antialiased", [
    ("sh", "RGB", False), ("sh", "RGB+ED", True), ("rgb", "RGB", False),
])
def test_rasterize_cpu_equals_the_old_composition(colors, render_mode, antialiased):
    """On CPU tensors rasterize runs the composition it ran before
    project_pack: renders, radii and every gradient equal to the bit."""
    case = make_case(seed=10, n=64, colors=colors, edges=True, dtype=torch.float32)
    n, c = case["means"].shape[0], case["viewmats"].shape[0]
    sh_mask = torch.tensor([1.0] * 4 + [0.0] * 12) if colors == "sh" else None
    bkgd = torch.tensor([[0.1, 0.2, 0.3]] * c)
    sh = case["colors"]

    def run(new):
        leaves = [case[k].clone().requires_grad_(True) for k in ("means", "quats", "scales", "opacities")]
        col = sh.clone().requires_grad_(True)
        dummy = torch.zeros((c, n, 2), requires_grad=True)
        pair = torch.zeros((c * n, 2), requires_grad=True)
        kw = dict(sh_degree=case["sh_degree"], sh_mask=sh_mask, alive=case["alive"], means2d_dummy=dummy,
                  pair_dummy=pair, render_mode=render_mode, backgrounds=bkgd)
        if new:
            img, alpha, info = rasterize(*leaves, col, case["viewmats"], case["Ks"], W, H, near_plane=NEAR,
                                         rasterize_mode="antialiased" if antialiased else "classic",
                                         tile_size=16, chunk_size=32, pair_capacity=4096, **kw)
            radii = info.radii
        else:
            img, alpha, radii = _old_rasterize(*leaves, col, case["viewmats"], case["Ks"], W, H,
                                               antialiased=antialiased, pair_capacity=4096, **kw)
        loss = (img * torch.linspace(0.5, 1.5, img.numel()).reshape(img.shape)).sum() + alpha.sum()
        grads = torch.autograd.grad(loss, leaves + [col, dummy, pair])
        return [img, alpha, radii] + list(grads)

    for a, b in zip(run(True), run(False)):
        assert torch.equal(a, b)


def test_kernel_path_needs_cuda_tensors():
    """The CUDA wrappers check their inputs before anything launches."""
    case = make_case(seed=11, dtype=torch.float32)
    kw = dict(sh_degree=3, near_plane=NEAR, far_plane=1e10, eps2d=0.3, antialiased=False, radius_clip=0.0,
              camera_model="pinhole")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ppk._Inputs(case["means"], case["quats"], case["scales"], case["opacities"], case["colors"],
                    case["viewmats"], case["Ks"], None, None, kw)
    with pytest.raises(ValueError, match="camera model"):
        ppk._cam_code("equirect")


@pytest.mark.card
def test_kernels_match_plain_on_the_card():
    """K4 and K5 against the plain forward and project_pack_bwd_plain at the
    train cells' shapes (1M slots, 1296x840) and on the edge cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 and K5 are CUDA kernels with no CPU mode")
    import chip_smoke

    chip_smoke.build_kernels()
    chip_smoke.project_pack_checks(torch.device("cuda", 0))
