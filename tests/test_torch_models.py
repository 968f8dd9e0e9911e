"""Parity: the port's depth networks and their blocks
(``gs_init_tpu_torch/models/``) against the JAX package's flax modules, on the same numpy inputs and the
same random flax variables carried across (``state_dict_from_flax``).

Narrow widths and few layers. The random variables
(``torch_parity.random_flax_variables``) give every kernel, transposed ones
included, no symmetry, and no bias zero or scale one, so a wrong flip,
transpose or name shows.
Tolerances: the resize matrices within 2e-6 abs (values in [0, 1]; JAX
builds its weights in float32 and so does the port, step for step);
torch's own bicubic equal to the matrix within 2e-5 (normal values, up to
3 in magnitude: torch places its taps in float32, which moves a tap by up
to ~5e-6 of a pixel at 76 outputs); each block's output
within 1e-5 of its max |value| (float32, sums in other orders); the RAFT
decoder (its GRU loop feeds its outputs back) and the whole MoGe-2,
UniDepth and DepthPro nets (a 12-layer ViT-S under the first two) within
1e-4 of each output's max (measured up to 3e-5 here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_init_tpu.models import depth_pro as jdp
from gs_init_tpu.models import dpt as jdpt
from gs_init_tpu.models import moge as jmoge
from gs_init_tpu.models import raft_dpt as jraft
from gs_init_tpu.models import unidepth as juni
from gs_init_tpu.models import vit as jvit
from gs_init_tpu_torch.models import common, depth_pro, dpt, moge, raft_dpt, unidepth, vit
from torch_parity import assert_close_scaled, carry, n, random_flax_variables, t


def nchw(x):
    return t(np.moveaxis(np.asarray(x), -1, 1))


def nhwc(x):
    return np.moveaxis(n(x), 1, -1)


def jax_apply(module, variables, *args, **static):
    return jax.jit(lambda v, *a: module.apply(v, *a, **static))(variables, *args)


@pytest.mark.parametrize(
    "method,shape_in,shape_out",
    [
        ("linear", (30, 44), (13, 17)),  # downscale: antialiased
        ("linear", (30, 44), (61, 95)),  # upscale
        ("linear", (840, 1296), (616, 950)),  # 1296x840 into Metric3D's crop
        ("cubic", (37, 37), (37, 57)),  # DA-V2's pos-embed grid at 518x798
        ("cubic", (37, 37), (4, 6)),  # and at a tiny input: antialiased
        ("linear", (30, 44), (45, 20)),  # one axis up, one down
    ],
)
def test_resize_matches_jax_image_resize(method, shape_in, shape_out):
    x = np.random.default_rng(0).uniform(0, 1, (2,) + shape_in).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2,) + shape_out, method=method)
    got = common.resize(t(x), shape_out, method)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=2e-6, rtol=0)


@pytest.mark.parametrize("n_in,n_out", [(37, 44), (37, 76), (37, 4), (5, 9)])
def test_torch_bicubic_matrix(n_in, n_out):
    scale = (n_out + 0.1) / n_in
    m = common.torch_bicubic_matrix(n_in, n_out, scale)
    np.testing.assert_array_equal(m, jvit.torch_bicubic_matrix(n_in, n_out, scale))
    x = torch.randn(1, 1, n_in, 3, generator=torch.Generator().manual_seed(0))
    ref = torch.nn.functional.interpolate(
        x, scale_factor=(scale, 1.0), mode="bicubic", align_corners=False, recompute_scale_factor=False
    )
    np.testing.assert_allclose(np.einsum("oi,bcid->bcod", m, n(x)), n(ref), atol=2e-5)


@pytest.mark.parametrize(
    "pos_interp,registers,grid,norms",
    [
        ("torch", 4, (7, 9), None),  # Metric3D's mode, an upscale, with registers
        ("torch", 0, (3, 4), (False, True)),  # a downscale; one raw output
        ("resize", 0, (7, 9), None),  # DA-V2's mode: jax.image.resize bicubic
        ("resize", 0, (3, 4), None),  # antialiased downscale
        ("resize", 0, (5, 5), None),  # the trained grid: no interpolation
        ("resize", 2, (5, 8), None),  # one axis kept
    ],
)
def test_dino_vit_matches_jax(pos_interp, registers, grid, norms):
    cfg = dict(dim=32, depth=2, num_heads=4, patch_size=14, num_register_tokens=registers,
               out_layers=(0, 1), pos_embed_size=5, pos_interp=pos_interp, out_layers_norm=norms)
    x = np.random.default_rng(1).normal(size=(2, 14 * grid[0], 14 * grid[1], 3)).astype(np.float32)
    jnet = jvit.DinoViT(**cfg)
    v = random_flax_variables(jnet, x)
    jf, jp = jax_apply(jnet, v, x)
    net = carry(vit.DinoViT(**cfg), common.state_dict_from_flax(v, vit.VIT_RENAMES))
    with torch.no_grad():
        pf, pp = net(nchw(x))
    for a, b in zip(pf, jf):
        assert_close_scaled(nhwc(a), b, 1e-5)
    for a, b in zip(pp, jp):
        assert_close_scaled(a, b, 1e-5)


@pytest.mark.parametrize("metric", [False, True])
def test_dpt_head_matches_jax(metric):
    cfg = dict(features=8, out_channels=(4, 6, 8, 10), metric=metric, max_depth=20.0)
    rng = np.random.default_rng(3)
    feats = [rng.normal(size=(2, 3, 4, 12)).astype(np.float32) for _ in range(4)]
    jhead = jdpt.DPTHead(**cfg)
    v = random_flax_variables(jhead, feats, (3, 4))
    want = jax_apply(jhead, v, feats, patch_hw=(3, 4))
    head = carry(dpt.DPTHead(12, **cfg),
                 common.state_dict_from_flax(v, dpt.DPT_RENAMES, dpt.DPT_TRANSPOSED))
    with torch.no_grad():
        got = head([nchw(f) for f in feats], (3, 4))
    assert got.shape == (2, 42, 56)
    assert_close_scaled(got, want, 1e-5)


@pytest.mark.parametrize("scale", [1, 2, 3.5])
def test_token2feature_matches_jax(scale):
    rng = np.random.default_rng(4)
    patch = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    learn = rng.normal(size=(2, 1, 1, 5 * 16)).astype(np.float32)
    jmod = jraft.Token2Feature(16, 12, scale)
    v = random_flax_variables(jmod, patch, learn)
    want = jax_apply(jmod, v, patch, learn)
    renames = ((r"^readout", "readoper"), (r"^sample$", "sample/0" if scale == 3.5 else "sample"))
    mod = carry(raft_dpt.Token2Feature(16, 12, scale, 5),
                common.state_dict_from_flax(v, renames, (r"sample",) if scale == 2 else ()))
    with torch.no_grad():
        got = mod(nchw(patch), t(learn.reshape(2, -1)))
    assert nhwc(got).shape == want.shape
    assert_close_scaled(nhwc(got), want, 1e-5)


@pytest.mark.parametrize("kw", [dict(scale=2.0), dict(scale=7 / 4), dict(fuse=False, upsample=False)])
def test_fuse_block_matches_jax(kw):
    rng = np.random.default_rng(5)
    x1, x2 = (rng.normal(size=(1, 5, 7, 8)).astype(np.float32) for _ in range(2))
    jmod = jraft.FuseBlock(8, 6, **kw)
    args = [x1] + ([x2] if kw.get("fuse", True) else [])
    v = random_flax_variables(jmod, *args)
    want = jax_apply(jmod, v, *args)
    mod = carry(raft_dpt.FuseBlock(8, 6, **kw), common.state_dict_from_flax(v))
    with torch.no_grad():
        got = mod(*[nchw(a) for a in args])
    assert_close_scaled(nhwc(got), want, 1e-5)


@pytest.mark.parametrize("cin", [6, 8])
def test_residual_block_matches_jax(cin):
    x = np.random.default_rng(6).normal(size=(2, 5, 6, cin)).astype(np.float32) * 3.0
    jmod = jraft.ResidualBlock(8)
    v = random_flax_variables(jmod, x)
    want = jax_apply(jmod, v, x)
    sd = common.state_dict_from_flax(v, ((r"^downsample$", "downsample/0"), (r"^norm3$", "downsample/1")))
    mod = carry(raft_dpt.ResidualBlock(cin, 8), sd)
    with torch.no_grad():
        got = mod(nchw(x))
    assert_close_scaled(nhwc(got), want, 1e-5)


def test_convex_upsample_and_norm_normalize_match_jax():
    rng = np.random.default_rng(7)
    flow = rng.normal(size=(2, 5, 7, 6)).astype(np.float32)
    mask = rng.normal(size=(2, 5, 7, 9 * 16)).astype(np.float32)
    want = jraft.RAFTDepthNormalDecoder._convex_upsample(jnp.asarray(flow), jnp.asarray(mask), 4)
    got = raft_dpt.convex_upsample(nchw(flow), nchw(mask), 4)
    assert_close_scaled(nhwc(got), want, 1e-6)
    nrm = rng.normal(size=(2, 5, 7, 4)).astype(np.float32)
    assert_close_scaled(nhwc(raft_dpt.norm_normalize(nchw(nrm))), jraft.norm_normalize(jnp.asarray(nrm)), 1e-6)


@pytest.mark.parametrize(
    "cfg",
    [
        dict(vit_dim=16, feature_channels=(8, 12, 16, 32), decoder_channels=(6, 8, 12, 16, 16),
             hidden_dim=8, iters=2),
        jraft.RAFT_CONFIGS["large"],  # Metric3D large's decoder (8 iterations) on a 4x6 grid
    ],
    ids=["narrow", "large"],
)
def test_raft_decoder_matches_jax(cfg):
    """The whole decode head: four different token maps, the readouts (1,
    1, 2, 3.5), the fuse blocks, the log-bin depth, the context encoder and
    the GRU hierarchy's iterations."""
    rng = np.random.default_rng(8)
    c = cfg["vit_dim"]
    patches = [rng.normal(size=(2, 4, 6, c)).astype(np.float32) for _ in range(4)]
    learns = [rng.normal(size=(2, 1, 1, 5 * c)).astype(np.float32) for _ in range(4)]
    jdec = jraft.RAFTDepthNormalDecoder(**cfg)
    v = random_flax_variables(jdec, patches, learns)
    jd, jc, jn = jax_apply(jdec, v, patches, learns)
    dec = carry(raft_dpt.RAFTDepthNormalDecoder(**cfg, n_prefix=5),
                common.state_dict_from_flax(v, raft_dpt.RAFT_RENAMES, raft_dpt.RAFT_TRANSPOSED))
    with torch.no_grad():
        d, conf, nrm = dec([nchw(p) for p in patches], [t(l.reshape(2, -1)) for l in learns])
    assert d.shape == (2, 56, 84) and nrm.shape == (2, 4, 56, 84)
    assert_close_scaled(d, jd, 1e-4)
    assert_close_scaled(conf, jc, 1e-4)
    assert_close_scaled(nhwc(nrm), jn, 1e-4)


def test_init_random_is_seeded_and_flax_shaped():
    a = common.init_random_(common.build(raft_dpt.ResidualBlock, 6, 8), seed=3)
    b = common.init_random_(common.build(raft_dpt.ResidualBlock, 6, 8), seed=3)
    c = common.init_random_(common.build(raft_dpt.ResidualBlock, 6, 8), seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["conv1.weight"], sc["conv1.weight"])
    assert torch.all(sa["conv1.bias"] == 0) and torch.all(sa["norm1.weight"] == 1)
    # Variance 1/fan_in (6 * 3 * 3 inputs), as flax's lecun_normal.
    assert abs(float(sa["conv1.weight"].std()) * np.sqrt(54) - 1) < 0.15


@pytest.mark.parametrize("hw", [(56, 84), (70, 42)])
def test_moge_model_matches_jax(hw):
    """MoGe-2 on a ViT-S with a narrow head: the head's x2 upsamples and its
    resizes to half and full size (torch bilinear, no antialiasing), the
    scale head, the exp remap, the unit normals."""
    kw = dict(backbone="vits", dim_proj=16, dim_upsample=(12, 8, 8), num_res_blocks=2, scale_hidden=16)
    x = np.random.default_rng(9).normal(size=(2,) + hw + (3,)).astype(np.float32)
    jnet = jmoge.MoGeModel(**kw)
    v = random_flax_variables(jnet, x)
    want = jax_apply(jnet, v, x)
    net = carry(moge.MoGeModel(**kw), common.state_dict_from_flax(v, vit.VIT_RENAMES + moge.MOGE_RENAMES))
    with torch.no_grad():
        got = net(nchw(x))
    assert_close_scaled(nhwc(got["points"]), want["points"], 1e-4)
    assert_close_scaled(got["mask_logit"], want["mask_logit"], 1e-4)
    np.testing.assert_allclose(nhwc(got["normal"]), want["normal"], atol=1e-4)
    assert_close_scaled(got["scale"], want["scale"], 1e-4)


def test_ray_embedding_matches_jax():
    K = np.array([[[40.0, 0, 3.1], [0, 38.0, 2.2], [0, 0, 1]], [[9.0, 0, 1.0], [0, 12.0, 4.0], [0, 0, 1]]],
                 np.float32)
    want = juni.ray_embedding(jnp.asarray(K), 5, 7)
    got = unidepth.ray_embedding(t(K), 5, 7)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=2e-5)  # sin / cos of up to 128 pi


@pytest.mark.parametrize("with_k", [True, False])
def test_unidepth_model_matches_jax(with_k):
    """UniDepth on a ViT-S with 16 features: the ray embedding from K (or
    from the camera head on the class token), the fusion at the patch
    grid, the align-corners resizes."""
    x = np.random.default_rng(10).normal(size=(2, 56, 84, 3)).astype(np.float32)
    K = np.array([[70.0, 0, 40.0], [0, 66.0, 29.0], [0, 0, 1]], np.float32)[None].repeat(2, 0)
    K[1, 0, 0] = 120.0
    jnet = juni.UniDepthModel(backbone="vits", features=16)
    v = random_flax_variables(jnet, x, None)  # the camera head traced too
    want = jax.jit(lambda v, x, k: jnet.apply(v, x, k))(v, x, K if with_k else None)
    net = carry(unidepth.UniDepthModel("vits", features=16),
                common.state_dict_from_flax(v, vit.VIT_RENAMES + unidepth.UNIDEPTH_RENAMES))
    with torch.no_grad():
        got = net(nchw(x), t(K) if with_k else None)
    assert_close_scaled(got["depth"], want["depth"], 1e-4)
    assert_close_scaled(got["confidence"], want["confidence"], 1e-4)
    assert_close_scaled(got["K"], want["K"], 1e-6)


@pytest.mark.parametrize("overlap,padding", [(0.0, 0), (0.5, 3), (0.25, 6)])
def test_depth_pro_split_merge_reconstruct_match_jax(overlap, padding):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 224, 224, 3)).astype(np.float32)
    want = jdp.split_to_patches(jnp.asarray(x), 56, overlap)
    got = depth_pro.split_to_patches(nchw(x), 56, overlap)
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))
    grids = rng.normal(size=(np.asarray(want).shape[0], 4, 4, 5)).astype(np.float32)
    want = jdp.reconstruct(jnp.asarray(grids.reshape(len(grids), 16, 5)), 4, 2, padding, (9, 11))
    got = depth_pro.reconstruct(nchw(grids), 2, padding, (9, 11))
    assert_close_scaled(nhwc(got), want, 1e-6)


TINY_DEPTH_PRO = dict(vit_dim=32, vit_depth=2, vit_heads=2, vit_image_size=56, vit_patch=14, fusion=16,
                      intermediate_hook_ids=(1, 0), intermediate_feature_dims=(16, 16),
                      scaled_images_feature_dims=(32, 32, 16))


@pytest.mark.parametrize("use_fov", [False, True])
def test_depth_pro_net_matches_jax(use_fov):
    """DepthPro at tiny widths on a 224 input: 3 scales cut into 1 + 9 + 25
    patches of 56 through the shared patch encoder, the merges with their
    cropped overlaps, the hooks, the neck's transposed convolutions, the
    fusion stage, the head and the FOV branch."""
    kw = dict(TINY_DEPTH_PRO, use_fov=use_fov)
    x = np.random.default_rng(12).normal(size=(2, 224, 224, 3)).astype(np.float32)
    jnet = jdp.DepthProNet(**kw)
    v = random_flax_variables(jnet, x)
    jinv, jfov = jax_apply(jnet, v, x)
    net = carry(depth_pro.DepthProNet(**kw), common.state_dict_from_flax(
        v, vit.VIT_RENAMES + depth_pro.DEPTH_PRO_RENAMES, depth_pro.DEPTH_PRO_TRANSPOSED))
    with torch.no_grad():
        inv, fov = net(nchw(x))
    assert inv.shape == jinv.shape == (2, 448, 448)  # the head ends at twice the input
    assert_close_scaled(inv, jinv, 1e-4)
    if use_fov:
        assert_close_scaled(fov, jfov, 1e-4)
    else:
        assert fov is None and jfov is None
