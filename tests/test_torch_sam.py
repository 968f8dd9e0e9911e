"""Parity: the port's SAM (``models/sam.py``, ``mdi/predictors/
sam_convert.py``, ``mdi/segmentation_sam.py``) against the JAX package.

A narrow SAM (width 32, depth 2, 128 px, window 4, one global block; the
decoder at its published width) with flax variables drawn by
``torch_parity.random_flax_variables`` and carried across by
``sam_convert.state_dict_from_flax``: the image embedding within 1e-5 of its
max (and again with window 3, whose windows need padding), the prompt
encoder's sparse embeddings and dense positional encoding within 1e-5 abs,
the decoder's masks within 1e-5 of their max and IoU predictions within
1e-5 abs. The official ``segment_anything`` key layout (the JAX tests'
torch assembly of it) loads into the port by name and reproduces that
network. Then, on one checkpoint file under ``GS_TPU_CHECKPOINT_DIR`` that
both packages load: the mask generator's masks and ``segment_depth_sam``'s
labels equal to the JAX ones, with and without masks kept by the filters
(the random network's IoU predictions stay under the default threshold, so
the defaults exercise the no-mask fallback); the NaN-depth case; the
overlap rule; and ``align_depth`` with SAM regions. The twin is
tests/test_sam_parity.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gs_init_tpu.config import SegmentationConfig as JSegCfg
from gs_init_tpu.config.config import DepthAlignmentConfig as JAlignCfg
from gs_init_tpu.mdi import segmentation_sam as JS
from gs_init_tpu.mdi.alignment.pipeline import align_depth as j_align_depth
from gs_init_tpu.mdi.predictors import sam_convert as jconv
from gs_init_tpu.models import sam as jsam
from gs_init_tpu_torch.config import DepthAlignmentConfig, SegmentationConfig
from gs_init_tpu_torch.mdi import segmentation_sam as PS
from gs_init_tpu_torch.mdi.alignment.pipeline import align_depth
from gs_init_tpu_torch.mdi.predictors import sam_convert as pconv
from gs_init_tpu_torch.models import sam as psam
from gs_init_tpu_torch.models.common import build
from test_sam_parity import _build_torch_sam
from torch_parity import carry, n, random_flax_variables, t

DIM, DEPTH, HEADS, IMG, WIN, GLOBAL = 32, 2, 2, 128, 4, (1,)
G = IMG // 16
TINY = dict(dim=DIM, depth=DEPTH, num_heads=HEADS, global_attn_indexes=GLOBAL)


def _flax_nets(window=WIN):
    enc = jsam.SamImageEncoder(img_size=IMG, dim=DIM, depth=DEPTH, num_heads=HEADS, window_size=window,
                               global_attn_indexes=GLOBAL)
    prompt = jsam.SamPromptEncoder(image_embedding_size=(G, G), input_image_size=(IMG, IMG))
    return enc, prompt, jsam.SamMaskDecoder()


def _flax_variables(window=WIN, seed=0):
    enc, prompt, dec = _flax_nets(window)
    return {
        "encoder": random_flax_variables(enc, jnp.zeros((1, IMG, IMG, 3)), seed=seed),
        "prompt": random_flax_variables(prompt, jnp.zeros((1, 1, 2)), jnp.zeros((1, 1), jnp.int32), seed=seed + 1),
        "decoder": random_flax_variables(
            dec, jnp.zeros((1, G, G, 256)), jnp.zeros((G, G, 256)), jnp.zeros((1, 2, 256)), jnp.zeros((256,)),
            seed=seed + 2,
        ),
    }


def _port_sam(window=WIN):
    return build(psam.Sam, img_size=IMG, window_size=window, **TINY)


def _assert_scaled(got, want, atol, what):
    got, want = n(got), np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, err_msg=what)


def _check_nets(port, fv, enc, prompt, dec, rng):
    img = rng.uniform(-1, 1, (1, IMG, IMG, 3)).astype(np.float32)
    with torch.no_grad():
        embed = port.image_encoder(t(img.transpose(0, 3, 1, 2)))
    jembed = enc.apply({"params": fv["encoder"]["params"]}, jnp.asarray(img))
    _assert_scaled(embed.permute(0, 2, 3, 1), jembed, 1e-5, "image embedding")

    pts = rng.uniform(0, IMG, (3, 2, 2)).astype(np.float32)
    labels = np.array([[1, -1], [1, 0], [0, -1]], np.int32)
    pv = {"params": fv["prompt"]["params"]}
    jsparse, jno_mask = prompt.apply(pv, jnp.asarray(pts), jnp.asarray(labels))
    jpe = prompt.apply(pv, method=jsam.SamPromptEncoder.dense_pe)
    with torch.no_grad():
        sparse, no_mask = port.prompt_encoder(t(pts), torch.as_tensor(labels))
        pe = port.prompt_encoder.dense_pe()
        masks, iou = port.mask_decoder(embed, pe, sparse, no_mask)
    np.testing.assert_allclose(n(sparse), np.asarray(jsparse), atol=1e-5)
    np.testing.assert_allclose(n(no_mask), np.asarray(jno_mask), atol=1e-6)
    np.testing.assert_allclose(n(pe), np.asarray(jpe), atol=1e-5)
    jmasks, jiou = dec.apply({"params": fv["decoder"]["params"]}, jnp.broadcast_to(jembed, (3,) + jembed.shape[1:]),
                             jpe, jsparse, jno_mask)
    assert masks.shape == (3, 4, 4 * G, 4 * G)
    _assert_scaled(masks, jmasks, 1e-5, "masks")
    np.testing.assert_allclose(n(iou), np.asarray(jiou), atol=1e-5)


@pytest.mark.parametrize("window", [WIN, 3])
def test_networks_match_flax(window):
    fv = _flax_variables(window)
    port = carry(_port_sam(window), pconv.state_dict_from_flax(fv))
    _check_nets(port, fv, *_flax_nets(window), np.random.default_rng(window))


def test_official_layout_loads_by_name():
    """The official key layout is the port's own: the JAX tests' torch
    assembly of segment_anything loads strictly, reproduces that network,
    and goes through the JAX converter and back to the same tensors."""
    oracle = _build_torch_sam()
    sd = oracle.state_dict()
    port = pconv.load_sam_state_dict(_port_sam(), sd).eval()
    assert set(port.state_dict()) == set(sd)
    jconv.SAM_VARIANTS["tiny"] = TINY
    try:
        back = pconv.state_dict_from_flax(jconv.convert_sam_checkpoint(sd, "tiny"))
    finally:
        del jconv.SAM_VARIANTS["tiny"]
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(n(back[k]), n(v), err_msg=k)
    rng = np.random.default_rng(1)
    img = t(rng.uniform(-1, 1, (1, 3, IMG, IMG)))
    pts, labels = t(rng.uniform(0, IMG, (2, 2, 2))), torch.tensor([[1, -1], [0, 1]])
    with torch.no_grad():
        embed = port.image_encoder(img)
        _assert_scaled(embed, oracle.image_encoder(img), 1e-5, "embedding")
        sparse, no_mask = port.prompt_encoder(pts, labels)
        np.testing.assert_allclose(n(sparse), n(oracle.prompt_encoder(pts, labels)), atol=1e-5)
        pe = port.prompt_encoder.dense_pe()
        masks, iou = port.mask_decoder(embed, pe, sparse, no_mask)
        src = embed + oracle.prompt_encoder.no_mask_embed.weight[0][None, :, None, None]
        omasks, oiou = oracle.mask_decoder(src, oracle.prompt_encoder.dense_pe((G, G)).permute(2, 0, 1), sparse)
    _assert_scaled(masks, omasks, 1e-5, "masks")
    np.testing.assert_allclose(n(iou), n(oiou), atol=1e-5)
    with pytest.raises(ValueError, match="sam checkpoint mismatch"):
        pconv.load_sam_state_dict(_port_sam(), {k: v for k, v in sd.items() if "neck" not in k})


@pytest.fixture()
def sam_checkpoint(tmp_path, monkeypatch):
    """One random official-layout checkpoint, sam_tiny.pth, that both
    packages find under GS_TPU_CHECKPOINT_DIR (variant "tiny", the
    generator's 14x14 windows, which pad the 8x8 grid)."""
    sam = _port_sam(window=14)
    from gs_init_tpu_torch.models.common import init_random_

    init_random_(sam, 4)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        sam.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix.normal_(generator=g)
        sam.mask_decoder.iou_token.weight.normal_(generator=g)
        sam.mask_decoder.mask_tokens.weight.normal_(generator=g)
        for emb in list(sam.prompt_encoder.point_embeddings) + [sam.prompt_encoder.not_a_point_embed]:
            emb.weight.normal_(generator=g)
    torch.save(sam.state_dict(), tmp_path / "sam_tiny.pth")
    monkeypatch.setenv("GS_TPU_CHECKPOINT_DIR", str(tmp_path))
    monkeypatch.setitem(jconv.SAM_VARIANTS, "tiny", TINY)
    monkeypatch.setitem(pconv.SAM_VARIANTS, "tiny", TINY)
    JS._cached_generator.cache_clear()
    PS._cached_generator.cache_clear()
    yield tmp_path
    JS._cached_generator.cache_clear()
    PS._cached_generator.cache_clear()


def _depth(rng, h=48, w=64):
    """Two planes at different depths over a slanted floor, with noise."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    d = 2.0 + 0.03 * ys
    d[8:30, 10:30] = 1.0
    d[20:44, 38:60] = 3.5 + 0.01 * xs[20:44, 38:60]
    return (d + rng.normal(0, 0.005, d.shape)).astype(np.float32)


def _masks_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["segmentation"], b["segmentation"])
        assert a["area"] == b["area"]
        assert a["predicted_iou"] == pytest.approx(b["predicted_iou"], abs=1e-5)
        assert a["stability_score"] == pytest.approx(b["stability_score"], abs=1e-6)


def test_mask_generator_matches_jax(sam_checkpoint):
    rng = np.random.default_rng(2)
    depth = _depth(rng) / 4.0
    np.testing.assert_array_equal(PS.viridis_rgb(depth), JS.viridis_rgb(depth))
    rgb = (255 * PS.viridis_rgb(depth)).astype(np.uint8)
    # Every mask passes the filters; the random network's masks are noise
    # over the whole frame, so the box NMS keeps one of the 192.
    kw = dict(variant="tiny", img_size=IMG, points_per_side=8, points_per_batch=16, pred_iou_thresh=-1e9,
              stability_score_thresh=-1.0)
    got = PS.SamMaskGenerator(device="cpu", **kw).generate(rgb)
    want = JS.SamMaskGenerator(**kw).generate(rgb)
    assert len(got) >= 1
    _masks_equal(got, want)
    seg = PS.create_segmentation(got, rgb.shape[:2])
    np.testing.assert_array_equal(seg, JS.create_segmentation(want, rgb.shape[:2]))
    np.testing.assert_array_equal(PS.postprocess_segmentation(seg, 2, 1e-3),
                                  JS.postprocess_segmentation(seg.copy(), 2, 1e-3))
    # At the default thresholds these weights keep no mask (the fallback
    # that test_segment_depth_sam_matches_jax takes).
    assert PS.SamMaskGenerator("tiny", img_size=IMG, device="cpu").generate(rgb) == []


def test_box_nms():
    boxes = [(0, 0, 9, 9), (1, 1, 9, 9), (20, 20, 29, 29), None]
    iou = np.array([0.9, 0.95, 0.5, 0.99])
    assert PS._box_nms(boxes, iou, 0.7) == [1, 2]  # 0 overlaps 1 by 81/100
    assert PS._box_nms(boxes, iou, 0.9) == [1, 0, 2]


@pytest.mark.parametrize("use_normals", [False, True])
def test_segment_depth_sam_matches_jax(sam_checkpoint, use_normals):
    rng = np.random.default_rng(3)
    depth = _depth(rng)
    mask = np.ones(depth.shape, bool)
    normals = rng.normal(size=depth.shape + (3,)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    args = dict(sam_variant="tiny", sam_img_size=IMG, sam_use_normals=use_normals)
    got = PS.segment_depth_sam(depth, mask, normals, SegmentationConfig(method="sam", **args), device="cpu")
    want = JS.segment_depth_sam(depth, mask, normals, JSegCfg(method="sam", **args))
    assert got.shape == depth.shape and np.issubdtype(got.dtype, np.integer)
    np.testing.assert_array_equal(got, want)


def test_segment_depth_sam_nan_depth(sam_checkpoint):
    rng = np.random.default_rng(4)
    depth = _depth(rng)
    mask = np.ones(depth.shape, bool)
    depth[:10] = np.nan  # a predictor's sky
    mask[:10] = False
    cfg = dict(sam_variant="tiny", sam_img_size=IMG, sam_use_normals=False)
    got = PS.segment_depth_sam(depth, mask, None, SegmentationConfig(method="sam", **cfg), device="cpu")
    np.testing.assert_array_equal(got, JS.segment_depth_sam(depth, mask, None, JSegCfg(method="sam", **cfg)))
    empty = PS.segment_depth_sam(np.full((8, 8), np.nan, np.float32), np.zeros((8, 8), bool), None,
                                 SegmentationConfig(method="sam", **cfg), device="cpu")
    assert (empty == 0).all()


def test_no_checkpoint_raises_unless_random_weights_are_allowed(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_TPU_CHECKPOINT_DIR", str(tmp_path))
    monkeypatch.setattr("os.path.expanduser", lambda p: str(tmp_path / "nohome") if "~" in p else p)
    monkeypatch.setitem(pconv.SAM_VARIANTS, "tiny", TINY)
    with pytest.raises(FileNotFoundError, match="sam_allow_random_weights"):
        PS.SamMaskGenerator("tiny", img_size=IMG, device="cpu")
    gen = PS.SamMaskGenerator("tiny", img_size=IMG, device="cpu", allow_random_weights=True)
    out = gen.generate(np.zeros((32, 40, 3), np.uint8))
    assert isinstance(out, list)


def test_create_segmentation_overlap_rule():
    big = np.zeros((10, 10), bool)
    big[:, :6] = True
    sub = np.zeros((10, 10), bool)
    sub[2:5, 1:5] = True  # inside big: merges into it
    other = np.zeros((10, 10), bool)
    other[:, 7:] = True
    huge = np.ones((10, 10), bool)  # above the degenerate threshold: skipped
    masks = [dict(segmentation=m, area=int(m.sum())) for m in (big, sub, other, huge)]
    seg = PS.create_segmentation(masks, (10, 10), degenerate_mask_thresh=0.9)
    np.testing.assert_array_equal(seg, JS.create_segmentation(masks, (10, 10), degenerate_mask_thresh=0.9))
    assert seg[3, 3] == seg[0, 0] != 0
    assert seg[0, 8] not in (0, seg[0, 0])
    assert (seg[:, 6] == 0).all()


def test_align_depth_with_sam_regions_matches_jax(sam_checkpoint):
    """The alignment pipeline routes segmentation.method="sam" through the
    segmenter and fits each region (least squares: no random draws)."""
    import jax

    rng = np.random.default_rng(6)
    depth = _depth(rng)
    mask = np.ones(depth.shape, bool)
    pix = np.stack([rng.uniform(0, 64, 300), rng.uniform(0, 48, 300)], -1).astype(np.float32)
    gt = 1.7 * depth[pix[:, 1].astype(int), pix[:, 0].astype(int)] + 0.2
    valid = np.ones(300, bool)
    cfgs = []
    for C, S in ((DepthAlignmentConfig, SegmentationConfig), (JAlignCfg, JSegCfg)):
        c = C(method="lstsqrs")
        c.segmentation = S(method="sam", sam_variant="tiny", sam_img_size=IMG, sam_use_normals=False,
                           region_margin=2.0)
        cfgs.append(c)
    got, gmask = align_depth(depth, mask, pix, gt, valid, cfgs[0], device="cpu")
    want, wmask = j_align_depth(depth, mask, pix, gt, valid, jax.random.PRNGKey(0), cfgs[1])
    np.testing.assert_array_equal(gmask, wmask)
    np.testing.assert_allclose(got[gmask], want[wmask], rtol=1e-5)
    assert gmask.any()
