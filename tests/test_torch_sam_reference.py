"""The port's SAM (``models/sam.py``, ``mdi/segmentation_sam.py``) against the
benchmark's plain reference (``benchmark/reference/depthnet/sam.py`` and
``benchmark/reference/mdi/sam_amg.py``, ``regions.py``) on seeded random
weights, on the CPU; the encoder's operation count
(``benchmark/counts/sam.py``) against a hand count; and the SAM spans and
counters of ``trace.py``.

A narrow SAM (width 64, 4 blocks of 4 heads, global attention at blocks 1
and 3, the published 14x14 windows and decoder): at 128 px, whose 8x8 token
grid pads to one window, and at 224 px, whose 14x14 grid is one window
exactly, the image embedding, the low-res logits and the IoU predictions
within 1e-5 of each output's largest value (float32 rounding through four
blocks; a missing relative-position term or a swapped token is off by more
than 1e-2). The reference's filters, NMS, upsampling, painting and
postprocess on the port's own logits give the port's region map to the
pixel, with the filters at -inf so that every mask reaches NMS and the
painting.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from benchmark.counts import sam as sam_counts  # noqa: E402
from benchmark.reference.depthnet import sam as R  # noqa: E402
from benchmark.reference.mdi import regions as RR  # noqa: E402
from benchmark.reference.mdi import sam_amg as A  # noqa: E402
from gs_init_tpu_torch import trace  # noqa: E402
from gs_init_tpu_torch.config import DepthAlignmentConfig, SegmentationConfig  # noqa: E402
from gs_init_tpu_torch.mdi import segmentation_sam as PS  # noqa: E402
from gs_init_tpu_torch.mdi.alignment.pipeline import align_depth  # noqa: E402
from gs_init_tpu_torch.models import sam as psam  # noqa: E402
from gs_init_tpu_torch.models.common import build  # noqa: E402

NARROW = dict(dim=64, depth=4, num_heads=4, global_attn_indexes=(1, 3))
H, W = 48, 72  # the segmented depth map
NMS = 0.95


def narrow_pair(img_size, seed=0):
    """The port's narrow SAM with random weights and the reference loaded
    with the same state dict."""
    port = psam.init_random_sam_(build(psam.Sam, img_size=img_size, **NARROW), seed).eval()
    with torch.device("meta"):
        ref = R.SamNet(img_size=img_size, **NARROW)
    ref = ref.to_empty(device="cpu")
    ref.load_state_dict(port.state_dict())
    return port, ref.eval()


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("img_size", [128, 224])
def test_networks_match_the_reference(img_size):
    port, ref = narrow_pair(img_size)
    g = torch.Generator().manual_seed(img_size)
    x = torch.randn((1, 3, img_size, img_size), generator=g)
    with torch.inference_mode():
        e_port = port.image_encoder(x)
        e_ref = ref.encode(x)
        assert rel(e_port, e_ref) < 1e-5
        xy = torch.rand((80, 2), generator=g) * img_size
        pts = torch.stack([xy, torch.zeros_like(xy)], dim=1)
        labels = torch.tensor([[1, -1]] * 80, dtype=torch.int32)
        sparse, no_mask = port.prompt_encoder(pts, labels)
        masks, iou = port.mask_decoder(e_port, port.prompt_encoder.dense_pe(), sparse, no_mask)
        m_ref, q_ref = ref.decode(e_port, xy, batch=32)
    assert masks.shape == m_ref.shape == (80, 4, img_size // 4, img_size // 4)
    assert rel(masks, m_ref) < 1e-5 and rel(iou, q_ref) < 1e-5


def test_a_fault_in_the_reference_is_seen():
    """The tolerance is far below what a missing term moves: the first
    global block's relative positions zeroed."""
    port, ref = narrow_pair(128)
    x = torch.randn((1, 3, 128, 128), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want = port.image_encoder(x)
        ref.image_encoder.blocks[1].attn.rel_pos_h.zero_()
        ref.image_encoder.blocks[1].attn.rel_pos_w.zero_()
        assert rel(ref.encode(x), want) > 1e-2


def depth_scene():
    """A depth map of a few slanted planes and its normals, all valid."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = np.where(xs < W / 3, 2.0 + 0.01 * ys, np.where(ys < H / 2, 4.0 - 0.02 * xs, 3.0 + 0.03 * ys))
    nrm = np.stack([np.sign(xs - W / 3), np.sign(ys - H / 2), np.ones_like(xs)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return depth.astype(np.float32), np.ones((H, W), bool), nrm.astype(np.float32)


@pytest.fixture
def narrow_generator(monkeypatch):
    """The port's mask generator on the narrow SAM at 128 px, its filters
    at -inf and its box NMS at 0.95 (the random network's boxes overlap:
    at 0.7 NMS keeps one mask, at 0.95 a few); ``segment_depth_sam`` finds
    it. Hooks keep each call's embedding, multimask logits and IoU
    predictions."""
    monkeypatch.setitem(PS.SAM_VARIANTS, "vit_b", NARROW)
    gen = PS.SamMaskGenerator(variant="vit_b", img_size=128, pred_iou_thresh=-np.inf,
                              stability_score_thresh=-np.inf, box_nms_thresh=NMS, allow_random_weights=True,
                              device="cpu")
    monkeypatch.setattr(PS, "_cached_generator", lambda *a: gen)
    calls = []
    gen.net.image_encoder.register_forward_hook(lambda m, i, o: calls.append(dict(embed=o, logits=[], iou=[])))

    def decoded(m, i, o):
        calls[-1]["logits"].append(o[0][:, 1:])
        calls[-1]["iou"].append(o[1][:, 1:])

    gen.net.mask_decoder.register_forward_hook(decoded)
    gen.calls = calls
    return gen


def seg_cfg(**kw):
    """SAM regions at 128 px; masks over 60% of the image are left out of
    the painting (at the default 90% one of the random network's large masks
    takes in every other and the map is one region)."""
    return SegmentationConfig(method="sam", sam_variant="vit_b", sam_img_size=128,
                              **dict(dict(sam_degenerate_mask_thresh=0.6), **kw))


def test_region_map_equals_the_references_steps(narrow_generator):
    gen = narrow_generator
    depth, mask, nrm = depth_scene()
    labels = PS.segment_depth_sam(depth, mask, nrm, seg_cfg(), allow_random_weights=True, device="cpu")
    assert len(gen.calls) == 2  # the depth image, then the normal image
    _, ref = narrow_pair(128)
    ref.load_state_dict(gen.net.state_dict())
    by_call = []
    for rgb, call in zip([A.depth_image(depth, mask), A.normal_image(nrm)], gen.calls):
        x, nhw = A.network_input(rgb, 128, "cpu")
        logits, iou = torch.cat(call["logits"]), torch.cat(call["iou"])
        assert rel(call["embed"], ref.encode(x)) < 1e-5
        m_ref, q_ref = ref.decode(call["embed"], torch.as_tensor(A.point_grid(32, *nhw), dtype=torch.float32))
        assert rel(logits, m_ref[:, 1:]) < 1e-5 and rel(iou, q_ref[:, 1:]) < 1e-5
        by_call.append(A.masks_from_logits(logits, iou, (H, W), nhw, "cpu", pred_iou_thresh=-np.inf,
                                           stability_thresh=-np.inf, nms_thresh=NMS))
    assert all(len(m) > 1 for m in by_call)  # NMS kept several masks, and painting had work
    st = {"mdi.alignment.segmentation." + k: v for k, v in
          dict(sam_degenerate_mask_thresh=0.6, sam_expansion_radius=4, sam_tiny_region_area_fraction=1e-4).items()}
    want = A.regions(by_call[::-1], (H, W), st)
    assert len(np.unique(labels)) > 1
    np.testing.assert_array_equal(labels, want)


def test_merge_and_region_alignment_equal_the_references(narrow_generator, monkeypatch):
    """``align_depth`` with SAM regions against the reference's merge,
    margin and per-region RANSAC from the same generator state."""
    depth, mask, nrm = depth_scene()
    rng = np.random.default_rng(3)
    pix = np.stack([rng.uniform(0, W, 300), rng.uniform(0, H, 300)], -1).astype(np.float32)
    ok = rng.uniform(size=300) < 0.9
    gt = 1.7 * depth[pix[:, 1].astype(int), pix[:, 0].astype(int)] + 0.2
    acfg = DepthAlignmentConfig(segmentation=seg_cfg())
    from gs_init_tpu_torch.mdi.alignment import pipeline

    merged, real_merge = [], pipeline.merge_regions

    def merge(labels, *a, **kw):
        out = real_merge(labels, *a, **kw)
        merged.append((labels, out))
        return out

    monkeypatch.setattr(pipeline, "merge_regions", merge)
    g = torch.Generator().manual_seed(11)
    aligned, amask = align_depth(depth, mask, pix, gt, ok, acfg, generator=g, device="cpu", normals=nrm)
    segment, labels = merged[0]
    st = {"mdi.alignment.segmentation." + k: getattr(acfg.segmentation, k) for k in
          ("merge_gradient_threshold", "merge_min_sfm_points", "region_margin", "propagate_mask")}
    st.update({"mdi.alignment.ransac." + k: getattr(acfg.ransac, k) for k in
               ("sample_size", "inlier_threshold", "max_iterations")})
    st["mdi.alignment.method"] = acfg.method
    r_labels, r_aligned, r_mask, fitted = RR.align_regions(depth, mask, segment, pix, gt, ok, st,
                                                           torch.Generator().manual_seed(11), "cpu")
    assert fitted >= 1
    np.testing.assert_array_equal(labels, r_labels)
    np.testing.assert_array_equal(aligned, r_aligned)
    np.testing.assert_array_equal(amask, r_mask)


def test_encoder_count_against_a_hand_count():
    """Each linear 2 in out a token, the patch and neck convolutions, each
    attention 4 N^2 C plus the relative-position terms 2 N (h + w) C; in a
    windowed block (the 8x8 grid padded to one 14x14 window) the attention's
    projections for the 64 real tokens alone, and their queries against all
    196 keys."""
    c, g, win = 64, 8, 14
    patch = 2 * (3 * 16 * 16) * c * g * g
    mlp = 2 * 2 * c * 4 * c * g * g
    windowed = 2 * (3 * c * c + c * c) * g * g + 4 * g * g * win * win * c + 2 * g * g * 2 * win * c + mlp
    glob = 2 * (3 * c * c + c * c) * g * g + 4 * (g * g) ** 2 * c + 2 * g * g * 2 * g * c + mlp
    neck = 2 * 256 * g * g * c + 2 * 256 * g * g * 256 * 9
    assert sam_counts.encoder_ops(128, None, **NARROW) == patch + 2 * windowed + 2 * glob + neck


def test_vit_h_count_at_the_published_size():
    """ViT-H at 1024 px: ~5.64 TFLOP a pass (5.15 in the blocks' linear
    layers over the 4,096 real tokens, 0.47 in attention, 0.02 in the patch
    and neck convolutions); the windows' padding to 70x70 is not counted."""
    assert 5.6e12 < sam_counts.encoder_ops(1024, "vit_h") < 5.7e12


def test_spans_and_counters_when_on(narrow_generator):
    gen = narrow_generator
    depth, mask, nrm = depth_scene()
    trace.enable("cpu")
    trace.reset()
    try:
        PS.segment_depth_sam(depth, mask, nrm, seg_cfg(), allow_random_weights=True, device="cpu")
        rep = trace.report()
        records = trace.records()
    finally:
        trace.disable()
        trace.reset()
    spans, counts = rep["spans"], rep["counters"]
    assert spans["sam.generate"]["n"] == spans["sam.encode"]["n"] == spans["sam.filter"]["n"] == 2
    assert spans["sam.decode"]["n"] == 2 * 1024 // 64
    assert spans["sam.paint"]["n"] == 1
    parents = {r["name"]: r["parent"] for r in records}
    assert parents["sam.encode"] == parents["sam.filter"] == "sam.generate"
    assert parents["sam.decode"] in ("sam.generate", "sam.filter")
    assert counts["sam.prompts"] == 2 * 1024
    kept = counts["sam.masks_kept"]
    assert kept > 0
    # Per call: 1,024 prompts x 3 masks x 32 x 32 float32 logits, their IoU
    # and stability (float32 each), then each kept mask at full size (bool).
    assert counts["sam.host_bytes"] == 2 * 1024 * 3 * 32 * 32 * 4 + 2 * 1024 * 3 * 4 * 2 + kept * H * W


def test_off_records_nothing_and_gives_the_same_labels(narrow_generator, monkeypatch):
    gen = narrow_generator
    depth, mask, nrm = depth_scene()
    trace.enable("cpu")
    trace.reset()
    on = PS.segment_depth_sam(depth, mask, nrm, seg_cfg(), allow_random_weights=True, device="cpu")
    trace.disable()
    trace.reset()
    made = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: made.append(a))
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(a))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        off = PS.segment_depth_sam(depth, mask, nrm, seg_cfg(), allow_random_weights=True, device="cpu")
    assert not made
    rep = trace.report()
    assert rep["spans"] == {} and rep["counters"] == {}
    np.testing.assert_array_equal(on, off)
    assert len(gen.calls) == 4


def test_region_counters(narrow_generator):
    """``init.regions`` counts the regions after the merge, image after
    image; ``init.regions_dropped`` those with too few SfM points to fit:
    with the merge off and every SfM point inside the largest region, all
    regions but that one."""
    depth, mask, nrm = depth_scene()
    seg = seg_cfg(merge_min_sfm_points=0, merge_gradient_threshold=0.0)
    labels = PS.segment_depth_sam(depth, mask, nrm, seg, allow_random_weights=True, device="cpu")
    n_regions = len(np.unique(labels))
    assert n_regions >= 2
    ys, xs = np.nonzero(labels == np.bincount(labels.ravel()).argmax())
    pick = np.random.default_rng(5).choice(len(ys), 40, replace=False)
    pix = np.stack([xs[pick] + 0.5, ys[pick] + 0.5], -1).astype(np.float32)
    gt = depth[ys[pick], xs[pick]] * 2.0
    trace.enable("cpu")
    trace.reset()
    try:
        _, amask = align_depth(depth, mask, pix, gt, np.ones(40, bool), DepthAlignmentConfig(segmentation=seg),
                               generator=torch.Generator().manual_seed(0), device="cpu", normals=nrm)
        counts = trace.report()["counters"]
    finally:
        trace.disable()
        trace.reset()
    assert counts["init.regions"] == n_regions
    assert counts["init.regions_dropped"] == n_regions - 1
    assert amask.any() and not amask.all()
