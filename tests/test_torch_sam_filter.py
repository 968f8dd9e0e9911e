"""The SAM mask generator's filters on the card (``mdi/segmentation_sam.py``):
the IoU and stability filters and the low-res boxes computed on the device
where the decoder's logits are, one copy of them a call, NMS on the host and
its survivors upsampled on the device.

A narrow SAM (width 64, 4 blocks of 4 heads) at 128 px with random weights,
its filters at -inf and its box NMS at 0.95, so that every mask reaches NMS
and several survive it: the generator's masks equal, to the bit, those of
the benchmark's reference (``benchmark/reference/mdi/sam_amg.py``) on the
logits the decoder gave, and those of the same generator on the CPU fed the
card's decoder outputs. At the default filters a call copies its scores and
boxes to the host once, under 100 KB.

This module imports no JAX, so that it runs on a machine without it:
``python -m pytest -m card tests/test_torch_sam_filter.py``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from benchmark.reference.mdi import sam_amg as A  # noqa: E402
from gs_init_tpu_torch import trace  # noqa: E402
from gs_init_tpu_torch.mdi import segmentation_sam as PS  # noqa: E402

NARROW = dict(dim=64, depth=4, num_heads=4, global_attn_indexes=(1, 3))
H, W = 48, 72
NHW = (85, 128)  # the image's valid size at 128 px
EVERY_MASK = dict(pred_iou_thresh=-np.inf, stability_score_thresh=-np.inf, box_nms_thresh=0.95)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the filters' device path is the card's")
    return torch.device("cuda", 0)


def image():
    """A viridis image of slanted planes, as ``segment_depth_sam`` makes."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = np.where(xs < W / 3, 0.2 + 0.01 * ys, np.where(ys < H / 2, 0.9 - 0.01 * xs, 0.4 + 0.01 * ys))
    return (255.0 * PS.viridis_rgb(depth)).astype(np.uint8)


def generator(monkeypatch, device, **kw):
    """The narrow generator on ``device``; its ``outputs`` list gets each
    decoder call's multimask logits and IoU predictions."""
    monkeypatch.setitem(PS.SAM_VARIANTS, "vit_b", NARROW)
    gen = PS.SamMaskGenerator(variant="vit_b", img_size=128, allow_random_weights=True, device=device, **kw)
    gen.outputs = []
    gen.net.mask_decoder.register_forward_hook(lambda m, i, o: gen.outputs.append(o))
    return gen


def assert_same_masks(got, want, scores=True):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["segmentation"], b["segmentation"])
        assert a["area"] == b["area"]
        if scores:
            assert a["predicted_iou"] == b["predicted_iou"] and a["stability_score"] == b["stability_score"]


@pytest.mark.card
def test_masks_equal_the_reference_and_the_cpu_on_the_card(monkeypatch):
    dev = _card()
    gen = generator(monkeypatch, dev, **EVERY_MASK)
    got = gen.generate(image())
    assert len(gen.outputs) == 1024 // 64 and len(got) > 1  # 16 decoder calls; NMS kept several masks
    logits = torch.cat([o[0][:, 1:] for o in gen.outputs])
    iou = torch.cat([o[1][:, 1:] for o in gen.outputs])
    want = A.masks_from_logits(logits, iou, (H, W), NHW, dev, pred_iou_thresh=-np.inf, stability_thresh=-np.inf,
                               nms_thresh=EVERY_MASK["box_nms_thresh"])
    assert_same_masks(got, want, scores=False)
    # The same weights on the CPU, its decoder giving the card's outputs.
    cpu = generator(monkeypatch, "cpu", **EVERY_MASK)
    cpu.net.load_state_dict({k: v.cpu() for k, v in gen.net.state_dict().items()})
    card_outputs = iter([(m.cpu(), q.cpu()) for m, q in gen.outputs])
    cpu.net.mask_decoder.register_forward_hook(lambda m, i, o: next(card_outputs))
    assert_same_masks(got, cpu.generate(image()))


@pytest.mark.card
def test_one_small_copy_a_call_at_the_default_filters(monkeypatch):
    dev = _card()
    gen = generator(monkeypatch, dev)
    copies = []
    to_host = PS._to_host
    monkeypatch.setattr(PS, "_to_host", lambda t: copies.append(t.shape) or to_host(t))
    trace.enable(dev)
    trace.reset()
    try:
        masks = gen.generate(image())
        counts = trace.report()["counters"]
    finally:
        trace.disable()
        trace.reset()
    assert len(gen.outputs) == 16
    # The scores and boxes of the 3,072 masks, then NMS's survivors at full
    # size in one copy if any mask passed the filters.
    assert copies[0] == (1024 * 3, 7) and all(c[1:] == (H, W) for c in copies[1:]) and len(copies) <= 2
    assert len(copies) == 1 or counts["sam.masks_passed"] > 0
    assert counts["sam.masks_kept"] == len(masks)
    assert counts["sam.host_bytes"] < 100_000
