"""The port's Depth Pro (``models/depth_pro.py``,
``mdi/predictors/apple_depth_pro.py``) against the benchmark's plain
reference (``benchmark/reference/depthnet/depth_pro.py``) on seeded random
weights, on the CPU; the reference against transformers'
``DepthProForDepthEstimation``; the operation count
(``benchmark/counts/depth_pro.py``) against a hand count; and the Depth Pro
spans and counter of ``trace.py``.

A narrow Depth Pro with the published structure (width 64, 4 blocks of 4
heads, 16-px patches in 64-px crops, input 256: 3 scales cut into 1 + 9 + 25
crops, the published ratios, overlaps and merge padding; hooks at blocks 2
and 1): the head's pre-activation and the inverse depth within 1e-5 of each
one's largest value. Both sides run the same float32 operations but sum in
other orders (scaled-dot-product attention against an explicit softmax,
the merge by slices against a gather): measured 5e-7 to 1.2e-6 here, while a
merge without the overlap cropped or the hooks exchanged is off by 0.4-1.1.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from benchmark.counts import depth_pro as counts  # noqa: E402
from benchmark.reference.depthnet import depth_pro as R  # noqa: E402
from gs_init_tpu_torch import trace  # noqa: E402
from gs_init_tpu_torch.mdi.predictors import apple_depth_pro as pdp  # noqa: E402
from gs_init_tpu_torch.mdi.predictors.interface import CameraIntrinsics  # noqa: E402
from gs_init_tpu_torch.models import depth_pro as P  # noqa: E402
from gs_init_tpu_torch.models.common import build, init_random_  # noqa: E402

NARROW = dict(vit_dim=64, vit_depth=4, vit_heads=4, vit_image_size=64, vit_patch=16, fusion=16,
              intermediate_hook_ids=(2, 1), intermediate_feature_dims=(16, 16),
              scaled_images_ratios=(0.25, 0.5, 1.0), scaled_images_overlap_ratios=(0.0, 0.5, 0.25),
              scaled_images_feature_dims=(64, 64, 32), merge_padding_value=3)
SIZE = 256
TOL = 1e-5


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def narrow_pair(seed):
    port = init_random_(build(P.DepthProNet, **NARROW), seed).eval()
    return port, R.reference_net(port.state_dict(), "cpu", NARROW)


def port_pre(net, x):
    """The port's (inverse depth, head pre-activation) of x."""
    got = {}
    h = net.head.layers[-2].register_forward_hook(lambda m, i, o: got.__setitem__("pre", o[:, 0]))
    try:
        with torch.no_grad():
            inv, _ = net(x)
    finally:
        h.remove()
    return inv, got["pre"]


def image(seed, h=40, w=60):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def test_the_state_dicts_have_one_layout():
    with torch.device("meta"):
        port, ref = P.DepthProNet(), R.DepthProNet(**R.PUBLISHED)
    shapes = lambda n: {k: tuple(v.shape) for k, v in n.state_dict().items()}
    assert shapes(port) == shapes(ref)
    assert sum(v.numel() for v in port.state_dict().values()) == 646_551_617


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_network_matches_the_reference(seed):
    port, ref = narrow_pair(seed)
    x = torch.randn(1, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(seed + 10))
    inv, pre = port_pre(port, x)
    with torch.no_grad():
        r_inv, r_pre = ref(x)
    assert 0.05 < float((r_pre > 0).float().mean()) < 0.95  # the ReLU leaves some of the map on either side
    assert rel(pre, r_pre) < TOL
    assert rel(inv, r_inv) < TOL


@pytest.mark.parametrize("fault", ["merge_no_crop", "hooks_swapped"])
def test_a_fault_in_the_reference_is_seen(fault):
    port, ref = narrow_pair(3)
    x = torch.randn(1, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(13))
    _, pre = port_pre(port, x)
    if fault == "merge_no_crop":
        ref.merge_padding_value = 0
    else:
        ref.hook_ids = ref.hook_ids[::-1]
    with torch.no_grad():
        _, r_pre = ref(x)
    assert rel(pre, r_pre) > 100 * TOL


def test_predictor_matches_the_reference():
    """The port's predictor (the square resize, the network, the resize back,
    the depth from the focal length) on a 40x60 image against ``predict``."""
    pred = pdp.AppleDepthProPredictor(allow_random_weights=True, input_size=SIZE, device="cpu", seed=4, **NARROW)
    ref = R.reference_net(pred.net.state_dict(), "cpu", NARROW)
    img = image(5)
    fx, fy = 51.0, 53.0
    got = pred.predict_depth(img.astype(np.float32) / 255.0, CameraIntrinsics(fx=fx, fy=fy, cx=30.0, cy=20.0))
    depth, inv, _ = R.predict(ref, img, 0.5 * (fx + fy), "cpu", SIZE)
    assert got.depth.shape == (40, 60) and got.mask.all()
    assert float((inv > 0).float().mean()) > 0.05
    assert rel(torch.as_tensor(got.depth), depth) < TOL


def test_reference_matches_transformers():
    """transformers' DepthProForDepthEstimation at ``test_depth_pro_parity``'s
    tiny shape (224 input, 56-px crops of 14-px patches) with weights of
    variance 1 / fan_in, so that every level reaches the head: the
    reference with transformers' own resizes (``interp="torch"``) gives its
    pre-activation within 1e-5 (measured 5.3e-7); with the port's
    antialiased resizes it is off by ~0.2, the departure its docstring
    notes."""
    transformers = pytest.importorskip("transformers")
    sys.path.insert(0, str(REPO / "tests"))
    from test_depth_pro_parity import _tiny_config

    model = transformers.DepthProForDepthEstimation(_tiny_config(False)).eval()
    g = torch.Generator().manual_seed(15)
    mods = dict(model.named_modules())
    sd = {}
    for k, v in model.state_dict().items():
        mod = mods[k.rsplit(".", 1)[0]]
        if v.ndim > 1:
            fan = v.shape[0] * v.shape[2] * v.shape[3] if isinstance(mod, nn.ConvTranspose2d) else v[0].numel()
            sd[k] = torch.randn(v.shape, generator=g) / fan**0.5
        else:
            sd[k] = (0.0 if k.endswith("bias") else 1.0) + 0.1 * torch.randn(v.shape, generator=g)
    model.load_state_dict(sd)
    widths = dict(vit_dim=32, vit_depth=2, vit_heads=2, vit_image_size=56, vit_patch=14, fusion=16,
                  intermediate_hook_ids=(1, 0), intermediate_feature_dims=(16, 16),
                  scaled_images_ratios=(0.25, 0.5, 1.0), scaled_images_overlap_ratios=(0.0, 0.5, 0.25),
                  scaled_images_feature_dims=(32, 32, 16), merge_padding_value=3)
    got = {}
    model.head.layers[4].register_forward_hook(lambda m, i, o: got.__setitem__("pre", o[:, 0]))
    x = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(3))
    rsd = R.hf_state_dict(sd, 2)
    gaps = {}
    with torch.no_grad():
        out = model(x)
        for interp in ("torch", "jax"):
            with torch.device("meta"):
                ref = R.DepthProNet(**widths, interp=interp)
            ref.load_state_dict(rsd, assign=True)
            inv, pre = ref.eval()(x)
            gaps[interp] = rel(pre, got["pre"])
            if interp == "torch":
                assert rel(inv, out.predicted_depth) < TOL
    assert gaps["torch"] < TOL
    assert gaps["jax"] > 1e-2


def test_count_against_a_hand_count():
    """Each linear 2 in out a token, each attention 4 N^2 D, each convolution
    2 (in k^2) an output element, each transposed one 2 (out k^2) an input
    element, at the narrow widths on a 256 input (35 crops of 17 tokens; the
    levels at 8, 16, 32, 64 and 128 pixels)."""
    d, t = 64, 17
    vit = 2 * 768 * d * 16 + 4 * (2 * 12 * d * d * t + 4 * t * t * d)  # a crop: the patch convolution, 4 blocks
    conv = lambda cin, cout, k, s: 2 * cout * s * s * cin * k * k
    up = lambda cin, cout, s: 2 * cin * s * s * cout * 4  # a transposed convolution x2 on an s x s input
    neck = (up(64, 64, 4)  # the image features
            + conv(64, 64, 1, 4) + up(64, 64, 4) + conv(64, 64, 1, 8) + up(64, 64, 8)
            + conv(64, 32, 1, 16) + up(32, 32, 16)  # the three scales
            + conv(64, 16, 1, 16) + up(16, 16, 16) + up(16, 16, 32)  # the hooks
            + conv(64, 16, 1, 16) + up(16, 16, 16) + up(16, 16, 32) + up(16, 16, 64)
            + conv(128, 64, 1, 8)  # the fuse
            + conv(64, 16, 3, 8) + conv(64, 16, 3, 16) + conv(32, 16, 3, 32) + conv(16, 16, 3, 64))
    unit = lambda s: 2 * conv(16, 16, 3, s)
    fusion = (unit(8) + up(16, 16, 8) + conv(16, 16, 1, 16)
              + sum(2 * unit(s) + up(16, 16, s) + conv(16, 16, 1, 2 * s) for s in (16, 32, 64))
              + 2 * unit(128) + conv(16, 16, 1, 128))
    head = conv(16, 8, 3, 128) + up(8, 8, 128) + conv(8, 32, 3, 256) + conv(32, 1, 1, 256)
    got = counts.ops(SIZE, NARROW)
    assert got["patch_encoder"] == 35 * vit
    assert got["total"] == 36 * vit + neck + fusion + head


def test_published_count():
    """1536 px at the published widths: 18.86 TFLOP a pass, 13.37 of them the
    35 crops through the patch encoder."""
    got = counts.ops()
    assert 18.8e12 < got["total"] < 18.9e12
    assert 13.3e12 < got["patch_encoder"] < 13.4e12


def test_spans_and_counter_when_on():
    pred = pdp.AppleDepthProPredictor(allow_random_weights=True, input_size=SIZE, device="cpu", seed=6, **NARROW)
    intr = CameraIntrinsics(fx=50.0, fy=50.0, cx=30.0, cy=20.0)
    img = image(7).astype(np.float32) / 255.0
    trace.enable("cpu")
    trace.reset()
    try:
        on = pred.predict_depth_batch(np.stack([img, img]), [intr, intr])
        rep = trace.report()
        records = trace.records()
    finally:
        trace.disable()
        trace.reset()
    spans, counts_ = rep["spans"], rep["counters"]
    assert counts_ == {"depth_pro.crops": 2 * 35}  # one pass of a batch of two
    assert spans["depth_pro.predict"]["n"] == 1
    for name in ("depth_pro.patch_encode", "depth_pro.image_encode", "depth_pro.decode"):
        assert spans[name]["n"] == 1
    assert spans["depth_pro.merge"]["n"] == 2  # the crops cut, then the grids merged
    parents = {r["name"]: r["parent"] for r in records}
    assert {parents[n] for n in spans if n != "depth_pro.predict"} == {"depth_pro.predict"}
    off = pred.predict_depth_batch(np.stack([img, img]), [intr, intr])
    assert trace.report()["spans"] == {}
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a.depth, b.depth)
