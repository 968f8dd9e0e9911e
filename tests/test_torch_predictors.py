"""Parity: the port's depth predictors (``gs_init_tpu_torch/mdi/predictors/``)
against the JAX package's, end to end on the same images and the same
random flax variables carried across; both checkpoint routes on one
synthetic upstream-shaped state dict; the safetensors reader; ``pick_model``;
a CPU Runner whose monocular-depth init runs Metric3D with random weights.

The JAX nets' ``init`` is replaced in these tests by
``torch_parity.random_flax_variables`` (shapes from ``jax.eval_shape``,
values from numpy): flax's own initialisers take tens of seconds op by op.

Tolerances. Predictors: Metric3D, DA-V2 and DepthPro depth and confidence
within 2e-5 of each output's max |value|, normals within 2e-5 abs (unit
vectors): Metric3D small runs a 12-layer ViT over 3,349 tokens, four GRU
iterations and the resizes in float32, with sums in other orders
(measured here: 3.3e-6 for its depth, 2.7e-6 for its normals, 1.9e-6 for
DA-V2). MoGe-2 and UniDepth within 1e-4 (measured up to 2.2e-5 with
their ViT-S over ~1,800 tokens; here a 300-token budget, for speed).
Masks equal away from their threshold. Checkpoint routes: each output
within 1e-4 of its max (the same nets on the same weights). The
safetensors reader: bit-exact.
"""
import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from gs_init_tpu.mdi.predictors import apple_depth_pro as jdp
from gs_init_tpu.mdi.predictors import depth_anything_v2 as jdav2
from gs_init_tpu.mdi.predictors import metric3d as jm3d
from gs_init_tpu.mdi.predictors import metric3d_convert as jm3dc
from gs_init_tpu.mdi.predictors import moge as jmoge
from gs_init_tpu.mdi.predictors import moge_convert as jmogec
from gs_init_tpu.mdi.predictors import unidepth as juni
from gs_init_tpu.mdi.predictors import unidepth_convert as junic
from gs_init_tpu.mdi.predictors.interface import CameraIntrinsics as JIntr
from gs_init_tpu.models import depth_pro as jdpm
from gs_init_tpu.models import moge as jmogem
from gs_init_tpu.models import unidepth as junim
from gs_init_tpu_torch.config import Config
from gs_init_tpu_torch.mdi.predictors import apple_depth_pro as dp
from gs_init_tpu_torch.mdi.predictors import depth_anything_v2 as dav2
from gs_init_tpu_torch.mdi.predictors import interface, metric3d, metric3d_convert
from gs_init_tpu_torch.mdi.predictors import moge, moge_convert, unidepth, unidepth_convert
from gs_init_tpu_torch.mdi.predictors.interface import CameraIntrinsics
from gs_init_tpu_torch.models import depth_pro, dpt, raft_dpt, vit
from gs_init_tpu_torch.models import moge as moge_model
from gs_init_tpu_torch.models import unidepth as unidepth_model
from gs_init_tpu_torch.models.common import build, carry_plan
from torch_parity import CPU, assert_close_scaled, carry, n, random_flax_variables, t


@pytest.fixture
def no_checkpoints(tmp_path, monkeypatch):
    """No checkpoint anywhere the predictors look (either package)."""
    monkeypatch.setenv("GS_TPU_CHECKPOINT_DIR", str(tmp_path / "none"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path)


@pytest.fixture
def fast_jax_init(monkeypatch):
    """Replace a JAX net class's flax init by numpy-drawn random variables."""

    def patch(cls, seed=0):
        def init(self, rng, *args, **kw):
            return random_flax_variables(self, *args, seed=seed)

        monkeypatch.setattr(cls, "init", init)

    return patch


def test_metric3d_predictor_matches_jax(no_checkpoints, fast_jax_init):
    """Metric3D small at its fixed 616x1064 crop: a 30x44 image goes up into
    the crop (antialiasing idle) and its outputs come down again
    (antialiased)."""
    fast_jax_init(jm3d.Metric3DNet, seed=1)
    jpred = jm3d.Metric3DPredictor(backbone="small", allow_random_weights=True)
    pred = metric3d.Metric3DPredictor(backbone="small", allow_random_weights=True, device=CPU)
    carry(pred.net, metric3d_convert.state_dict_from_flax(jpred.variables))
    imgs = np.random.default_rng(0).uniform(0, 1, (1, 30, 44, 3)).astype(np.float32)
    want = jpred.predict_depth_batch(imgs, [JIntr(fx=100.0, fy=100.0, cx=22.0, cy=15.0)])[0]
    got = pred.predict_depth_batch(imgs, [CameraIntrinsics(fx=100.0, fy=100.0, cx=22.0, cy=15.0)])[0]
    assert got.depth.shape == (30, 44) and got.normal.shape == (30, 44, 3)
    assert np.ptp(want.depth) > 1e-3 * want.depth.max()  # the weights give a non-trivial map
    assert_close_scaled(got.depth, want.depth, 2e-5)
    assert_close_scaled(got.depth_confidence, want.depth_confidence, 2e-5)
    assert_close_scaled(got.normal_confidence, want.normal_confidence, 2e-5)
    np.testing.assert_allclose(got.normal, want.normal, atol=2e-5)
    np.testing.assert_allclose(np.linalg.norm(got.normal, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(got.mask, want.mask)


@pytest.mark.parametrize("metric", [False, True])
def test_dav2_predictor_matches_jax(no_checkpoints, fast_jax_init, metric):
    """DA-V2 vits at input_size 56: 40x60 images go up to 56x84 (a 4x6 patch
    grid: the pos embeddings' antialiased bicubic downscale from 37x37) and
    come back down (antialiased). Relative (1/(d + 1e-6)) and metric
    (outdoor: sigmoid * 80)."""
    fast_jax_init(jdav2.DepthAnythingV2Net, seed=2)
    kw = dict(backbone="vits", metric=metric, variant="outdoor", input_size=56)
    jpred = jdav2.DepthAnythingV2Predictor(**kw)
    pred = dav2.DepthAnythingV2Predictor(**kw, allow_random_weights=True, device=CPU)
    carry(pred.net, dav2.state_dict_from_flax(jpred.variables))
    imgs = np.random.default_rng(1).uniform(0, 1, (2, 40, 60, 3)).astype(np.float32)
    for g, w in zip(pred.predict_depth_batch(imgs, [None, None]),
                    jpred.predict_depth_batch(imgs, [None, None])):
        assert g.depth.shape == (40, 60)
        if metric:
            assert_close_scaled(g.depth, w.depth, 2e-5)
            np.testing.assert_array_equal(g.mask, w.mask)
        else:  # compare the disparities; masks agree away from d = 1e-4
            gd, wd = 1.0 / g.depth - 1e-6, 1.0 / w.depth - 1e-6
            assert w.mask.mean() > 0.2
            assert_close_scaled(gd, wd, 2e-5)
            far = np.abs(wd - 1e-4) > 2e-5 * np.abs(wd).max()
            np.testing.assert_array_equal(g.mask[far], w.mask[far])


@pytest.fixture
def small_token_budget(monkeypatch):
    """MoGe-2 and UniDepth size their input for ~1,800 ViT tokens; 300 here
    (both packages read the budget when they predict), for speed."""
    for mod in (jmoge, juni, moge):
        monkeypatch.setattr(mod, "TARGET_TOKENS", 300)


def test_moge_predictor_matches_jax(no_checkpoints, fast_jax_init, small_token_budget):
    """MoGe-2 vits: 48x64 images resized to the token budget (up) and the
    depth, mask logit and normals resized back (down, antialiased)."""
    fast_jax_init(jmogem.MoGeModel, seed=3)
    jpred = jmoge.MoGePredictor(backbone="vits", allow_random_weights=True)
    pred = moge.MoGePredictor(backbone="vits", allow_random_weights=True, device=CPU)
    carry(pred.net, moge_convert.state_dict_from_flax(jpred.variables))
    imgs = np.random.default_rng(2).uniform(0, 1, (2, 48, 64, 3)).astype(np.float32)
    for g, w in zip(pred.predict_depth_batch(imgs, [None, None]), jpred.predict_depth_batch(imgs, [None, None])):
        assert g.depth.shape == (48, 64) and g.normal.shape == (48, 64, 3)
        assert_close_scaled(g.depth, w.depth, 1e-4)
        np.testing.assert_allclose(g.normal, w.normal, atol=1e-4)
        np.testing.assert_array_equal(g.mask, w.mask)
        assert 0 < w.mask.mean() < 1  # the mask logit takes both signs


def test_unidepth_predictor_matches_jax(no_checkpoints, fast_jax_init, small_token_budget):
    """UniDepth-v2 vits, conditioned on two cameras and, without
    intrinsics, on its own camera head's; the intrinsics change the depth."""
    fast_jax_init(junim.UniDepthModel, seed=4)
    jpred = juni.UniDepthPredictor(backbone="vits", allow_random_weights=True)
    pred = unidepth.UniDepthPredictor(backbone="vits", allow_random_weights=True, device=CPU)
    carry(pred.net, unidepth_convert.state_dict_from_flax(jpred.variables))
    imgs = np.random.default_rng(3).uniform(0, 1, (2, 48, 64, 3)).astype(np.float32)
    cams = [CameraIntrinsics(60.0, 60.0, 32.0, 24.0), CameraIntrinsics(200.0, 190.0, 30.0, 25.0)]
    for intr in (cams, [None, None]):
        got = pred.predict_depth_batch(imgs, intr)
        want = jpred.predict_depth_batch(imgs, [None if c is None else JIntr(*c) for c in intr])
        for g, w in zip(got, want):
            assert g.depth.shape == (48, 64)
            assert_close_scaled(g.depth, w.depth, 1e-4)
            assert_close_scaled(g.depth_confidence, w.depth_confidence, 1e-4)
            np.testing.assert_array_equal(g.mask, w.mask)
    same = pred.predict_depth_batch(imgs[:1].repeat(2, 0), cams)
    assert np.abs(same[0].depth - same[1].depth).max() > 1e-3 * same[0].depth.max()


def test_depth_pro_predictor_matches_jax(no_checkpoints, fast_jax_init):
    """DepthPro at tiny widths with the FOV branch, input 224: 40x60 images
    up to the square, the inverse depth back down; the focal length from
    the intrinsics for one image and from the FOV branch for the other."""
    from test_torch_models import TINY_DEPTH_PRO

    fast_jax_init(jdpm.DepthProNet, seed=5)
    kw = dict(TINY_DEPTH_PRO, use_fov=True, input_size=224, allow_random_weights=True)
    jpred = jdp.AppleDepthProPredictor(**kw)
    pred = dp.AppleDepthProPredictor(**kw, device=CPU)
    carry(pred.net, dp.state_dict_from_flax(jpred.variables))
    imgs = np.random.default_rng(4).uniform(0, 1, (2, 40, 60, 3)).astype(np.float32)
    intr = [CameraIntrinsics(50.0, 54.0, 30.0, 20.0), None]
    got = pred.predict_depth_batch(imgs, intr)
    want = jpred.predict_depth_batch(imgs, [JIntr(*intr[0]), None])
    for g, w in zip(got, want):
        assert g.depth.shape == (40, 60) and g.mask.all()
        assert_close_scaled(g.depth, w.depth, 2e-5)


# ------------------------------------------------------------- checkpoints


def upstream_state_dict(net: torch.nn.Module, seed: int) -> dict:
    """Random tensors for every parameter of a port net, under the port's
    names (which are the official checkpoints'): weights normal with
    variance 1/fan_in, norm scales and LayerScale 1 + normal(0, 0.1),
    biases normal(0, 0.1), tokens and position embeddings normal(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in net.state_dict().items():
        r = torch.randn(v.shape, generator=g)
        leaf = k.rsplit(".", 1)[-1]
        if v.ndim >= 2 and leaf == "weight":
            r = r / np.sqrt(np.prod(v.shape[1:]))
        elif leaf in ("weight", "gamma"):
            r = 1.0 + 0.1 * r
        elif leaf == "bias":
            r = 0.1 * r
        out[k] = r
    return out


def test_metric3d_checkpoint_both_routes(tmp_path):
    """An official-layout Metric3D small checkpoint (``module.depth_model.``
    wrapper, chunked ViT blocks, a mask token the net does not read, under
    ``model_state_dict``) through the JAX converter into flax and through the
    port's loader: the two nets agree."""
    net = build(metric3d.Metric3DNet, "small")
    sd = {}
    for k, v in upstream_state_dict(net, seed=3).items():
        k = k.replace("encoder.blocks.", "encoder.blocks.0.")
        sd["module.depth_model." + k] = v
    sd["module.depth_model.encoder.mask_token"] = torch.zeros(1, 384)
    path = str(tmp_path / "metric_depth_vit_small_800k.pth")
    torch.save({"model_state_dict": sd}, path)

    x = np.random.default_rng(4).normal(size=(1, 56, 84, 3)).astype(np.float32)
    jnet = jm3d.Metric3DNet(backbone="small")
    jvars = jm3dc.load_metric3d_weights(path, random_flax_variables(jnet, x), "small")
    jd, jc, jn = jax.jit(jnet.apply)(jvars, x)
    metric3d_convert.load_metric3d_weights(net, path)
    with torch.no_grad():
        d, c, nrm = net.eval()(t(np.moveaxis(x, -1, 1)))
    assert_close_scaled(d, jd, 1e-4)
    assert_close_scaled(c, jc, 1e-4)
    assert_close_scaled(np.moveaxis(n(nrm), 1, -1), jn, 1e-4)
    # A missing or misshapen parameter is refused, as the JAX loader refuses it.
    del sd["module.depth_model.decoder.update_block.mask.2.bias"]
    with pytest.raises(ValueError, match="missing"):
        metric3d_convert.load_metric3d_state_dict(net, sd)


def hf_layout(sd: dict) -> dict:
    """The official DA-V2 state dict in HuggingFace's layout
    (DepthAnythingForDepthEstimation), as numpy."""
    out = {"backbone.embeddings.cls_token": sd["pretrained.cls_token"],
           "backbone.embeddings.position_embeddings": sd["pretrained.pos_embed"],
           "backbone.embeddings.mask_token": torch.zeros(1, 384)}
    for leaf in ("weight", "bias"):
        out[f"backbone.embeddings.patch_embeddings.projection.{leaf}"] = sd[f"pretrained.patch_embed.proj.{leaf}"]
        out[f"backbone.layernorm.{leaf}"] = sd[f"pretrained.norm.{leaf}"]
    for i in range(12):
        s, b = f"pretrained.blocks.{i}", f"backbone.encoder.layer.{i}"
        for leaf in ("weight", "bias"):
            for name, part in zip(("query", "key", "value"), sd[f"{s}.attn.qkv.{leaf}"].chunk(3, 0)):
                out[f"{b}.attention.attention.{name}.{leaf}"] = part
            out[f"{b}.attention.output.dense.{leaf}"] = sd[f"{s}.attn.proj.{leaf}"]
            for m in ("norm1", "norm2", "mlp.fc1", "mlp.fc2"):
                out[f"{b}.{m}.{leaf}"] = sd[f"{s}.{m}.{leaf}"]
        out[f"{b}.layer_scale1.lambda1"] = sd[f"{s}.ls1.gamma"]
        out[f"{b}.layer_scale2.lambda1"] = sd[f"{s}.ls2.gamma"]
    dh, ra = "depth_head", "neck.reassemble_stage.layers"
    ren = {f"{dh}.projects.{i}": f"{ra}.{i}.projection" for i in range(4)}
    ren |= {f"{dh}.resize_layers.{i}": f"{ra}.{i}.resize" for i in (0, 1, 3)}
    ren |= {f"{dh}.scratch.layer{i + 1}_rn": f"neck.convs.{i}" for i in range(4)}
    for i, rf in enumerate((4, 3, 2, 1)):
        for u in (1, 2):
            for c in (1, 2):
                ren[f"{dh}.scratch.refinenet{rf}.resConfUnit{u}.conv{c}"] = (
                    f"neck.fusion_stage.layers.{i}.residual_layer{u}.convolution{c}")
        ren[f"{dh}.scratch.refinenet{rf}.out_conv"] = f"neck.fusion_stage.layers.{i}.projection"
    ren |= {f"{dh}.scratch.output_conv1": "head.conv1", f"{dh}.scratch.output_conv2.0": "head.conv2",
            f"{dh}.scratch.output_conv2.2": "head.conv3"}
    for k, v in sd.items():
        mod, leaf = k.rsplit(".", 1)
        if mod in ren:
            out[f"{ren[mod]}.{leaf}"] = v
    return {k: n(v) for k, v in out.items()}


@pytest.mark.parametrize("layout", ["official", "hf"])
def test_dav2_checkpoint_both_routes(tmp_path, no_checkpoints, layout):
    """One official-layout DA-V2 vits state dict (with the mask token and the
    deepest fusion block's unused first unit, as the official one has),
    written as a .pth, or in HuggingFace's layout as a .safetensors: the
    JAX converter into flax against the port's predictor loading the file."""
    safetensors_numpy = pytest.importorskip("safetensors.numpy")
    net = build(dav2.DepthAnythingV2Net, "vits")
    sd = upstream_state_dict(net, seed=5)
    sd["pretrained.mask_token"] = torch.zeros(1, 384)
    g = torch.Generator().manual_seed(6)
    for c in (1, 2):
        sd[f"depth_head.scratch.refinenet4.resConfUnit1.conv{c}.weight"] = torch.randn(64, 64, 3, 3, generator=g)
        sd[f"depth_head.scratch.refinenet4.resConfUnit1.conv{c}.bias"] = torch.randn(64, generator=g)
    if layout == "official":
        path = str(tmp_path / "depth_anything_v2_vits.pth")
        torch.save(sd, path)
        jvars = jdav2.convert_torch_checkpoint(sd, "vits")
    else:
        path = str(tmp_path / "depth_anything_v2_small_hf.safetensors")
        hf = hf_layout(sd)
        safetensors_numpy.save_file(hf, path)
        jvars = jdav2.convert_hf_checkpoint(hf, "vits")
    pred = dav2.DepthAnythingV2Predictor(backbone="vits", checkpoint=path, device=CPU)
    x = np.random.default_rng(7).normal(size=(2, 28, 42, 3)).astype(np.float32)
    want = jax.jit(jdav2.DepthAnythingV2Net(backbone="vits").apply)(jvars, x)
    with torch.no_grad():
        got = pred.net(t(np.moveaxis(x, -1, 1)))
    assert float(np.abs(want).max()) > 0
    assert_close_scaled(got, want, 1e-4)


@pytest.mark.parametrize("network", ["moge", "unidepth"])
def test_moge_unidepth_checkpoint_both_routes(tmp_path, network):
    """A state dict in the layout the JAX converters read (under a
    ``module.`` wrapper; UniDepth's fusion units spelled ``rcu1``/``rcu2``),
    through the JAX converter into flax and through the port's loader."""
    x = np.random.default_rng(13).normal(size=(1, 56, 84, 3)).astype(np.float32)
    if network == "moge":
        net, jnet = build(moge_model.MoGeModel, "vits"), jmogem.MoGeModel(backbone="vits")
        load, load_sd, jload = moge_convert.load_moge_weights, moge_convert.load_moge_state_dict, jmogec.load_moge_weights
        args = (x,)
    else:
        net, jnet = build(unidepth_model.UniDepthModel, "vits"), junim.UniDepthModel(backbone="vits")
        load, load_sd = unidepth_convert.load_unidepth_weights, unidepth_convert.load_unidepth_state_dict
        jload, args = junic.load_unidepth_weights, (x, None)
    sd = {"module." + k.replace("resConfUnit", "rcu"): v for k, v in upstream_state_dict(net, seed=14).items()}
    path = str(tmp_path / f"{network}_vits.pt")
    torch.save(sd, path)
    jvars = jload(path, random_flax_variables(jnet, *args), "vits")
    want = jax.jit(jnet.apply)(jvars, *args)
    load(net, path)
    with torch.no_grad():
        got = net.eval()(t(np.moveaxis(x, -1, 1)), *args[1:])
    for key in ("depth", "mask_logit") if network == "moge" else ("depth", "confidence"):
        assert_close_scaled(got[key], want[key], 1e-4)
    del sd[next(iter(sd))]
    with pytest.raises(ValueError, match="missing"):
        load_sd(net, sd)


def test_depth_pro_checkpoint_both_routes(tmp_path):
    """A HuggingFace DepthProForDepthEstimation (tiny config, FOV branch on)
    state dict as a .safetensors: the JAX converter into flax against the
    port's predictor loading the file. On these weights the head's final
    ReLU zeroes every pixel, so the depth path is compared before it: the
    last convolution's output (flax's captured ``head_4``, the port's
    ``head.layers[-2]``)."""
    transformers = pytest.importorskip("transformers")
    st_torch = pytest.importorskip("safetensors.torch")
    from test_depth_pro_parity import _tiny_config
    from test_torch_models import TINY_DEPTH_PRO

    torch.manual_seed(0)
    model = transformers.DepthProForDepthEstimation(_tiny_config(True)).eval()
    g = torch.Generator().manual_seed(15)
    sd = {k: 0.05 * torch.randn(v.shape, generator=g) if not k.endswith(("norm1.weight", "norm2.weight",
          "layernorm.weight", "lambda1")) else 1.0 + 0.1 * torch.randn(v.shape, generator=g)
          for k, v in model.state_dict().items()}
    path = str(tmp_path / "depth_pro_hf.safetensors")
    st_torch.save_file(sd, path)
    kw = dict(TINY_DEPTH_PRO, use_fov=True)
    x = np.random.default_rng(16).normal(size=(2, 224, 224, 3)).astype(np.float32)
    jnet = jdpm.DepthProNet(**kw)
    (jinv, jfov), state = jax.jit(lambda v, x: jnet.apply(
        v, x, capture_intermediates=lambda mdl, _: mdl.name == "head_4", mutable=["intermediates"]))(
        jdp.convert_depth_pro_checkpoint(sd, jnet), x)
    jpre = np.asarray(state["intermediates"]["head_4"]["__call__"][0])[..., 0]
    pred = dp.AppleDepthProPredictor(checkpoint=path, input_size=224, device=CPU, **kw)
    got = {}
    hook = pred.net.head.layers[-2].register_forward_hook(lambda m, i, o: got.__setitem__("pre", o[:, 0]))
    with torch.no_grad():
        inv, fov = pred.net(t(np.moveaxis(x, -1, 1)))
    hook.remove()
    assert np.abs(jpre).max() > 0 and np.ptp(jpre) > 0  # a map that varies, unlike the ReLU's zeros
    assert_close_scaled(got["pre"], jpre, 1e-4)
    assert_close_scaled(inv, jinv, 1e-4)
    assert_close_scaled(fov, jfov, 1e-4)


def test_safetensors_reader(tmp_path):
    st_numpy = pytest.importorskip("safetensors.numpy")
    st_torch = pytest.importorskip("safetensors.torch")
    rng = np.random.default_rng(8)
    arrays = {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "f16": rng.normal(size=(5,)).astype(np.float16),
        "f64": rng.normal(size=(2, 2, 2)),
        "i64": rng.integers(-9, 9, (4,)),
        "u8": rng.integers(0, 255, (2, 3)).astype(np.uint8),
        "bool": rng.uniform(size=(6,)) > 0.5,
        "scalar": np.array(2.5, np.float32),
    }
    st_numpy.save_file(arrays, str(tmp_path / "a.safetensors"), metadata={"format": "np"})
    got = dav2.read_safetensors(str(tmp_path / "a.safetensors"))
    assert sorted(got) == sorted(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v)
    bf = torch.randn(7, 3, generator=torch.Generator().manual_seed(9)).bfloat16()
    st_torch.save_file({"w": bf}, str(tmp_path / "b.safetensors"))
    got = dav2.read_safetensors(str(tmp_path / "b.safetensors"))["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, bf.float().numpy())


# ------------------------------------------------------- factory and errors


@pytest.mark.parametrize(
    "make",
    [
        lambda **kw: metric3d.Metric3DPredictor(backbone="small", **kw),
        lambda **kw: dav2.DepthAnythingV2Predictor(backbone="vits", **kw),
        lambda **kw: moge.MoGePredictor(backbone="vits", **kw),
        lambda **kw: unidepth.UniDepthPredictor(backbone="vits", **kw),
        lambda **kw: dp.AppleDepthProPredictor(**kw),
    ],
    ids=["metric3d", "depth_anything_v2", "moge", "unidepth", "depth_pro"],
)
def test_predictors_raise_without_checkpoint(no_checkpoints, monkeypatch, make):
    with pytest.raises(FileNotFoundError, match="allow_random_weights"):
        make(device=CPU)
    # The entry points default to the card and raise without one.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(allow_random_weights=True)


def test_metric3d_giant_has_no_decoder_preset():
    with pytest.raises(ValueError, match="giant"):
        metric3d.Metric3DNet("giant")  # as in the JAX package, whose RAFT_CONFIGS lack it


@pytest.mark.parametrize(
    "predictor,backbone,want",
    [
        ("metric3d", "vitl", ("Metric3DPredictor", "large")),  # the configuration's default
        ("metric3d", "vits", ("Metric3DPredictor", "small")),
        ("metric3d", "vitb", ("Metric3DPredictor", "small")),
        ("metric3d", "large", ("Metric3DPredictor", "large")),
        ("depth_anything_v2", "vits", ("DepthAnythingV2Predictor", "vits")),
        ("depth_anything_v2", "vitb", ("DepthAnythingV2Predictor", "vitb")),
        ("depth_anything_v2", "vitl", ("DepthAnythingV2Predictor", "vitl")),
        ("depth_anything_v2", "vitg", ("DepthAnythingV2Predictor", "vitg")),
        ("moge", "vitb", ("MoGePredictor", "vitb")),
        ("moge", "large", ("MoGePredictor", "vitl")),
        ("unidepth", "vits", ("UniDepthPredictor", "vits")),
        ("unidepth", "small", ("UniDepthPredictor", "vitl")),
        ("depth_pro", "vitl", ("AppleDepthProPredictor", None)),
    ],
)
def test_pick_model(monkeypatch, predictor, backbone, want):
    """pick_model's backbone mapping is the JAX package's; the predictor is
    built on the device asked for, with the config's seed and flags."""
    made = {}
    for mod, cls in ((metric3d, "Metric3DPredictor"), (dav2, "DepthAnythingV2Predictor"),
                     (moge, "MoGePredictor"), (unidepth, "UniDepthPredictor"),
                     (dp, "AppleDepthProPredictor")):
        monkeypatch.setattr(mod, cls, lambda cls=cls, **kw: made.update(cls=cls, **kw) or cls)
    cfg = Config(seed=11)
    cfg.mdi.predictor, cfg.mdi.backbone = predictor, backbone
    cfg.mdi.allow_random_weights = True
    assert interface.pick_model(cfg, device=CPU) == want[0]
    assert (made["cls"], made.get("backbone")) == want
    assert made["allow_random_weights"] and made["device"] == CPU and made["seed"] == 11
    if predictor == "depth_anything_v2":
        assert (made["metric"], made["variant"]) == (True, "indoor")


def test_pick_model_refuses_an_unknown_predictor():
    cfg = Config()
    cfg.mdi.predictor = "zoedepth"
    with pytest.raises(NotImplementedError, match="unknown predictor"):
        interface.pick_model(cfg, device=CPU)


@pytest.mark.parametrize(
    "net,flax_net,renames,transposed",
    [
        (lambda: metric3d.Metric3DNet("large"), lambda: jm3d.Metric3DNet(backbone="large"),
         vit.VIT_RENAMES + raft_dpt.RAFT_RENAMES, raft_dpt.RAFT_TRANSPOSED),
        *[(lambda b=b: dav2.DepthAnythingV2Net(b, metric=True),
           lambda b=b: jdav2.DepthAnythingV2Net(backbone=b, metric=True),
           vit.VIT_RENAMES + dpt.DPT_RENAMES, dpt.DPT_TRANSPOSED) for b in ("vitb", "vitl", "vitg")],
        (lambda: moge_model.MoGeModel("vitl"), lambda: jmogem.MoGeModel(backbone="vitl"),
         vit.VIT_RENAMES + moge_model.MOGE_RENAMES, ()),
        (lambda: unidepth_model.UniDepthModel("vitl"), lambda: junim.UniDepthModel(backbone="vitl"),
         vit.VIT_RENAMES + unidepth_model.UNIDEPTH_RENAMES, ()),
        # DepthPro-hf's ViT-L/16 (the JAX default's 14-px patch does not tile its 384 crop).
        (lambda: depth_pro.DepthProNet(use_fov=True), lambda: jdpm.DepthProNet(use_fov=True, vit_patch=16),
         vit.VIT_RENAMES + depth_pro.DEPTH_PRO_RENAMES, depth_pro.DEPTH_PRO_TRANSPOSED),
    ],
    ids=["metric3d-large", "dav2-vitb", "dav2-vitl", "dav2-vitg", "moge-vitl", "unidepth-vitl",
         "depth_pro-large-fov"],
)
def test_full_size_nets_have_the_reference_parameters(request, net, flax_net, renames, transposed):
    """Each preset the tests do not run here has every parameter of the JAX
    net under its carried-across name, with its shape (shapes only: neither
    side allocates its weights)."""
    side = 1536 if "depth_pro" in request.node.name else 56  # DepthPro's smallest input is 4 crops wide
    x = jax.ShapeDtypeStruct((1, side, side, 3), np.float32)
    args = (x, None) if "unidepth" in request.node.name else (x,)  # the camera head traced too
    shapes = jax.eval_shape(lambda *a: fnn.Module.init(flax_net(), jax.random.PRNGKey(0), *a), *args)
    carried = {k: tuple(leaf.shape[p] for p in perm)
               for k, (leaf, perm, _) in carry_plan(shapes, renames, transposed).items()}
    with torch.device("meta"):
        mine = {k: tuple(v.shape) for k, v in net().state_dict().items()}
    assert carried == mine


def test_reference_depth_pro_default_patch_does_not_tile_its_crop():
    """A fault of the JAX package (ROADMAP Queue C): DepthProNet's default
    ViT patch of 14 px does not tile its 384 crop, so its init fails at its
    own defaults; the port defaults to DepthPro-hf's 16 px (577 tokens)."""
    x = jax.ShapeDtypeStruct((1, 1536, 1536, 3), np.float32)
    with pytest.raises(TypeError, match="reshape"):
        jax.eval_shape(lambda x: fnn.Module.init(jdpm.DepthProNet(), jax.random.PRNGKey(0), x), x)
    with torch.device("meta"):
        net = depth_pro.DepthProNet()
    assert net.depth_pro.encoder.patch_encoder.model.pos_embed.shape == (1, 577, 1024)


# ------------------------------------------------------------- end to end


def test_runner_init_with_metric3d_random_weights(tmp_path, no_checkpoints):
    """pick_model -> Metric3D small with random weights -> predict (one batch
    of both training images at the full crop) -> align -> unproject ->
    train, on the CPU."""
    from gs_init_tpu_torch.datasets.synthetic import make_scene, write_colmap_scene
    from gs_init_tpu_torch.engine.runner import Runner

    scene = make_scene(n_gaussians=60, n_cams=3, width=48, height=32, device=CPU)
    data_dir = write_colmap_scene(str(tmp_path / "scene"), scene, n_points=48)
    cfg = Config(data_dir=data_dir, data_factor=1, test_every=8, init_type="monocular_depth",
                 result_dir=str(tmp_path / "res"), max_steps=2, eval_steps=[], save_steps=[],
                 sh_degree=1, max_gaussians=4096, pair_capacity=1 << 14)
    cfg.mdi.predictor, cfg.mdi.backbone = "metric3d", "vits"
    cfg.mdi.allow_random_weights = True
    cfg.mdi.use_cache = False
    cfg.mdi.predict_batch_size = 2
    cfg.mdi.subsampling.factor = 4
    runner = Runner(cfg, device="cpu")
    n_alive = int(runner.gstate.alive.sum())
    assert len(runner.trainset) == 2
    assert n_alive > len(runner.parser.points)  # the init added depth points to the SfM ones
    losses = [float(runner.train_iteration(step)["loss"]) for step in range(2)]
    assert np.isfinite(losses).all()
