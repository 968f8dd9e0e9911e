"""The SAM mask decoder's attention core (``models/sam.py``): its plain twin
``decoder_attention_plain`` against the JAX package's ``DecoderAttention``,
and on the card the CUDA kernel K8 (``csrc/sam_attention.cu``) against the
twin.

On the CPU, the port's ``DecoderAttention`` (projections, then the twin) and
the JAX one, with the same flax variables, on numpy inputs at the decoder's
published width (256, 8 heads): the 7 x 7 self-attention at head 32, token
to image (7 queries against N image tokens) and image to token (N queries
against 7 tokens) at head 16, at N = 4,096 and at odd sizes (B 3, N 1,000,
5 tokens: a short last key slice in K8), each within 1e-5 of the output's
largest value; the twin against SDPA in float64; then the whole
``SamMaskDecoder`` at a narrow width through the twin against the JAX
decoder, with image grids whose cross-attentions take either of K8's forms.

On the card: K8 against the twin evaluated in float64 at the decoder's
shapes (B 64, 4,096 image tokens, 7 tokens, 8 heads of 16; the
self-attention at head 32) and at odd ones, within ``K8_LIMIT`` of the
largest value, the same bits over two calls, one launch a call; and a
decoder batch at the published width: 7 launches of K8 (10 kernels: the
three token-to-image calls launch the merge too), no call to
``F.scaled_dot_product_attention``, the masks and IoU of the decoder run
through the twin.

This module imports no JAX at its top, so that the card tests run on a
machine without it: ``python -m pytest -m card tests/test_torch_sam_attention.py``.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gs_init_tpu_torch import kernels
from gs_init_tpu_torch.models import sam as S
from gs_init_tpu_torch.models.common import build, full_fp32, init_random_, state_dict_from_flax
from torch_parity import assert_close_scaled, carry, n, random_flax_variables, t

C, HEADS = 256, 8
# (name, batch, query tokens, key tokens, downsample rate): the decoder's
# three attentions, then odd sizes of the two cross-attentions.
SHAPES = [
    ("self 7x7, head 32", 4, 7, 7, 1),
    ("token to image 7 x 4096", 4, 7, 4096, 2),
    ("image to token 4096 x 7", 4, 4096, 7, 2),
    ("token to image 5 x 1000", 3, 5, 1000, 2),
    ("image to token 1000 x 5", 3, 1000, 5, 2),
]


def _inputs(b, nq, nk, seed=0, width=C):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, m, width)).astype(np.float32) for m in (nq, nk, nk)]


@pytest.mark.parametrize("name, b, nq, nk, rate", SHAPES, ids=[s[0] for s in SHAPES])
def test_twin_matches_jax_decoder_attention(name, b, nq, nk, rate):
    import jax.numpy as jnp
    from gs_init_tpu.models import sam as jsam

    q, k, v = _inputs(b, nq, nk)
    jattn = jsam.DecoderAttention(C, HEADS, rate)
    fv = random_flax_variables(jattn, jnp.asarray(q[:1]), jnp.asarray(k[:1]), jnp.asarray(v[:1]))
    want = jattn.apply(fv, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    port = carry(build(S.DecoderAttention, C, HEADS, rate), state_dict_from_flax(fv["params"]))
    with torch.no_grad():
        got = port(t(q), t(k), t(v))
    assert got.shape == (b, nq, C)
    assert_close_scaled(got, want, 1e-5, err_msg=name)


@pytest.mark.parametrize("nq, nk, head", [(6, 700, 16), (700, 6, 16), (7, 7, 32)])
def test_twin_is_sdpa_in_float64(nq, nk, head):
    """In float64 the twin is SDPA's attention with the heads split and
    merged: the scale, the softmax's axis and the head layout, without
    float32's rounding."""
    rng = np.random.default_rng(nq + nk)
    q, k, v = (torch.tensor(rng.normal(size=(2, m, 8 * head))) for m in (nq, nk, nk))
    got = S.decoder_attention_plain(q, k, v, 8)
    split = lambda x: x.reshape(2, x.shape[1], 8, head).transpose(1, 2)
    want = F.scaled_dot_product_attention(split(q), split(k), split(v)).transpose(1, 2).reshape(2, nq, 8 * head)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-13)


@pytest.mark.parametrize("grid", [8, 24])
def test_decoder_through_the_twin_matches_jax(grid):
    """The whole decoder at width 64 (4 heads: head 16 in the
    self-attention, 8 in the cross-attentions) on a grid of 8x8 image tokens
    (64: every attention takes the few-keys form) and of 24x24 (576: token
    to image takes three slices, the last of 64 keys)."""
    import jax.numpy as jnp
    from gs_init_tpu.models import sam as jsam

    from gs_init_tpu_torch.mdi.predictors.sam_convert import SAM_RENAMES, SAM_TRANSPOSED

    width, b = 64, 3
    rng = np.random.default_rng(grid)
    embed = rng.normal(size=(1, grid, grid, width)).astype(np.float32)
    pe = rng.normal(size=(grid, grid, width)).astype(np.float32)
    sparse = rng.normal(size=(b, 2, width)).astype(np.float32)
    no_mask = rng.normal(size=(width,)).astype(np.float32)
    jdec = jsam.SamMaskDecoder(embed_dim=width, num_heads=4, mlp_dim=128, iou_head_hidden=64)
    fv = random_flax_variables(jdec, jnp.zeros((1, grid, grid, width)), jnp.zeros((grid, grid, width)),
                               jnp.zeros((1, 2, width)), jnp.zeros((width,)), seed=grid)
    params = dict(fv["params"])
    params["iou_token"] = {"weight": params.pop("iou_token")}
    params["mask_tokens"] = {"weight": params.pop("mask_tokens")}
    sd = state_dict_from_flax({"decoder": params}, SAM_RENAMES, SAM_TRANSPOSED)
    port = carry(build(S.SamMaskDecoder, embed_dim=width, num_heads=4, mlp_dim=128, iou_head_hidden=64),
                 {k.removeprefix("mask_decoder."): v for k, v in sd.items()})
    jmasks, jiou = jdec.apply(fv, jnp.broadcast_to(jnp.asarray(embed), (b, grid, grid, width)), jnp.asarray(pe),
                              jnp.asarray(sparse), jnp.asarray(no_mask))
    with torch.no_grad():
        masks, iou = port(t(embed.transpose(0, 3, 1, 2)), t(pe), t(sparse), t(no_mask))
    assert masks.shape == (b, 4, 4 * grid, 4 * grid)
    assert_close_scaled(masks, jmasks, 1e-5, err_msg="masks")
    np.testing.assert_allclose(n(iou), np.asarray(jiou), atol=1e-5)


def test_kernel_path_checks_its_inputs():
    """The CUDA wrapper refuses what K8 does not take, before any launch."""
    q, kv = torch.zeros(2, 7, 128), torch.zeros(2, 4096, 128)
    with pytest.raises(ValueError, match="CUDA device"):
        S._check_attention(q, kv, kv, 8)
    with pytest.raises(ValueError, match="8 heads of 16 or of 32"):
        S._check_attention(q, kv, kv, 16)  # 16 heads of 8
    with pytest.raises(ValueError, match="8 heads of 16 or of 32"):
        S._check_attention(q, kv, kv, 4)  # 4 heads of 32
    with pytest.raises(ValueError, match="8 heads of 16 or of 32"):
        S._check_attention(torch.zeros(2, 7, 64), torch.zeros(2, 9, 64), torch.zeros(2, 9, 64), 8)
    with pytest.raises(ValueError, match="at most 64 tokens on one side"):
        S._check_attention(torch.zeros(2, 65, 128), kv, kv, 8)
    with pytest.raises(ValueError, match="k, v"):
        S._check_attention(q, kv, kv[:, :5], 8)


# ------------------------------------------------------------------- the card


# K8's largest gap from the twin evaluated in float64, of the output's
# largest value. K8 reads ~5e-7 at the decoder's shapes and the float32 twin
# ~6e-7; an attention in TF32 reads ~1e-3.
K8_LIMIT = 2e-6


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K8 is a CUDA kernel with no CPU mode")
    return torch.device("cuda", 0)


# (name, batch, query tokens, key tokens, heads, head): the decoder's batch,
# odd sizes, both sides of the few-keys limit, keys in several register
# chunks, and head 32 in the few-queries form.
CARD_SHAPES = [
    ("self 7x7, head 32", 64, 7, 7, 8, 32),
    ("token to image 7 x 4096", 64, 7, 4096, 8, 16),
    ("image to token 4096 x 7", 64, 4096, 7, 8, 16),
    ("token to image 5 x 1000", 3, 5, 1000, 8, 16),
    ("image to token 1000 x 5", 3, 1000, 5, 8, 16),
    ("64 keys, the few-keys form", 5, 7, 64, 8, 16),
    ("65 keys, the few-queries form", 5, 7, 65, 8, 16),
    ("64 queries against 300 keys", 2, 64, 300, 8, 16),
    ("500 queries against 20 keys", 2, 500, 20, 8, 16),
    ("head 32, 9 queries against 600 keys", 2, 9, 600, 8, 32),
    ("head 32, 300 queries against 9 keys", 2, 300, 9, 8, 32),
]


@pytest.mark.card
@pytest.mark.parametrize("name, b, nq, nk, heads, head", CARD_SHAPES, ids=[s[0] for s in CARD_SHAPES])
def test_kernel_matches_twin_on_the_card(name, b, nq, nk, heads, head):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(nq * 7919 + nk)
    q, k, v = (torch.randn(b, m, heads * head, device=dev, generator=g) for m in (nq, nk, nk))
    with torch.inference_mode(), full_fp32():
        want = S.decoder_attention_plain(q.double(), k.double(), v.double(), heads)
        l0 = kernels.LAUNCHES["sam_attention"]
        got = S.decoder_attention(q, k, v, heads)
        again = S.decoder_attention(q, k, v, heads)
        torch.cuda.synchronize()
    assert kernels.LAUNCHES["sam_attention"] - l0 == 2
    gap = float((got.double() - want).abs().max() / want.abs().max())
    assert gap < K8_LIMIT, f"{name}: largest gap {gap:.3e} of the largest value"
    assert torch.equal(got, again)


@pytest.mark.card
def test_decoder_batch_on_the_card(monkeypatch):
    """A 64-prompt decoder batch at the published width on a 64x64 image
    grid: 7 launches of K8, which run 10 kernels (4 few-keys, 3 few-queries
    and their 3 merges), and no SDPA; the masks and IoU predictions of the
    same decoder with the twin in K8's place, within 1e-5 of their largest
    value."""
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    dec = init_random_(build(S.SamMaskDecoder), 3).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(5)
    embed = torch.randn(1, C, 64, 64, device=dev, generator=g)
    pe = torch.randn(64, 64, C, device=dev, generator=g)
    sparse = torch.randn(64, 2, C, device=dev, generator=g)
    no_mask = torch.randn(C, device=dev, generator=g)

    def no_sdpa(*args, **kwargs):
        raise AssertionError("the decoder called F.scaled_dot_product_attention")

    with torch.inference_mode(), full_fp32():
        monkeypatch.setattr(F, "scaled_dot_product_attention", no_sdpa)
        l0 = kernels.LAUNCHES["sam_attention"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            masks, iou = dec(embed, pe, sparse, no_mask)
            torch.cuda.synchronize()
        assert kernels.LAUNCHES["sam_attention"] - l0 == 7
        ran = {kind: sum(e.count for e in prof.key_averages() if f"{kind}_kernel<" in e.key)
               for kind in ("few_keys", "few_queries", "merge")}
        assert ran == {"few_keys": 4, "few_queries": 3, "merge": 3}, ran
        monkeypatch.setattr(S, "decoder_attention", S.decoder_attention_plain)
        want_masks, want_iou = dec(embed, pe, sparse, no_mask)
    assert masks.shape == (64, 4, 256, 256)
    assert_close_scaled(masks, want_masks, 1e-5, err_msg="masks")
    assert_close_scaled(iou, want_iou, 1e-5, err_msg="iou")
