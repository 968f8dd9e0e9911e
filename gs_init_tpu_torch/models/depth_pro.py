"""Apple DepthPro, a multi-scale ViT depth estimator — port of
``gs_init_tpu/models/depth_pro.py`` (the HuggingFace
``DepthProForDepthEstimation`` layout of apple/ml-depth-pro).

- The square input is rendered at 3 scales; each scale is cut into
  overlapping ViT-sized patches and all of them run through one shared
  DINOv2 patch encoder as a batch (35 crops of 384 at the 1536 default).
- Each scale's feature map is put back together from its patch grid (the
  overlap cropped), with two raw intermediate-layer hooks of the full-res
  scale; a separate DINOv2 image encoder gives global features.
- A DPT-style neck (upsample, fuse, project), a fusion stage and a conv
  head give canonical inverse depth; the optional FOV branch estimates the
  field of view for images without intrinsics.

The default ViT is DepthPro-hf's DINOv2-L/16 at 384 (24 x 24 patches,
577 tokens per crop). The JAX package's default patch is 14, which does not
tile a 384 crop (384 / 14 = 27.4): its DepthProNet cannot run at its own
defaults (ROADMAP Queue C); its tests use a 56 crop of 14-px patches.

With the tracer on (``trace.py``), a pass is spans ``depth_pro.patch_encode``
(the crops through the patch encoder), ``depth_pro.image_encode`` and
``depth_pro.decode`` (neck, fusion stage and head), each with CUDA events,
and two ``depth_pro.merge`` spans on the host clock (the scales cut into
crops; the crop grids merged back into feature maps); the counter
``depth_pro.crops`` adds the crops of each pass (35 at 1536).

Every resize is ``jax.image.resize`` bilinear (antialiased when it
shrinks, as the JAX package's is), by weight matrices. Parameter names
are the HuggingFace checkpoint's outside the three ViTs
(``depth_pro.neck.*``, ``fusion_stage.*``, ``head.layers.*``,
``fov_model.*``); the ViTs under ``...patch_encoder.model``,
``...image_encoder.model`` and ``fov_model.fov_encoder.model`` carry the
DINOv2 names (``apple_depth_pro.convert_hf_checkpoint`` maps HF's).
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import trace
from .common import resize
from .vit import DinoViT

_ENC = "depth_pro/encoder"
_NECK = "depth_pro/neck"

# DepthProNet's flax module paths against its torch names, and its
# transposed convolutions (state_dict_from_flax).
DEPTH_PRO_RENAMES = (
    (r"^(patch|image)_encoder", _ENC + r"/\1_encoder/model"),
    (r"^fov_encoder", "fov_model/fov_encoder/model"),
    (r"^up_image/layers_(\d)", _NECK + r"/feature_upsample/image_block/layers/\1"),
    (r"^up_scaled_(\d)/layers_(\d)", _NECK + r"/feature_upsample/scaled_images/\1/layers/\2"),
    (r"^up_inter_(\d)/layers_(\d)", _NECK + r"/feature_upsample/intermediate/\1/layers/\2"),
    (r"^fuse_image_low", _NECK + "/fuse_image_with_low_res"),
    (r"^proj_(\d)", _NECK + r"/feature_projection/projections/\1"),
    (r"^fusion_final", "fusion_stage/final"),
    (r"^fusion_(\d)", r"fusion_stage/intermediate/\1"),
    (r"/rcu(\d)", r"/residual_layer\1"),
    (r"/residual_layer(\d)/conv(\d)", r"/residual_layer\1/convolution\2"),
    (r"^head_(\d)", r"head/layers/\1"),
    (r"^fov_neck", "fov_model/fov_encoder/neck"),
    (r"^fov_conv", "fov_model/conv"),
    (r"^fov_head_(\d)", r"fov_model/head/layers/\1"),
)
DEPTH_PRO_TRANSPOSED = (
    r"up_image/layers_0", r"up_scaled_\d/layers_1", r"up_inter_\d/layers_[1-9]",
    r"fusion_\d/deconv", r"head_1",
)


def split_to_patches(x: torch.Tensor, patch: int, overlap: float) -> torch.Tensor:
    """[B, C, H, W] -> [L * B, C, patch, patch], row-major over the patch
    grid with the batch fastest (torch ``F.unfold``'s order)."""
    h, w = x.shape[2:]
    if h == patch and w == patch:
        return x
    stride = int(patch * (1 - overlap))
    rows, cols = (h - patch) // stride + 1, (w - patch) // stride + 1
    return torch.cat([x[:, :, r * stride:r * stride + patch, c * stride:c * stride + patch]
                      for r in range(rows) for c in range(cols)], dim=0)


def merge_patches(patches: torch.Tensor, batch: int, padding: int) -> torch.Tensor:
    """The inverse of ``split_to_patches`` at feature resolution: [L * B, C,
    o, o] -> [B, C, O, O], ``padding`` pixels cropped from interior edges."""
    n, c, o, _ = patches.shape
    lpb = n // batch
    s = int(math.isqrt(lpb))
    if n == batch:
        return patches
    if lpb < 4:
        padding = 0
    padding = min(o // 4, padding)
    if padding == 0:
        m = patches.reshape(lpb, batch, c, o, o)[: s * s].reshape(s, s, batch, c, o, o)
        return m.permute(2, 3, 0, 4, 1, 5).reshape(batch, c, s * o, s * o)
    rows = []
    for hh in range(s):
        row = []
        for ww in range(s):
            box = patches[batch * (hh * s + ww):batch * (hh * s + ww + 1)]
            top = padding if hh != 0 else 0
            bot = padding if hh != s - 1 else 0
            left = padding if ww != 0 else 0
            right = padding if ww != s - 1 else 0
            row.append(box[:, :, top:o - bot, left:o - right])
        rows.append(torch.cat(row, dim=3))
    return torch.cat(rows, dim=2)


def reconstruct(feats: torch.Tensor, batch: int, padding: int, out_hw) -> torch.Tensor:
    """Patch-grid features [N, C, g, g] -> [B, C, out_h, out_w]: merge the
    grid, resize."""
    return resize(merge_patches(feats, batch, padding), out_hw)


class UpsampleBlock(nn.Module):
    """A 1x1 projection (optional) and n transposed-conv x2 upsamples."""

    def __init__(self, cin: int, intermediate: int, out: int, n_upsample: int,
                 use_proj: bool = True, bias: bool = False):
        super().__init__()
        layers = []
        if use_proj:
            layers.append(nn.Conv2d(cin, intermediate, 1, bias=bias))
            cin = intermediate
        for _ in range(n_upsample):
            layers.append(nn.ConvTranspose2d(cin, out, 2, stride=2, bias=bias))
            cin = out
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return self.layers(x)


class PreActResidual(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.convolution1 = nn.Conv2d(ch, ch, 3, padding=1)
        self.convolution2 = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return x + self.convolution2(F.relu(self.convolution1(F.relu(x))))


class FusionLayer(nn.Module):
    """``residual=False``: the first level, called without a residual (the
    checkpoint's unused first unit there is not built)."""

    def __init__(self, ch: int, use_deconv: bool = True, residual: bool = True):
        super().__init__()
        if residual:
            self.residual_layer1 = PreActResidual(ch)
        self.residual_layer2 = PreActResidual(ch)
        if use_deconv:
            self.deconv = nn.ConvTranspose2d(ch, ch, 2, stride=2, bias=False)
        self.projection = nn.Conv2d(ch, ch, 1)

    def forward(self, x, residual=None):
        if residual is not None:
            x = x + self.residual_layer1(residual)
        x = self.residual_layer2(x)
        if hasattr(self, "deconv"):
            x = self.deconv(x)
        return self.projection(x)


def _module(**children) -> nn.Module:
    m = nn.Module()
    for k, v in children.items():
        setattr(m, k, v)
    return m


class DepthProNet(nn.Module):
    """Returns (canonical inverse depth [B, H, W], fov in degrees [B] or None)."""

    def __init__(
        self,
        vit_dim: int = 1024,
        vit_depth: int = 24,
        vit_heads: int = 16,
        vit_image_size: int = 384,
        vit_patch: int = 16,
        fusion: int = 256,
        intermediate_hook_ids: Sequence[int] = (11, 5),
        intermediate_feature_dims: Sequence[int] = (256, 256),
        scaled_images_ratios: Sequence[float] = (0.25, 0.5, 1.0),
        scaled_images_overlap_ratios: Sequence[float] = (0.0, 0.5, 0.25),
        scaled_images_feature_dims: Sequence[int] = (1024, 1024, 512),
        merge_padding_value: int = 3,
        use_fov: bool = False,
        num_fov_head_layers: int = 2,
    ):
        super().__init__()
        self.vit_depth, self.vit_image_size, self.vit_patch = vit_depth, vit_image_size, vit_patch
        self.hook_ids = tuple(intermediate_hook_ids)
        self.ratios = tuple(scaled_images_ratios)
        self.overlaps = tuple(scaled_images_overlap_ratios)
        self.merge_padding_value = merge_padding_value
        self.use_fov = use_fov
        grid = vit_image_size // vit_patch

        def vit(out_layers=(vit_depth - 1,), norms=None):
            return DinoViT(dim=vit_dim, depth=vit_depth, num_heads=vit_heads, patch_size=vit_patch,
                           out_layers=out_layers, out_layers_norm=norms, pos_embed_size=grid)

        n_hooks = len(self.hook_ids)
        hooks = self.hook_ids[::-1]  # ascending
        self.depth_pro = _module(
            encoder=_module(
                patch_encoder=_module(model=vit(hooks + (vit_depth - 1,), (False,) * n_hooks + (True,))),
                image_encoder=_module(model=vit()),
            ),
        )
        fdims, idims = tuple(scaled_images_feature_dims), tuple(intermediate_feature_dims)
        self.depth_pro.neck = _module(
            feature_upsample=_module(
                image_block=UpsampleBlock(vit_dim, vit_dim, fdims[0], 1, use_proj=False, bias=True),
                scaled_images=nn.ModuleList(UpsampleBlock(vit_dim, fd, fd, 1) for fd in fdims),
                intermediate=nn.ModuleList(
                    UpsampleBlock(vit_dim, fusion if i == 0 else fd, fd, 2 + i) for i, fd in enumerate(idims)
                ),
            ),
            fuse_image_with_low_res=nn.Conv2d(2 * fdims[0], fdims[0], 1),
            feature_projection=_module(projections=nn.ModuleList(
                nn.Identity() if (i == len(fdims + idims) - 1 and pd == fusion)
                else nn.Conv2d(pd, fusion, 3, padding=1, bias=False)
                for i, pd in enumerate(fdims + idims)
            )),
        )
        n_levels = len(fdims + idims)
        self.fusion_stage = _module(
            intermediate=nn.ModuleList(FusionLayer(fusion, residual=i != 0) for i in range(n_levels - 1)),
            final=FusionLayer(fusion, use_deconv=False),
        )
        half = fusion // 2
        self.head = _module(layers=nn.Sequential(
            nn.Conv2d(fusion, half, 3, padding=1), nn.ConvTranspose2d(half, half, 2, stride=2),
            nn.Conv2d(half, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 1, 1), nn.ReLU(),
        ))
        if use_fov:
            layers, ch = [], half
            for i in range(num_fov_head_layers):
                out = math.ceil(fusion / 2 ** (i + 2))
                layers += [nn.Conv2d(ch, out, 3, stride=2, padding=1), nn.ReLU()]
                ch = out
            k = int((grid - 1) / 2**num_fov_head_layers + 1)
            layers.append(nn.Conv2d(ch, 1, k))
            self.fov_model = _module(
                fov_encoder=_module(model=vit(), neck=nn.Linear(vit_dim, half)),
                conv=nn.Conv2d(fusion, half, 3, stride=2, padding=1),
                head=_module(layers=nn.Sequential(*layers)),
            )

    def forward(self, x: torch.Tensor):
        """x: [B, 3, S, S] normalised to [-1, 1]."""
        b, _, h, w = x.shape
        psize = self.vit_image_size
        grid = psize // self.vit_patch
        n_scales = len(self.ratios)
        enc = self.depth_pro.encoder

        with trace.span("depth_pro.merge", device=False):
            per_scale = [split_to_patches(resize(x, (int(h * r), int(w * r))), psize, ov)
                         for r, ov in zip(self.ratios, self.overlaps)]
            counts = [p.shape[0] for p in per_scale]
            crops = torch.cat(per_scale[::-1], dim=0)  # high res first
        trace.count("depth_pro.crops", crops.shape[0])
        with trace.span("depth_pro.patch_encode"):
            pe_outs, _ = enc.patch_encoder.model(crops)

        exponent = int(math.log2(w / grid))
        base_h, base_w = h // 2**exponent, w // 2**exponent
        with trace.span("depth_pro.merge", device=False):
            per_scale_feats = torch.split(pe_outs[-1], counts[::-1], dim=0)[::-1]
            feats: List[torch.Tensor] = []
            for i in range(n_scales):
                pad = int(self.merge_padding_value / self.ratios[i])
                feats.append(reconstruct(per_scale_feats[i], b, pad, (base_h * 2**i, base_w * 2**i)))
            # The hooks come from the full-res scale's patches, first in the batch.
            hooks = self.hook_ids[::-1]
            n_full = counts[-1]
            pad = int(self.merge_padding_value / self.ratios[-1])
            top_hw = (base_h * 2 ** (n_scales - 1), base_w * 2 ** (n_scales - 1))
            inter = [reconstruct(pe_outs[hooks.index(hook)][:n_full], b, pad, top_hw) for hook in self.hook_ids]

        with trace.span("depth_pro.image_encode"):
            img_in = resize(x, (psize, psize))
            ie_outs, _ = enc.image_encoder.model(img_in)
            feats = [resize(ie_outs[0], (base_h, base_w)), *feats, *inter]

        with trace.span("depth_pro.decode"):
            neck = self.depth_pro.neck
            up = neck.feature_upsample
            feats[0] = up.image_block(feats[0])
            for i, blk in enumerate(up.scaled_images):
                feats[i + 1] = blk(feats[i + 1])
            for i, blk in enumerate(up.intermediate):
                feats[n_scales + i + 1] = blk(feats[n_scales + i + 1])
            glob = neck.fuse_image_with_low_res(torch.cat([feats[1], feats[0]], dim=1))
            feats = [proj(f) for proj, f in zip(neck.feature_projection.projections, [glob, *feats[2:]])]

            fused = None
            for i, f in enumerate(feats[:-1]):
                layer = self.fusion_stage.intermediate[i]
                fused = layer(f) if fused is None else layer(fused, f)
            fused = self.fusion_stage.final(fused, feats[-1])
            inv_depth = self.head.layers(fused)[:, 0]

        fov_deg = None
        if self.use_fov:
            fm = self.fov_model
            fov_outs, _ = fm.fov_encoder.model(img_in)
            tok = fm.fov_encoder.neck(fov_outs[0].flatten(2).transpose(1, 2))  # [B, g*g, C]
            fov_feat = resize(tok.transpose(1, 2).reshape(b, -1, grid, grid), (base_h, base_w))
            y = resize(fov_feat + F.relu(fm.conv(feats[0])), (grid, grid))
            fov_deg = fm.head.layers(y).reshape(b)
        return inv_depth, fov_deg
