"""Apple Depth Pro (Bochkovskii et al. 2024, "Depth Pro: Sharp Monocular
Metric Depth in Less Than a Second", arXiv:2410.02073), plain float32 with
TF32 off, written from the paper and from transformers'
``DepthProForDepthEstimation`` (the layout of ``apple/DepthPro-hf``) for the
benchmark's check of the port's Depth Pro. It imports nothing of the port.

A pass over a square input x [B, 3, S, S] in [-1, 1]:
1. x at three scales (``ratios``, 0.25 / 0.5 / 1 published), each cut by
   slicing into crops of the ViT's size (384) at a stride of crop x (1 -
   overlap) (overlaps 0 / 0.5 / 0.25): 1 + 9 + 25 = 35 crops at 1536, row
   by row over each grid, the batch fastest, the full scale's crops first;
2. every crop through one DINOv2 ViT (the patch encoder: ViT-L/16, width
   1024, 24 blocks of 16 heads): its last block after the final LayerNorm,
   and the raw outputs of the hook blocks (11 and 5);
3. each scale's feature map merged from its grid of crop features: every
   interior edge of a crop loses ``merge_padding / ratio`` feature pixels
   (at most a quarter of the crop's grid; none for a grid under 2 x 2), by
   index arithmetic (``merge_index``); then resized to the scale's base size
   x 2^i (the hooks' maps from the full scale's crops, at its size);
4. a second ViT (the image encoder) over x resized to the crop size, its
   normed output resized to the base size;
5. the neck: a transposed-convolution upsampler a map (the hooks' with 2
   and 3 of them), the image features fused with the lowest scale's by a
   1x1 convolution, 3x3 projections to the fusion width (256);
6. the fusion stage from the coarsest level to the finest: pre-activation
   residual units (ReLU, 3x3 convolution, ReLU, 3x3 convolution, plus the
   input), a transposed convolution x2, a 1x1 projection;
7. the head: 3x3 convolution, transposed convolution x2, 3x3 convolution,
   ReLU, 1x1 convolution (its output is the pre-activation the check
   compares), ReLU: canonical inverse depth [B, S, S].

``predict`` is the predictor around it: the image in [0, 1] resized to the
square input and normalised to [-1, 1], the inverse depth resized back to
the image, depth = 1 / clip(inv x W / f_px, 1e-4, 1e4).

Departures from ``DepthProForDepthEstimation``, each the port's:
- every resize is ``jax.image.resize`` bilinear (antialiased when it
  shrinks) by weight matrices (``common.resize``): the predictor's square
  input and output, and inside the network the 0.25 and 0.5 scales, the
  image encoder's input and the merged maps (identities at 1536).
  transformers takes ``F.interpolate`` bilinear without antialiasing there,
  and its image processor resizes the input its own way;
  ``DepthProNet(interp="torch")`` computes the network's resizes as
  transformers does, for the test against it;
- the FOV branch is left out: the port's ``pick_model`` builds none, and
  the focal length comes from the camera's intrinsics;
- the first fusion level has no first residual unit (transformers builds
  one there and never calls it);
- the ViTs take no position-embedding interpolation: the crop's token grid
  must be the embedding's (24 x 24 at 384, as published);
- parameter names are the port's state dict's: transformers' outside the
  ViTs, DINOv2's inside them (``blocks.{i}.attn.qkv`` with query, key and
  value stacked, ``ls1.gamma``); ``hf_state_dict`` renames a transformers
  state dict.

Every attention is an explicit softmax of the scaled scores
(``sam.softmax_attention``), a block of heads at a time.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import resize
from .sam import matmul_precision, softmax_attention

# The published network (apple/DepthPro-hf's config) as the port's
# ``DepthProNet`` takes it, without the FOV branch.
PUBLISHED = dict(vit_dim=1024, vit_depth=24, vit_heads=16, vit_image_size=384, vit_patch=16, fusion=256,
                 intermediate_hook_ids=(11, 5), intermediate_feature_dims=(256, 256),
                 scaled_images_ratios=(0.25, 0.5, 1.0), scaled_images_overlap_ratios=(0.0, 0.5, 0.25),
                 scaled_images_feature_dims=(1024, 1024, 512), merge_padding_value=3)
INPUT_SIZE = 1536
CLIP = (1e-4, 1e4)


def widths_of(group: dict) -> dict:
    """``DepthProNet``'s arguments from a configuration's ``depth_pro`` group."""
    return {k: group[k] for k in PUBLISHED}


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, d = x.shape
        h, dh = self.heads, d // self.heads
        q, k, v = self.qkv(x).reshape(b, n, 3, h, dh).permute(2, 0, 3, 1, 4).reshape(3, b * h, n, dh)
        o = softmax_attention(q, k, v).reshape(b, h, n, dh)
        return self.proj(o.transpose(1, 2).reshape(b, n, d))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x)) * self.ls1.gamma
        h = self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))
        return x + h * self.ls2.gamma


class ViT(nn.Module):
    """DINOv2 at its own grid: ``forward`` returns {block index: raw output
    tokens} for ``keep``, and the last block's output after the LayerNorm
    under key -1; tokens [B, 1 + g * g, D], the class token first."""

    def __init__(self, dim: int, depth: int, heads: int, patch: int, grid: int):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, patch, stride=patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, dim))
        self.blocks = nn.ModuleList(Block(dim, heads) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, keep=()):
        t = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        if t.shape[1] + 1 != self.pos_embed.shape[1]:
            raise ValueError(f"{t.shape[1]} tokens for a position embedding of {self.pos_embed.shape[1] - 1}")
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(t.shape[0], 1, -1)
        t = torch.cat([cls, t + self.pos_embed[:, 1:]], dim=1)
        out = {}
        for i, blk in enumerate(self.blocks):
            t = blk(t)
            if i in keep:
                out[i] = t
        out[-1] = self.norm(t)
        return out


def grid_map(tokens: torch.Tensor) -> torch.Tensor:
    """Tokens [N, 1 + g * g, D] -> patch features [N, D, g, g]."""
    n, m, d = tokens.shape
    g = math.isqrt(m - 1)
    return tokens[:, 1:].transpose(1, 2).reshape(n, d, g, g)


def cut_crops(x: torch.Tensor, crop: int, overlap: float) -> torch.Tensor:
    """[B, C, H, W] -> [L * B, C, crop, crop] by slicing: the crops of a
    grid at a stride of crop x (1 - overlap), row by row, each crop's batch
    together."""
    h, w = x.shape[2:]
    if h == crop and w == crop:
        return x
    stride = int(crop * (1 - overlap))
    out = []
    for top in range(0, h - crop + 1, stride):
        for left in range(0, w - crop + 1, stride):
            out.append(x[:, :, top:top + crop, left:left + crop])
    return torch.cat(out, dim=0)


def merge_index(s: int, o: int, pad: int):
    """For a merged axis of an s-crop grid of o-pixel crops whose interior
    edges lose ``pad`` pixels: (the crop, the pixel in the crop) of every
    merged pixel, as int64 arrays."""
    crop_of, pixel_of = [], []
    for r in range(s):
        lo = pad if r > 0 else 0
        hi = o - pad if r < s - 1 else o
        crop_of += [r] * (hi - lo)
        pixel_of += list(range(lo, hi))
    return np.asarray(crop_of, np.int64), np.asarray(pixel_of, np.int64)


def merge(feats: torch.Tensor, batch: int, pad: int) -> torch.Tensor:
    """Crop features [L * B, C, o, o] -> [B, C, M, M]: out[b, :, y, x] is
    crop (r(y), c(x))'s feature at (i(y), j(x)) by ``merge_index``. One crop
    a batch entry is the map itself; a grid under 2 x 2 loses no pixel; the
    padding is at most a quarter of the crop."""
    n, c, o, _ = feats.shape
    per = n // batch
    if per == 1:
        return feats
    s = math.isqrt(per)
    pad = 0 if per < 4 else min(o // 4, pad)
    grid = feats[: s * s * batch].reshape(s, s, batch, c, o, o)
    r, i = (torch.as_tensor(a, device=feats.device) for a in merge_index(s, o, pad))
    out = grid[r[:, None], r[None, :], :, :, i[:, None], i[None, :]]  # [M, M, B, C]
    return out.permute(2, 3, 0, 1)


class Upsample(nn.Module):
    """A 1x1 projection (``proj``), then ``n`` transposed convolutions x2."""

    def __init__(self, cin: int, mid: int, out: int, n: int, proj: bool = True, bias: bool = False):
        super().__init__()
        layers = [nn.Conv2d(cin, mid, 1, bias=bias)] if proj else []
        ch = mid if proj else cin
        for _ in range(n):
            layers.append(nn.ConvTranspose2d(ch, out, 2, stride=2, bias=bias))
            ch = out
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return self.layers(x)


class Residual(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.convolution1 = nn.Conv2d(ch, ch, 3, padding=1)
        self.convolution2 = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.convolution2(F.relu(self.convolution1(F.relu(x)))) + x


class Fusion(nn.Module):
    def __init__(self, ch: int, first: bool = False, deconv: bool = True):
        super().__init__()
        if not first:
            self.residual_layer1 = Residual(ch)
        self.residual_layer2 = Residual(ch)
        if deconv:
            self.deconv = nn.ConvTranspose2d(ch, ch, 2, stride=2, bias=False)
        self.projection = nn.Conv2d(ch, ch, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.residual_layer1(skip)
        x = self.residual_layer2(x)
        if hasattr(self, "deconv"):
            x = self.deconv(x)
        return self.projection(x)


def _holder(**children) -> nn.Module:
    m = nn.Module()
    for k, v in children.items():
        setattr(m, k, v)
    return m


class DepthProNet(nn.Module):
    """``forward(x)`` -> (canonical inverse depth [B, S, S], the head's
    pre-activation [B, S, S]). ``merge_padding_value`` and ``hook_ids`` are
    read at each pass (the check's planted faults change them)."""

    def __init__(self, vit_dim: int, vit_depth: int, vit_heads: int, vit_image_size: int, vit_patch: int,
                 fusion: int, intermediate_hook_ids: Sequence[int], intermediate_feature_dims: Sequence[int],
                 scaled_images_ratios: Sequence[float], scaled_images_overlap_ratios: Sequence[float],
                 scaled_images_feature_dims: Sequence[int], merge_padding_value: int, interp: str = "jax"):
        super().__init__()
        self.crop, self.patch = vit_image_size, vit_patch
        self.hook_ids = tuple(intermediate_hook_ids)
        self.ratios, self.overlaps = tuple(scaled_images_ratios), tuple(scaled_images_overlap_ratios)
        self.merge_padding_value = merge_padding_value
        self.interp = interp
        grid = vit_image_size // vit_patch
        vit = lambda: ViT(vit_dim, vit_depth, vit_heads, vit_patch, grid)
        sdims, idims = tuple(scaled_images_feature_dims), tuple(intermediate_feature_dims)
        dims = sdims + idims
        self.depth_pro = _holder(
            encoder=_holder(patch_encoder=_holder(model=vit()), image_encoder=_holder(model=vit())),
            neck=_holder(
                feature_upsample=_holder(
                    image_block=Upsample(vit_dim, vit_dim, sdims[0], 1, proj=False, bias=True),
                    scaled_images=nn.ModuleList(Upsample(vit_dim, d, d, 1) for d in sdims),
                    intermediate=nn.ModuleList(Upsample(vit_dim, fusion if i == 0 else d, d, 2 + i)
                                               for i, d in enumerate(idims))),
                fuse_image_with_low_res=nn.Conv2d(2 * sdims[0], sdims[0], 1),
                feature_projection=_holder(projections=nn.ModuleList(
                    nn.Identity() if i == len(dims) - 1 and d == fusion else nn.Conv2d(d, fusion, 3, padding=1,
                                                                                      bias=False)
                    for i, d in enumerate(dims)))))
        self.fusion_stage = _holder(
            intermediate=nn.ModuleList(Fusion(fusion, first=i == 0) for i in range(len(dims) - 1)),
            final=Fusion(fusion, deconv=False))
        half = fusion // 2
        self.head = _holder(layers=nn.Sequential(
            nn.Conv2d(fusion, half, 3, padding=1), nn.ConvTranspose2d(half, half, 2, stride=2),
            nn.Conv2d(half, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 1, 1), nn.ReLU()))

    def resize(self, x, hw):
        if self.interp == "torch":
            return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)
        return resize(x, tuple(hw))

    def forward(self, x):
        b, _, h, w = x.shape
        g = self.crop // self.patch
        n_scales = len(self.ratios)
        crops = [cut_crops(self.resize(x, (int(h * r), int(w * r))), self.crop, ov)
                 for r, ov in zip(self.ratios, self.overlaps)]
        counts = [len(c) for c in crops]
        hooks = set(self.hook_ids)
        pe = self.depth_pro.encoder.patch_encoder.model(torch.cat(crops[::-1], dim=0), keep=hooks)

        base = w // 2 ** int(math.log2(w / g))  # the lowest scale's feature size
        last = torch.split(grid_map(pe[-1]), counts[::-1], dim=0)[::-1]
        feats = []
        for i, r in enumerate(self.ratios):
            pad = int(self.merge_padding_value / r)
            feats.append(self.resize(merge(last[i], b, pad), (base * 2**i, base * 2**i)))
        top, pad = base * 2 ** (n_scales - 1), int(self.merge_padding_value / self.ratios[-1])
        inter = [self.resize(merge(grid_map(pe[k][:counts[-1]]), b, pad), (top, top)) for k in self.hook_ids]

        ie = self.depth_pro.encoder.image_encoder.model(self.resize(x, (self.crop, self.crop)))
        image = self.resize(grid_map(ie[-1]), (base, base))

        up = self.depth_pro.neck.feature_upsample
        image = up.image_block(image)
        feats = [blk(f) for blk, f in zip(up.scaled_images, feats)]
        inter = [blk(f) for blk, f in zip(up.intermediate, inter)]
        glob = self.depth_pro.neck.fuse_image_with_low_res(torch.cat([feats[0], image], dim=1))
        levels = [p(f) for p, f in zip(self.depth_pro.neck.feature_projection.projections,
                                        [glob, *feats[1:], *inter])]
        fused = self.fusion_stage.intermediate[0](levels[0])
        for layer, f in zip(list(self.fusion_stage.intermediate)[1:], levels[1:-1]):
            fused = layer(fused, f)
        fused = self.fusion_stage.final(fused, levels[-1])
        head = self.head.layers
        pre = head[4](head[3](head[2](head[1](head[0](fused)))))[:, 0]
        return F.relu(pre), pre


def reference_net(sd: dict, dev, widths=None) -> DepthProNet:
    """The network at ``widths`` (the published ones by default) holding the
    tensors of ``sd`` itself."""
    with torch.device("meta"):
        net = DepthProNet(**(widths or PUBLISHED))
    net.load_state_dict(sd, assign=True)
    return net.to(dev).eval().requires_grad_(False)


@torch.no_grad()
def predict(net: DepthProNet, image: np.ndarray, f_px: float, dev, size: int = INPUT_SIZE, tf32: bool = False):
    """(depth [H, W], inverse depth [H, W], pre-activation [S, S]) of one
    uint8 image [H, W, 3] at focal length ``f_px``, as the port's predictor
    computes them; TF32 only with ``tf32``."""
    h, w = image.shape[:2]
    x = torch.as_tensor(image.astype(np.float32) / 255.0, device=dev).permute(2, 0, 1)[None]
    with matmul_precision(tf32):
        x = (resize(x, (size, size)) - 0.5) / 0.5
        inv, pre = net(x)
        inv = resize(inv, (h, w))[0]
    return 1.0 / torch.clamp(inv * (w / f_px), *CLIP), inv, pre[0]


def hf_state_dict(sd: dict, depth: int) -> dict:
    """A transformers ``DepthProForDepthEstimation`` state dict renamed to
    this file's names (the FOV branch's and the unused residual unit's
    tensors dropped)."""
    out = {}
    for key, v in sd.items():
        if key.startswith("fov_model.") or key.startswith("fusion_stage.intermediate.0.residual_layer1."):
            continue
        if ".encoder.patch_encoder.model." in key or ".encoder.image_encoder.model." in key:
            continue
        out[key] = v
    for enc in ("patch_encoder", "image_encoder"):
        src = dst = f"depth_pro.encoder.{enc}.model"
        out[f"{dst}.cls_token"] = sd[f"{src}.embeddings.cls_token"]
        out[f"{dst}.pos_embed"] = sd[f"{src}.embeddings.position_embeddings"]
        for leaf in ("weight", "bias"):
            out[f"{dst}.patch_embed.proj.{leaf}"] = sd[f"{src}.embeddings.patch_embeddings.projection.{leaf}"]
            out[f"{dst}.norm.{leaf}"] = sd[f"{src}.layernorm.{leaf}"]
        for i in range(depth):
            s, t = f"{src}.encoder.layer.{i}", f"{dst}.blocks.{i}"
            for leaf in ("weight", "bias"):
                out[f"{t}.attn.qkv.{leaf}"] = torch.cat(
                    [sd[f"{s}.attention.attention.{q}.{leaf}"] for q in ("query", "key", "value")])
                out[f"{t}.attn.proj.{leaf}"] = sd[f"{s}.attention.output.dense.{leaf}"]
                for m in ("norm1", "norm2", "mlp.fc1", "mlp.fc2"):
                    out[f"{t}.{m}.{leaf}"] = sd[f"{s}.{m}.{leaf}"]
            out[f"{t}.ls1.gamma"] = sd[f"{s}.layer_scale1.lambda1"]
            out[f"{t}.ls2.gamma"] = sd[f"{s}.layer_scale2.lambda1"]
    return out
