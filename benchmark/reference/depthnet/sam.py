"""Segment Anything (Kirillov et al. 2023, arXiv:2304.02643), plain float32:
the image encoder, the prompt encoder and the mask decoder, written from the
published description and ``segment_anything``'s modelling code, for the
benchmark's check of the port's SAM. Parameter names are the official
checkpoint's (``image_encoder.blocks.{i}.attn.rel_pos_h``, ...), so the state
dict the benchmark draws loads into the program and into this file alike.

Every attention is an explicit softmax of the scaled scores (the encoder's
with the decomposed relative-position terms added before it), computed for as
many heads and windows at a time as keep the scores under ``SCORE_BLOCK``
entries, so that a global block over 64x64 tokens fits. ``SamNet.encode`` and ``SamNet.decode`` run with TF32 off unless told
otherwise (the check's control turns it on).

Departures from ``segment_anything``:
- a relative-position table must already have the length its block needs
  (2 * size - 1); upstream resizes it linearly otherwise, which no published
  configuration needs at its own image size;
- the absolute position embedding must match the token grid (the same);
- the decoder takes one image embedding for every prompt of a batch and
  returns all four mask tokens (the caller drops token 0 for multimask
  output), where upstream repeats the embedding per prompt;
- the prompt encoder takes points only (no boxes, no mask prompt: the
  automatic mask generator uses neither) and returns the no-mask dense
  embedding as one vector.
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

SCORE_BLOCK = 1 << 26  # attention scores held at once (256 MiB in float32)

# The published image encoders (``build_sam_vit_{b,l,h}``).
VARIANTS = {
    "vit_b": dict(dim=768, depth=12, num_heads=12, global_attn_indexes=(2, 5, 8, 11)),
    "vit_l": dict(dim=1024, depth=24, num_heads=16, global_attn_indexes=(5, 11, 17, 23)),
    "vit_h": dict(dim=1280, depth=32, num_heads=16, global_attn_indexes=(7, 15, 23, 31)),
}


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def softmax_attention(q, k, v, bias=None):
    """softmax(q k^T / sqrt(d) + bias) v over [B, N, d] per batch entry,
    a block of entries at a time; ``bias(lo, hi)`` gives the additive terms
    [hi - lo, Nq, Nk] of entries lo to hi."""
    out = torch.empty(q.shape[:-1] + (v.shape[-1],), dtype=q.dtype, device=q.device)
    scale = q.shape[-1] ** -0.5
    step = max(1, SCORE_BLOCK // (q.shape[1] * k.shape[1]))
    for lo in range(0, q.shape[0], step):
        hi = min(lo + step, q.shape[0])
        s = torch.matmul(q[lo:hi] * scale, k[lo:hi].transpose(-2, -1))
        if bias is not None:
            s = s + bias(lo, hi)
        out[lo:hi] = torch.matmul(torch.softmax(s, dim=-1), v[lo:hi])
    return out


def rel_pos_table(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
    """R [size, size, head]: the embedding of each query-key offset, q - k +
    size - 1 (query and key grids of one size)."""
    if rel_pos.shape[0] != 2 * size - 1:
        raise ValueError(f"relative-position table of {rel_pos.shape[0]} rows for a grid of {size}")
    idx = torch.arange(size, device=rel_pos.device)
    return rel_pos[(idx[:, None] - idx[None, :]) + size - 1]


class LayerNorm2d(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        return self.weight[:, None, None] * ((x - u) / torch.sqrt(s + self.eps)) + self.bias[:, None, None]


class Attention(nn.Module):
    """Multi-head self-attention over a [B, H, W, C] grid with decomposed
    relative positions: score(q, k) += <q, Rh[qy, ky]> + <q, Rw[qx, kx]>,
    with the unscaled query."""

    def __init__(self, dim: int, num_heads: int, size: int):
        super().__init__()
        self.num_heads = num_heads
        head = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, head))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, head))

    def forward(self, x):
        b, h, w, c = x.shape
        nh, d = self.num_heads, c // self.num_heads
        qkv = self.qkv(x).reshape(b, h * w, 3, nh, d).permute(2, 0, 3, 1, 4).reshape(3, b * nh, h * w, d)
        q, k, v = qkv[0], qkv[1], qkv[2]
        rh, rw = rel_pos_table(self.rel_pos_h, h), rel_pos_table(self.rel_pos_w, w)
        q_grid = q.reshape(b * nh, h, w, d)

        def bias(lo, hi):
            th = torch.einsum("nyxd,ykd->nyxk", q_grid[lo:hi], rh)  # [n, h, w, key rows]
            tw = torch.einsum("nyxd,xkd->nyxk", q_grid[lo:hi], rw)  # [n, h, w, key columns]
            return (th[:, :, :, :, None] + tw[:, :, :, None, :]).reshape(hi - lo, h * w, h * w)

        out = softmax_attention(q, k, v, bias)
        out = out.reshape(b, nh, h, w, d).permute(0, 2, 3, 1, 4).reshape(b, h, w, c)
        return self.proj(out)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, act):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.act = act

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class Block(nn.Module):
    """Pre-norm transformer block; ``window`` > 0 attends within windows of
    that size over the grid zero-padded to a multiple of it."""

    def __init__(self, dim: int, num_heads: int, window: int, grid: int):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, window if window > 0 else grid)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, 4 * dim, F.gelu)

    def forward(self, x):
        b, h, w, c = x.shape
        y = self.norm1(x)
        if self.window > 0:
            s = self.window
            hp, wp = -(-h // s) * s, -(-w // s) * s
            y = F.pad(y, (0, 0, 0, wp - w, 0, hp - h))
            y = y.reshape(b, hp // s, s, wp // s, s, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, s, s, c)
            y = self.attn(y)
            y = y.reshape(b, hp // s, wp // s, s, s, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
            y = y[:, :h, :w]
        else:
            y = self.attn(y)
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)


class ImageEncoder(nn.Module):
    def __init__(self, img_size: int, dim: int, depth: int, num_heads: int, global_attn_indexes: Sequence[int],
                 window_size: int = 14, patch_size: int = 16, out_chans: int = 256):
        super().__init__()
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(dim, patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, dim))
        self.blocks = nn.ModuleList([
            Block(dim, num_heads, 0 if i in global_attn_indexes else window_size, grid) for i in range(depth)
        ])
        self.neck = nn.Sequential(
            nn.Conv2d(dim, out_chans, 1, bias=False), LayerNorm2d(out_chans),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False), LayerNorm2d(out_chans),
        )

    def forward(self, x):
        x = self.patch_embed.proj(x).permute(0, 2, 3, 1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.zeros(2, num_pos_feats))

    def forward(self, coords):
        """Coordinates in [0, 1] -> [..., 2 num_pos_feats] Fourier features."""
        c = 2 * math.pi * ((2 * coords - 1) @ self.positional_encoding_gaussian_matrix)
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int, grid: int, img_size: int):
        super().__init__()
        self.grid, self.img_size = grid, img_size
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList([nn.Embedding(1, embed_dim) for _ in range(4)])
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def dense_pe(self):
        """[C, grid, grid]: the encoding of each embedding cell's centre."""
        dev = self.no_mask_embed.weight.device
        c = (torch.arange(self.grid, dtype=torch.float32, device=dev) + 0.5) / self.grid
        y, x = torch.meshgrid(c, c, indexing="ij")
        return self.pe_layer(torch.stack([x, y], dim=-1)).permute(2, 0, 1)

    def points(self, xy, labels):
        """xy [B, P, 2] in input pixels, labels [B, P] (1 foreground, 0
        background, -1 padding) -> [B, P, C]."""
        e = self.pe_layer((xy + 0.5) / self.img_size)
        e = torch.where((labels == -1)[..., None], torch.zeros_like(e), e)
        e = e + torch.where((labels == -1)[..., None], self.not_a_point_embed.weight[0], 0.0)
        e = e + torch.where((labels == 0)[..., None], self.point_embeddings[0].weight[0], 0.0)
        return e + torch.where((labels == 1)[..., None], self.point_embeddings[1].weight[0], 0.0)


class DecoderAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, downsample: int = 1):
        super().__init__()
        inner = dim // downsample
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def forward(self, q, k, v):
        heads = lambda t: t.reshape(t.shape[0], t.shape[1], self.num_heads, -1).transpose(1, 2).flatten(0, 1)
        b, nq = q.shape[:2]
        out = softmax_attention(heads(self.q_proj(q)), heads(self.k_proj(k)), heads(self.v_proj(v)))
        return self.out_proj(out.reshape(b, self.num_heads, nq, -1).transpose(1, 2).reshape(b, nq, -1))


class TwoWayBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int, skip_first_layer_pe: bool):
        super().__init__()
        self.self_attn = DecoderAttention(dim, num_heads)
        self.norm1 = nn.LayerNorm(dim)
        self.cross_attn_token_to_image = DecoderAttention(dim, num_heads, 2)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = MLPBlock(dim, mlp_dim, F.relu)
        self.norm3 = nn.LayerNorm(dim)
        self.norm4 = nn.LayerNorm(dim)
        self.cross_attn_image_to_token = DecoderAttention(dim, num_heads, 2)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        queries = self.norm2(queries + self.cross_attn_token_to_image(queries + query_pe, keys + key_pe, keys))
        queries = self.norm3(queries + self.mlp(queries))
        keys = self.norm4(keys + self.cross_attn_image_to_token(keys + key_pe, queries + query_pe, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int, depth: int = 2):
        super().__init__()
        self.layers = nn.ModuleList([TwoWayBlock(dim, num_heads, mlp_dim, i == 0) for i in range(depth)])
        self.final_attn_token_to_image = DecoderAttention(dim, num_heads, 2)
        self.norm_final_attn = nn.LayerNorm(dim)


class MLP(nn.Module):
    def __init__(self, dims: Sequence[int]):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])])

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, dim: int = 256, num_heads: int = 8, mlp_dim: int = 2048, num_mask_tokens: int = 4):
        super().__init__()
        self.iou_token = nn.Embedding(1, dim)
        self.mask_tokens = nn.Embedding(num_mask_tokens, dim)
        self.transformer = TwoWayTransformer(dim, num_heads, mlp_dim)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(dim, dim // 4, 2, 2), LayerNorm2d(dim // 4), nn.GELU(),
            nn.ConvTranspose2d(dim // 4, dim // 8, 2, 2), nn.GELU(),
        )
        self.output_hypernetworks_mlps = nn.ModuleList([MLP((dim, dim, dim, dim // 8))
                                                        for _ in range(num_mask_tokens)])
        self.iou_prediction_head = MLP((dim, 256, 256, num_mask_tokens))

    def forward(self, embed, dense_pe, sparse, no_mask):
        """embed [1, C, h, w], dense_pe [C, h, w], sparse [B, P, C], no_mask
        [C] -> low-res mask logits [B, T, 4h, 4w] and IoU predictions [B, T]."""
        b = sparse.shape[0]
        _, c, h, w = embed.shape
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        tokens = torch.cat([out_tokens[None].expand(b, -1, -1), sparse], dim=1)
        keys = (embed[0] + no_mask[:, None, None]).reshape(c, h * w).t()[None].expand(b, -1, -1)
        key_pe = dense_pe.reshape(c, h * w).t()[None].expand(b, -1, -1)
        tr = self.transformer
        queries = tokens
        for layer in tr.layers:
            queries, keys = layer(queries, keys, tokens, key_pe)
        queries = tr.norm_final_attn(queries + tr.final_attn_token_to_image(queries + tokens, keys + key_pe, keys))
        up = self.output_upscaling(keys.transpose(1, 2).reshape(b, c, h, w))
        t = self.mask_tokens.weight.shape[0]
        hyper = torch.stack([mlp(queries[:, 1 + i]) for i, mlp in enumerate(self.output_hypernetworks_mlps)], 1)
        masks = torch.matmul(hyper, up.reshape(b, up.shape[1], -1)).reshape(b, t, up.shape[2], up.shape[3])
        return masks, self.iou_prediction_head(queries[:, 0])


class SamNet(nn.Module):
    """The three networks under the official checkpoint's top-level names."""

    def __init__(self, img_size: int = 1024, dim: int = 1280, depth: int = 32, num_heads: int = 16,
                 global_attn_indexes: Sequence[int] = (7, 15, 23, 31), window_size: int = 14):
        super().__init__()
        self.img_size, self.grid = img_size, img_size // 16
        self.image_encoder = ImageEncoder(img_size, dim, depth, num_heads, global_attn_indexes, window_size)
        self.prompt_encoder = PromptEncoder(256, self.grid, img_size)
        self.mask_decoder = MaskDecoder()

    @torch.inference_mode()
    def encode(self, x, tf32: bool = False):
        """[B, 3, S, S] normalised and padded -> the image embedding [B, 256, S/16, S/16]."""
        with matmul_precision(tf32):
            return self.image_encoder(x)

    @torch.inference_mode()
    def decode(self, embed, xy, tf32: bool = False, batch: int = 64):
        """Single-point prompts ``xy`` [P, 2] (input pixels) on one image
        embedding [1, C, h, w], ``batch`` at a time -> low-res logits
        [P, 4, 4h, 4w] and IoU predictions [P, 4], every mask token."""
        pe, dec = self.prompt_encoder, self.mask_decoder
        masks, ious = [], []
        with matmul_precision(tf32):
            dense_pe, no_mask = pe.dense_pe(), pe.no_mask_embed.weight[0]
            for i in range(0, xy.shape[0], batch):
                p = xy[i:i + batch]
                pts = torch.stack([p, torch.zeros_like(p)], dim=1)  # the point and a padding point
                labels = torch.tensor([1, -1], device=p.device).expand(p.shape[0], 2)
                m, q = dec(embed, dense_pe, pe.points(pts, labels), no_mask)
                masks.append(m)
                ious.append(q)
        return torch.cat(masks), torch.cat(ious)
