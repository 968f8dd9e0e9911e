"""Segment Anything (SAM): ViT image encoder, prompt encoder and two-way
mask decoder — port of ``gs_init_tpu/models/sam.py``.

Parameter names are the official ``segment_anything`` checkpoint's
(``image_encoder.blocks.{i}.attn.rel_pos_h``, ``prompt_encoder.pe_layer.
positional_encoding_gaussian_matrix``, ``mask_decoder.transformer.layers.
{i}.cross_attn_token_to_image.q_proj`` ...), so ``sam_vit_h_4b8939.pth``
loads by name (``mdi/predictors/sam_convert.py``).

- ``SamImageEncoder``: 16x16 patch embed, learned absolute position
  embedding, blocks with decomposed relative-position attention (windowed,
  14x14, except at the global-attention indexes), a two-conv neck with
  LayerNorm2d. Its attention is written out: the relative-position bias is
  added to the scores before the softmax.
- ``SamPromptEncoder``: random-Fourier positional encoding, learned point
  embeddings, the no-mask dense embedding.
- ``SamMaskDecoder``: IoU and mask tokens, the two-way transformer (depth
  2), transposed-conv upscaling, per-token hypernetwork MLPs, the IoU head.
  Its attention has no bias and goes to ``F.scaled_dot_product_attention``.

Images and embeddings are channels-first ([B, 3, S, S] in, [B, 256, S/16,
S/16] out); the JAX package's are channels-last.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import init_random_, jax_resize_matrix, resize


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of [B, C, H, W]."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        mu = x.mean(1, keepdim=True)
        var = ((x - mu) ** 2).mean(1, keepdim=True)
        return (x - mu) / torch.sqrt(var + self.eps) * self.weight[:, None, None] + self.bias[:, None, None]


def rel_pos_resized(rel_pos: torch.Tensor, q_size: int, k_size: int) -> torch.Tensor:
    """Relative position embeddings [q, k, head] for the (q, k) index
    deltas; a table of another length is first resized linearly, as
    ``jax.image.resize`` does."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        w = torch.tensor(jax_resize_matrix(rel_pos.shape[0], max_rel_dist, "linear"),
                         device=rel_pos.device, dtype=rel_pos.dtype)
        rel_pos = w @ rel_pos
    qc = torch.arange(q_size, device=rel_pos.device)[:, None] * max(k_size / q_size, 1.0)
    kc = torch.arange(k_size, device=rel_pos.device)[None, :] * max(q_size / k_size, 1.0)
    rel = (qc - kc) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


class WindowAttention(nn.Module):
    """Multi-head attention with decomposed relative positions over [B, H, W, C]."""

    def __init__(self, dim: int, num_heads: int, input_size: Tuple[int, int]):
        super().__init__()
        self.num_heads = num_heads
        head = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, head))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, head))

    def forward(self, x):
        b, h, w, dim = x.shape
        nh = self.num_heads
        head = dim // nh
        qkv = self.qkv(x.reshape(b, h * w, dim)).reshape(b, h * w, 3, nh, head)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).reshape(3, b * nh, h * w, head)
        attn = (q * head**-0.5) @ k.transpose(-2, -1)
        r_q = q.reshape(b * nh, h, w, head)
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rel_pos_resized(self.rel_pos_h, h, h))
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rel_pos_resized(self.rel_pos_w, w, w))
        attn = attn.view(b * nh, h, w, h, w) + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]
        attn = attn.view(b * nh, h * w, h * w).softmax(dim=-1)
        out = (attn @ v).view(b, nh, h * w, head).permute(0, 2, 1, 3).reshape(b, h, w, dim)
        return self.proj(out)


def window_partition(x, win: int):
    b, h, w, c = x.shape
    ph, pw = (win - h % win) % win, (win - w % win) % win
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // win, win, wp // win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win, win, c), (hp, wp)


def window_unpartition(x, win: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // (hp // win * (wp // win))
    x = x.view(b, hp // win, wp // win, win, win, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, act=F.gelu):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.act = act

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, input_size: Tuple[int, int],
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = WindowAttention(
            dim, num_heads, (window_size, window_size) if window_size > 0 else input_size
        )
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        hw = x.shape[1:3]
        if self.window_size > 0:
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, hw)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)


class SamImageEncoder(nn.Module):
    def __init__(
        self,
        img_size: int = 1024,
        patch_size: int = 16,
        dim: int = 1280,  # vit_h
        depth: int = 32,
        num_heads: int = 16,
        window_size: int = 14,
        global_attn_indexes: Sequence[int] = (7, 15, 23, 31),
        out_chans: int = 256,
    ):
        super().__init__()
        g = img_size // patch_size
        self.patch_embed = PatchEmbed(dim, patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, dim))
        self.blocks = nn.ModuleList([
            EncoderBlock(dim, num_heads, 0 if i in global_attn_indexes else window_size, (g, g))
            for i in range(depth)
        ])
        self.neck = nn.Sequential(
            nn.Conv2d(dim, out_chans, 1, bias=False),
            LayerNorm2d(out_chans),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            LayerNorm2d(out_chans),
        )

    def forward(self, x):
        """x: [B, 3, S, S] normalised -> [B, out_chans, S/16, S/16]."""
        x = self.patch_embed.proj(x).permute(0, 2, 3, 1)
        pos = self.pos_embed
        if x.shape[1:3] != pos.shape[1:3]:
            pos = resize(pos.permute(0, 3, 1, 2), tuple(x.shape[1:3]), "bicubic").permute(0, 2, 3, 1)
        x = x + pos
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.zeros(2, num_pos_feats))

    def forward(self, coords):
        """coords in [0, 1] -> random Fourier features [..., 2 num_pos_feats]."""
        c = (2.0 * coords - 1.0) @ self.positional_encoding_gaussian_matrix
        c = 2.0 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class SamPromptEncoder(nn.Module):
    def __init__(self, embed_dim: int = 256, image_embedding_size=(64, 64), input_image_size=(1024, 1024)):
        super().__init__()
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        # 0: negative point, 1: positive point, 2/3: box corners.
        self.point_embeddings = nn.ModuleList([nn.Embedding(1, embed_dim) for _ in range(4)])
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def dense_pe(self):
        """[h, w, C] positional encoding of the embedding grid."""
        h, w = self.image_embedding_size
        dev = self.no_mask_embed.weight.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        return self.pe_layer(torch.stack([gx, gy], dim=-1))

    def forward(self, points, labels):
        """points [B, P, 2] pixel xy; labels [B, P] (1 positive, 0 negative,
        -1 padding). Returns (sparse [B, P, C], the no-mask embedding [C])."""
        size = torch.tensor([self.input_image_size[1], self.input_image_size[0]],
                            dtype=torch.float32, device=points.device)
        pe = self.pe_layer((points + 0.5) / size)
        pad = (labels == -1)[..., None]
        pe = torch.where(pad, 0.0, pe)
        emb = torch.where(
            pad, self.not_a_point_embed.weight[0],
            torch.where((labels == 1)[..., None], self.point_embeddings[1].weight[0],
                        self.point_embeddings[0].weight[0]),
        )
        return pe + emb, self.no_mask_embed.weight[0]


class DecoderAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        d = embed_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, d)
        self.k_proj = nn.Linear(embed_dim, d)
        self.v_proj = nn.Linear(embed_dim, d)
        self.out_proj = nn.Linear(d, embed_dim)

    def forward(self, q, k, v):
        split = lambda t: t.reshape(t.shape[0], t.shape[1], self.num_heads, -1).transpose(1, 2)
        out = F.scaled_dot_product_attention(split(self.q_proj(q)), split(self.k_proj(k)), split(self.v_proj(v)))
        b, _, n, _ = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, -1))


class TwoWayBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, mlp_dim: int, skip_first_layer_pe: bool = False):
        super().__init__()
        self.self_attn = DecoderAttention(embed_dim, num_heads)
        self.norm1 = nn.LayerNorm(embed_dim)
        self.cross_attn_token_to_image = DecoderAttention(embed_dim, num_heads, 2)
        self.norm2 = nn.LayerNorm(embed_dim)
        self.mlp = MLPBlock(embed_dim, mlp_dim, act=F.relu)
        self.norm3 = nn.LayerNorm(embed_dim)
        self.norm4 = nn.LayerNorm(embed_dim)
        self.cross_attn_image_to_token = DecoderAttention(embed_dim, num_heads, 2)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, mlp_dim: int):
        super().__init__()
        self.layers = nn.ModuleList([
            TwoWayBlock(embed_dim, num_heads, mlp_dim, skip_first_layer_pe=(i == 0)) for i in range(2)
        ])
        self.final_attn_token_to_image = DecoderAttention(embed_dim, num_heads, 2)
        self.norm_final_attn = nn.LayerNorm(embed_dim)


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


class SamMaskDecoder(nn.Module):
    def __init__(self, embed_dim: int = 256, num_heads: int = 8, mlp_dim: int = 2048,
                 num_multimask: int = 3, iou_head_hidden: int = 256):
        super().__init__()
        c, t = embed_dim, num_multimask + 1
        self.iou_token = nn.Embedding(1, c)
        self.mask_tokens = nn.Embedding(t, c)
        self.transformer = TwoWayTransformer(c, num_heads, mlp_dim)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(c, c // 4, 2, 2), LayerNorm2d(c // 4), nn.GELU(),
            nn.ConvTranspose2d(c // 4, c // 8, 2, 2), nn.GELU(),
        )
        self.output_hypernetworks_mlps = nn.ModuleList([MLP((c, c, c, c // 8)) for _ in range(t)])
        self.iou_prediction_head = MLP((c, iou_head_hidden, iou_head_hidden, t))

    def forward(self, image_embed, image_pe, sparse_prompt, dense_embed):
        """image_embed [B or 1, C, h, w]; image_pe [h, w, C]; sparse_prompt
        [B, P, C]; dense_embed [C] (no mask). Returns (masks [B, T, 4h, 4w],
        iou_pred [B, T]) with T = 1 + num_multimask."""
        b = sparse_prompt.shape[0]
        _, c, h, w = image_embed.shape
        tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        tokens = torch.cat([tokens[None].expand(b, -1, -1), sparse_prompt], dim=1)
        src = (image_embed + dense_embed[None, :, None, None]).flatten(2).transpose(1, 2).expand(b, -1, -1)
        pos = image_pe.reshape(1, h * w, c).expand(b, -1, -1)
        tr = self.transformer
        queries, keys = tokens, src
        for layer in tr.layers:
            queries, keys = layer(queries, keys, tokens, pos)
        queries = tr.norm_final_attn(queries + tr.final_attn_token_to_image(queries + tokens, keys + pos, keys))
        x = self.output_upscaling(keys.transpose(1, 2).reshape(b, c, h, w))
        hyper = torch.stack(
            [mlp(queries[:, 1 + i]) for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1
        )
        masks = torch.einsum("btc,bchw->bthw", hyper, x)
        return masks, self.iou_prediction_head(queries[:, 0])


class Sam(nn.Module):
    """The three networks under the official checkpoint's top-level names."""

    def __init__(self, img_size: int = 1024, dim: int = 1280, depth: int = 32, num_heads: int = 16,
                 global_attn_indexes: Sequence[int] = (7, 15, 23, 31), window_size: int = 14):
        super().__init__()
        emb = img_size // 16
        self.image_encoder = SamImageEncoder(
            img_size=img_size, dim=dim, depth=depth, num_heads=num_heads, window_size=window_size,
            global_attn_indexes=global_attn_indexes,
        )
        self.prompt_encoder = SamPromptEncoder(image_embedding_size=(emb, emb),
                                               input_image_size=(img_size, img_size))
        self.mask_decoder = SamMaskDecoder()


def init_random_sam_(sam: Sam, seed: int) -> Sam:
    """Random weights from ``seed`` (``common.init_random_``), and the
    prompt encoder's Fourier matrix, a buffer, normal(0, 1) as upstream
    draws it."""
    init_random_(sam, seed)
    g = torch.Generator().manual_seed(int(seed) + 1)
    with torch.no_grad():
        sam.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix.normal_(generator=g)
    return sam
