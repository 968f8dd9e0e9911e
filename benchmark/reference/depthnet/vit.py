"""DINOv2-style Vision Transformer backbone — port of
``gs_init_tpu/models/vit.py``.

Patch embed (14x14), cls token (+ optional register tokens), position
embeddings interpolated to the patch grid, pre-norm blocks with LayerScale,
exact-GELU MLP. Parameter names are the DINOv2 checkpoints' (``patch_embed.
proj``, ``blocks.{i}.attn.qkv``, ``ls1.gamma``, ``norm``), so an official
state dict loads by name. LayerNorm eps is 1e-6, as DINOv2's and flax's.

Attention goes to ``F.scaled_dot_product_attention`` (the JAX package
computes it with plain XLA ops, outside any Pallas kernel). Feature maps
come out channels-first, [B, D, h, w].
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import jax_resize_matrix, torch_bicubic_matrix

# DinoViT's flax module paths against its torch names (state_dict_from_flax).
VIT_RENAMES = (
    (r"(^|/)blocks_(\d+)", r"\1blocks/\2"),
    (r"(^|/)patch_embed$", r"\1patch_embed/proj"),
)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, d = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, h, d // h).permute(2, 0, 3, 1, 4)  # [3, B, H, N, Dh]
        out = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
        return self.proj(out.transpose(1, 2).reshape(b, n, d))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch_size: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)

    def forward(self, x):
        return self.proj(x)


@functools.lru_cache(maxsize=32)
def _pos_matrices(n: int, ph: int, pw: int, mode: str, offset: float):
    if mode == "torch":  # DINOv2's interpolate_pos_encoding: scale (size + offset) / n
        return (torch_bicubic_matrix(n, ph, (ph + offset) / n),
                torch_bicubic_matrix(n, pw, (pw + offset) / n))
    if mode == "resize":  # jax.image.resize(..., "bicubic")
        eye = np.eye(n, dtype=np.float32)
        return (eye if ph == n else jax_resize_matrix(n, ph, "cubic"),
                eye if pw == n else jax_resize_matrix(n, pw, "cubic"))
    raise ValueError(f"unknown pos_interp {mode!r}")


class DinoViT(nn.Module):
    """Returns, per entry of ``out_layers``, that block's output (after the
    final LayerNorm where ``out_layers_norm`` says so; all by default) as
    patch features [B, D, h, w] and prefix tokens [B, 1 + registers, D]."""

    def __init__(
        self,
        dim: int = 384,
        depth: int = 12,
        num_heads: int = 6,
        patch_size: int = 14,
        num_register_tokens: int = 0,
        out_layers: Sequence[int] = (2, 5, 8, 11),
        pos_embed_size: int = 37,
        pos_interp: str = "resize",
        interpolate_offset: float = 0.1,
        out_layers_norm: Optional[Sequence[bool]] = None,
    ):
        super().__init__()
        self.dim, self.patch_size = dim, patch_size
        self.num_register_tokens = num_register_tokens
        self.out_layers = tuple(out_layers)
        self.out_layers_norm = tuple(out_layers_norm or (True,) * len(self.out_layers))
        self.pos_embed_size = pos_embed_size
        self.pos_interp, self.interpolate_offset = pos_interp, interpolate_offset
        self.patch_embed = PatchEmbed(dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_embed_size * pos_embed_size + 1, dim))
        if num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, num_register_tokens, dim))
        self.blocks = nn.ModuleList(Block(dim, num_heads) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def interpolated_pos(self, ph: int, pw: int) -> torch.Tensor:
        """The patch position embeddings on a ph x pw grid, [ph * pw, D]."""
        n, d = self.pos_embed_size, self.dim
        grid = self.pos_embed[0, 1:].reshape(n, n, d)
        if (ph, pw) != (n, n):
            wh, ww = _pos_matrices(n, ph, pw, self.pos_interp, self.interpolate_offset)
            wh = torch.tensor(wh, device=grid.device, dtype=grid.dtype)
            ww = torch.tensor(ww, device=grid.device, dtype=grid.dtype)
            grid = torch.einsum("hH,wW,HWd->hwd", wh, ww, grid)
        return grid.reshape(ph * pw, d)

    def forward(self, x: torch.Tensor) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """x: [B, 3, H, W] normalised; H, W multiples of patch_size."""
        b = x.shape[0]
        ph, pw = x.shape[2] // self.patch_size, x.shape[3] // self.patch_size
        x = self.patch_embed(x).flatten(2).transpose(1, 2)  # [B, N, D]
        x = x + self.interpolated_pos(ph, pw)
        tokens = [(self.cls_token + self.pos_embed[:, :1]).expand(b, 1, self.dim)]
        if self.num_register_tokens:
            tokens.append(self.register_tokens.expand(b, -1, -1))
        x = torch.cat(tokens + [x], dim=1)
        n_prefix = 1 + self.num_register_tokens
        feats = {}
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.out_layers:
                feats[i] = x
        outs, prefix_outs = [], []
        for layer, do_norm in zip(self.out_layers, self.out_layers_norm):
            y = self.norm(feats[layer]) if do_norm else feats[layer]
            outs.append(y[:, n_prefix:].transpose(1, 2).reshape(b, self.dim, ph, pw))
            prefix_outs.append(y[:, :n_prefix])
        return outs, prefix_outs


def from_hf_dinov2(sd: dict, src: str, dst: str, depth: int) -> dict:
    """A HuggingFace ``Dinov2Model`` subtree of the state dict ``sd`` (torch
    tensors) under ``src`` renamed to ``DinoViT``'s names under ``dst``;
    query, key and value concatenated into ``qkv``."""
    out = {
        f"{dst}.cls_token": sd[f"{src}.embeddings.cls_token"],
        f"{dst}.pos_embed": sd[f"{src}.embeddings.position_embeddings"],
    }
    for leaf in ("weight", "bias"):
        out[f"{dst}.patch_embed.proj.{leaf}"] = sd[f"{src}.embeddings.patch_embeddings.projection.{leaf}"]
        out[f"{dst}.norm.{leaf}"] = sd[f"{src}.layernorm.{leaf}"]
    for i in range(depth):
        s, t = f"{src}.encoder.layer.{i}", f"{dst}.blocks.{i}"
        att = f"{s}.attention.attention"
        for leaf in ("weight", "bias"):
            out[f"{t}.attn.qkv.{leaf}"] = torch.cat(
                [torch.as_tensor(sd[f"{att}.{q}.{leaf}"]) for q in ("query", "key", "value")], 0
            )
            out[f"{t}.attn.proj.{leaf}"] = sd[f"{s}.attention.output.dense.{leaf}"]
            for m in ("norm1", "norm2", "mlp.fc1", "mlp.fc2"):
                out[f"{t}.{m}.{leaf}"] = sd[f"{s}.{m}.{leaf}"]
        out[f"{t}.ls1.gamma"] = sd[f"{s}.layer_scale1.lambda1"]
        out[f"{t}.ls2.gamma"] = sd[f"{s}.layer_scale2.lambda1"]
    return out


VIT_CONFIGS = {
    "vits": dict(dim=384, depth=12, num_heads=6, out_layers=(2, 5, 8, 11)),
    "vitb": dict(dim=768, depth=12, num_heads=12, out_layers=(2, 5, 8, 11)),
    "vitl": dict(dim=1024, depth=24, num_heads=16, out_layers=(4, 11, 17, 23)),
    "vitg": dict(dim=1536, depth=40, num_heads=24, out_layers=(9, 19, 29, 39)),
}
