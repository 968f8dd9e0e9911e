"""SAM weights — port of ``gs_init_tpu/mdi/predictors/sam_convert.py``.

The port's ``models.sam.Sam`` carries the official ``segment_anything``
parameter names, so ``sam_vit_{b,l,h}_*.pth`` loads as its own state dict
(``load_sam_state_dict``; keys the inference graph never reads, such as
the prompt encoder's mask downscaling, are ignored).
``state_dict_from_flax`` carries the JAX package's variables across (the
``{"encoder", "prompt", "decoder"}`` params that its
``convert_sam_checkpoint`` returns), for the parity tests.
"""
from __future__ import annotations

import numpy as np

from ...models.common import load_checked
from ...models.common import state_dict_from_flax as _from_flax

SAM_VARIANTS = {
    "vit_b": dict(dim=768, depth=12, num_heads=12, global_attn_indexes=(2, 5, 8, 11)),
    "vit_l": dict(dim=1024, depth=24, num_heads=16, global_attn_indexes=(5, 11, 17, 23)),
    "vit_h": dict(dim=1280, depth=32, num_heads=16, global_attn_indexes=(7, 15, 23, 31)),
}

# The JAX package's SAM module paths against the official names.
SAM_RENAMES = (
    (r"^encoder", "image_encoder"),
    (r"^prompt", "prompt_encoder"),
    (r"^decoder", "mask_decoder"),
    (r"/patch_embed$", "/patch_embed/proj"),
    (r"/blocks_(\d+)", r"/blocks/\1"),
    (r"/neck_(\d)", r"/neck/\1"),
    (r"/mlp_lin(\d)", r"/mlp/lin\1"),
    (r"^mask_decoder/layer_(\d)", r"mask_decoder/transformer/layers/\1"),
    (r"^mask_decoder/final_attn", "mask_decoder/transformer/final_attn_token_to_image"),
    (r"^mask_decoder/norm_final$", "mask_decoder/transformer/norm_final_attn"),
    (r"/upscale_(\d)", r"/output_upscaling/\1"),
    (r"/hyper_(\d)_lin(\d)", r"/output_hypernetworks_mlps/\1/layers/\2"),
    (r"/iou_lin(\d)", r"/iou_prediction_head/layers/\1"),
)
SAM_TRANSPOSED = (r"decoder/upscale_\d",)


def load_sam_state_dict(sam, state_dict: dict):
    """Load an official-layout SAM state dict into ``models.sam.Sam``."""
    return load_checked(sam, state_dict, "sam")


def state_dict_from_flax(variables: dict) -> dict:
    """The JAX package's SAM variables, ``{"encoder": ..., "prompt": ...,
    "decoder": ...}`` (each a params dict, or under ``"params"``), -> the
    port's ``Sam`` state dict. The prompt encoder's and the decoder's token
    leaves become the official embedding tables."""
    p = {k: v.get("params", v) for k, v in variables.get("params", variables).items()}
    prompt = dict(p["prompt"])
    emb = lambda v: {"weight": np.asarray(v)[None]}
    nested_prompt = {
        "pe_layer": {"positional_encoding_gaussian_matrix": prompt.pop("pe_gaussian")},
        "point_embeddings": {str(i): emb(prompt.pop(f"point_embed_{i}")) for i in range(4)},
        "not_a_point_embed": emb(prompt.pop("not_a_point_embed")),
        "no_mask_embed": emb(prompt.pop("no_mask_embed")),
    }
    decoder = dict(p["decoder"])
    decoder["iou_token"] = {"weight": decoder.pop("iou_token")}
    decoder["mask_tokens"] = {"weight": decoder.pop("mask_tokens")}
    return _from_flax(
        {"encoder": p["encoder"], "prompt": nested_prompt, "decoder": decoder}, SAM_RENAMES, SAM_TRANSPOSED
    )
