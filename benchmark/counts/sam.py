"""FP32 operations of one pass of SAM's image encoder, counted from the shapes
of the benchmark's own copy of the network (``reference/depthnet/sam.py``),
run on the meta device: each linear layer 2 x in x out per token, each
convolution 2 x (in / groups) x kh x kw per output element, and each
attention over N tokens of width C (all heads) 4 x N^2 x C for its two
products plus 2 x N x (h + w) x C for the decomposed relative-position terms
of an h x w grid. Only the image's own tokens are counted: a windowed block
pads the grid with zeros to a multiple of its window (64 x 64 to 70 x 70 at
1024 pixels), and its attention module's work (projections, products and
relative positions) is counted for the real queries alone, each against the
keys of its window, padded ones included, as SAM's softmax takes them; the
padded tokens' own projections are their biases, no work. Elementwise work,
the norms and the softmaxes are left out, so the count is a lower bound of
the work the image needs."""
from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def encoder_ops(img_size: int, variant: str = "vit_h", **widths) -> int:
    """Operations of one encoder pass on one image of ``img_size`` pixels;
    ``widths`` (dim, depth, num_heads, global_attn_indexes, window_size)
    replace the published variant's."""
    from ..reference.depthnet import sam as R

    arch = dict(R.VARIANTS[variant], **widths) if variant else dict(widths)
    with torch.device("meta"):
        net = R.SamNet(img_size=img_size, **arch).image_encoder
    total = [0]
    grid = img_size // 16
    share = {}  # a windowed block's attention modules -> (real tokens, padded tokens) of its grid
    for blk in net.blocks:
        if blk.window > 0:
            padded = (-(-grid // blk.window) * blk.window) ** 2
            share.update({m: (grid * grid, padded) for m in blk.attn.modules()})

    def hook(mod, inputs, out):
        x = inputs[0]
        if isinstance(mod, nn.Linear):
            n = 2 * mod.in_features * mod.out_features * (x.numel() // mod.in_features)
        elif isinstance(mod, nn.Conv2d):
            kh, kw = mod.kernel_size
            n = 2 * out.numel() * (mod.in_channels // mod.groups) * kh * kw
        else:
            b, h, w, c = x.shape
            n = 4 * b * (h * w) ** 2 * c + 2 * b * h * w * (h + w) * c
        real, padded = share.get(mod, (1, 1))
        total[0] += n * real // padded  # exact: every term holds the padded token count

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (nn.Linear, nn.Conv2d, R.Attention))]
    try:
        net(torch.zeros((1, 3, img_size, img_size), device="meta"))
    finally:
        for h in handles:
            h.remove()
    return total[0]
