"""FP32 operations of one Depth Pro pass, counted from the shapes of the
benchmark's own copy of the network (``reference/depthnet/depth_pro.py``)
run on the meta device, by the rules of ``depth_net.py``: each linear layer
2 x in x out per token, each convolution 2 x (in / groups) x kh x kw per
output element, each transposed convolution 2 x (out / groups) x kh x kw
per input element, and each attention 4 x N^2 x D per crop (the two products
of N tokens of width D). Elementwise work, the norms, the softmaxes, the
resizes and the merges are left out, so the count is a lower bound of the
work."""
from __future__ import annotations

import torch
from torch import nn

PATCH_ENCODER = "depth_pro.encoder.patch_encoder."


@torch.no_grad()
def ops(size: int = 1536, widths=None) -> dict:
    """Operations of one pass on one ``size`` x ``size`` input at ``widths``
    (the published ones by default): ``total``, and ``patch_encoder``, the
    crops through the shared ViT alone."""
    from ..reference.depthnet import depth_pro as R

    with torch.device("meta"):
        net = R.DepthProNet(**(widths or R.PUBLISHED))
    total = dict(total=0, patch_encoder=0)

    def hook(name):
        def count(mod, inputs, out):
            x = inputs[0]
            if isinstance(mod, nn.Linear):
                n = 2 * mod.in_features * mod.out_features * (x.numel() // mod.in_features)
            elif isinstance(mod, nn.ConvTranspose2d):
                kh, kw = mod.kernel_size
                n = 2 * x.numel() * (mod.out_channels // mod.groups) * kh * kw
            elif isinstance(mod, nn.Conv2d):
                kh, kw = mod.kernel_size
                n = 2 * out.numel() * (mod.in_channels // mod.groups) * kh * kw
            else:
                b, t, d = x.shape
                n = 4 * b * t * t * d
            total["total"] += n
            if name.startswith(PATCH_ENCODER):
                total["patch_encoder"] += n
        return count

    handles = [m.register_forward_hook(hook(name)) for name, m in net.named_modules()
               if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d, R.Attention))]
    try:
        net(torch.zeros((1, 3, size, size), device="meta"))
    finally:
        for h in handles:
            h.remove()
    return total
