"""FP32 operations of one Metric3D v2 forward pass, counted from its layers'
shapes on the benchmark's own copy of the network (``reference/depthnet``):
each linear layer 2 x in x out per token, each convolution 2 x (in / groups)
x kh x kw per output element, each transposed convolution 2 x (out /
groups) x kh x kw per input element, and each attention 4 x N^2 x D per
batch (the two products of N tokens of width D). Elementwise work, the
softmaxes, the convex upsampling and the resizes are left out, so the count
is a lower bound of the work."""
from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def metric3d_ops(backbone: str, dev, batch: int = 1) -> int:
    from ..reference.depthnet import metric3d as M
    from ..reference.depthnet.vit import Attention

    with torch.device("meta"):
        net = M.Metric3DNet(backbone)
    net = net.to_empty(device=dev)
    for p in net.parameters():  # finite values: the count does not depend on them
        p.normal_(0.0, 0.02)
    total = [0]

    def hook(mod, inputs, out):
        x = inputs[0]
        if isinstance(mod, nn.Linear):
            total[0] += 2 * mod.in_features * mod.out_features * (x.numel() // mod.in_features)
        elif isinstance(mod, nn.ConvTranspose2d):
            kh, kw = mod.kernel_size
            total[0] += 2 * x.numel() * (mod.out_channels // mod.groups) * kh * kw
        elif isinstance(mod, nn.Conv2d):
            kh, kw = mod.kernel_size
            total[0] += 2 * out.numel() * (mod.in_channels // mod.groups) * kh * kw
        elif isinstance(mod, Attention):
            b, n, d = x.shape
            total[0] += 4 * b * n * n * d

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d, Attention))]
    try:
        net(torch.zeros((batch, 3) + M.CROP, device=dev))
    finally:
        for h in handles:
            h.remove()
    del net
    return total[0] // batch
