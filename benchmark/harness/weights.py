"""A network's random weights, made on the device from the seed in a few large
calls and handed to both the program and the reference as one state dict.

The distributions are those the port's random initialisation uses
(flax's defaults): weights normal with variance 1 / fan_in (fan_in over the
input channels and the kernel window; a transposed convolution's weight is
[in, out, kh, kw]), biases 0, 1-D scales 1, position embeddings
normal(0, 0.02), class and register tokens 0.
"""
from __future__ import annotations

import math

import torch
from torch import nn

ZERO = ("cls_token", "register_tokens")


@torch.no_grad()
def random_state_dict(module: nn.Module, seed: int, device) -> dict:
    """Every parameter and buffer of ``module`` (which may live on the meta
    device), drawn from one standard-normal buffer on ``device``."""
    plan = []  # (key, shape, std or a constant)
    for mname, mod in module.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            key = f"{mname}.{name}" if mname else name
            if name in ZERO or name == "bias":
                plan.append((key, p.shape, ("const", 0.0)))
            elif name == "pos_embed":
                plan.append((key, p.shape, ("normal", 0.02)))
            elif p.ndim == 1:
                plan.append((key, p.shape, ("const", 1.0)))
            else:
                if isinstance(mod, nn.ConvTranspose2d):
                    fan_in = p.shape[0] * p.shape[2] * p.shape[3]
                else:
                    fan_in = math.prod(p.shape[1:])
                plan.append((key, p.shape, ("normal", 1.0 / math.sqrt(fan_in))))
    n = sum(math.prod(s) for _, s, (kind, _) in plan if kind == "normal")
    g = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    buf = torch.randn((n,), generator=g, device=device)
    sd, at = {}, 0
    for key, shape, (kind, v) in plan:
        if kind == "normal":
            k = math.prod(shape)
            sd[key] = buf[at:at + k].view(shape).mul_(v)
            at += k
        else:
            sd[key] = torch.full(shape, v, device=device)
    for key, b in module.named_buffers():
        sd[key] = torch.zeros(b.shape, dtype=b.dtype, device=device)
    return sd
