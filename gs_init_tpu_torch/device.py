"""Device resolution for the port's entry points.

The default is the card. Without CUDA an entry point raises unless the
caller asked for the CPU explicitly: there is no silent CPU path.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gs_init_tpu_torch runs on CUDA by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions of the kernels"
        )
    return dev


def generator(seed: int, device: Optional[torch.device] = None) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device`` (CPU when None)."""
    g = torch.Generator(device=device if device is not None else "cpu")
    g.manual_seed(int(seed))
    return g
