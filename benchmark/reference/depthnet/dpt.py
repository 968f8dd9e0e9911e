"""DPT (dense prediction transformer) depth head — port of
``gs_init_tpu/models/dpt.py`` (Depth-Anything-V2's head).

Per-stage 1x1 projections, transposed-conv / strided-conv reassembly to a
4-level pyramid, RefineNet-style fusion with residual conv units, and the
two-stage output head; relative models end in ReLU (disparity), metric
models in sigmoid * max_depth. Parameter names are the official DA-V2
checkpoint's (``projects``, ``resize_layers``, ``scratch.layer{i}_rn``,
``scratch.refinenet{i}.resConfUnit{1,2}``, ``scratch.output_conv*``).
Resizes are bilinear with align_corners=True, as the reference's.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import resize_align_corners

# DPTHead's flax module paths against its torch names, and its transposed
# convolutions (state_dict_from_flax).
DPT_RENAMES = (
    (r"(^|/)project_(\d)", r"\1projects/\2"),
    (r"(^|/)resize_(\d)", r"\1resize_layers/\2"),
    (r"(^|/)(layer\d_rn|refinenet\d|output_conv1)", r"\1scratch/\2"),
    (r"(^|/)output_conv2_(\d)", r"\1scratch/output_conv2/\2"),
    (r"/rcu1", "/resConfUnit1"),
    (r"/rcu2", "/resConfUnit2"),
)
DPT_TRANSPOSED = (r"(.*/)?resize_[01]",)


def conv3(cin: int, cout: int, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=bias)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = conv3(features, features)
        self.conv2 = conv3(features, features)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    """``skip=False`` (the deepest block) has no first residual unit: the
    reference builds one there and never calls it."""

    def __init__(self, features: int, skip: bool = True):
        super().__init__()
        if skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, out_hw: Optional[Tuple[int, int]] = None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        if out_hw is None:
            out_hw = (x.shape[2] * 2, x.shape[3] * 2)
        return self.out_conv(resize_align_corners(x, out_hw))


class _Scratch(nn.Module):
    def __init__(self, features: int, out_channels: Sequence[int]):
        super().__init__()
        for i, oc in enumerate(out_channels):
            setattr(self, f"layer{i + 1}_rn", conv3(oc, features, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(features, skip=i != 4))
        self.output_conv1 = conv3(features, features // 2)
        self.output_conv2 = nn.Sequential(conv3(features // 2, 32), nn.ReLU(), nn.Conv2d(32, 1, 1))


class DPTHead(nn.Module):
    def __init__(
        self,
        in_channels: int,
        features: int = 64,
        out_channels: Sequence[int] = (48, 96, 192, 384),
        metric: bool = False,
        max_depth: float = 20.0,
    ):
        super().__init__()
        oc = tuple(out_channels)
        self.metric, self.max_depth = metric, max_depth
        self.projects = nn.ModuleList(nn.Conv2d(in_channels, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1),
        ])
        self.scratch = _Scratch(features, oc)

    def forward(self, feats, patch_hw: Tuple[int, int]) -> torch.Tensor:
        """feats: 4 x [B, D, h, w] transformer features (shallow -> deep);
        returns depth or disparity [B, 14 h, 14 w]."""
        ph, pw = patch_hw
        s = self.scratch
        outs = [rs(pr(f)) for f, pr, rs in zip(feats, self.projects, self.resize_layers)]
        rn = [getattr(s, f"layer{i + 1}_rn")(outs[i]) for i in range(4)]
        path = s.refinenet4(rn[3], out_hw=rn[2].shape[2:])
        path = s.refinenet3(path, rn[2], out_hw=rn[1].shape[2:])
        path = s.refinenet2(path, rn[1], out_hw=rn[0].shape[2:])
        path = s.refinenet1(path, rn[0])
        y = resize_align_corners(s.output_conv1(path), (ph * 14, pw * 14))
        y = s.output_conv2(y)
        y = torch.sigmoid(y) * self.max_depth if self.metric else F.relu(y)
        return y[:, 0]


DPT_CONFIGS = {
    "vits": dict(features=64, out_channels=(48, 96, 192, 384)),
    "vitb": dict(features=128, out_channels=(96, 192, 384, 768)),
    "vitl": dict(features=256, out_channels=(256, 512, 1024, 1024)),
    "vitg": dict(features=384, out_channels=(1536, 1536, 1536, 1536)),
}
