"""Metric3D v2 decoder, a RAFT-style DPT with iterative ConvGRU refinement —
port of ``gs_init_tpu/models/raft_dpt.py``.

- token readout: patch tokens projected, plus the cls and register tokens
  projected and broadcast-added, reassembled to a 4-level pyramid (1/14,
  1/14, 1/7, 1/4);
- monocular decoder: DPT fuse blocks give a shared 1/4 feature map and the
  depth and normal confidence channels; depth is a 256-bin log-spaced
  expectation, normals unit xyz plus an elu kappa;
- recurrent refinement: a 3-level ConvGRU hierarchy (1/4, 1/8, 1/16 of the
  crop) with slow-fast scheduling, a flow head giving 6-channel deltas, and
  learned 9-neighbour convex upsampling by 2^n_downsample.

Parameter names are those of the official checkpoint's ``decoder.``
(RAFTDepthNormalDPT5: ``token2feature.read_{k}.readoper``,
``decoder_mono.upconv_{j}``, ``context_feature_encoder.outputs{04,08,16}``,
``update_block.gru{08,16,32}``, ...). Channels-first throughout.

The reference's in-place ReLUs leave traces the checkpoints bake in, kept
here as the JAX package keeps them: ``ConvBlock`` returns relu(x) + ...,
and the context encoder sees relu(x1), relu(x2) but the raw x0.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import resize_align_corners
from .dpt import conv3

_LEVELS = ("outputs04", "outputs08", "outputs16")


def _ctx_name(m) -> str:
    path = 0 if m[2] == "hidden" else 1
    part = 0 if m[3] == "res" else 1
    return f"{m[1]}context_feature_encoder/{_LEVELS[int(m[4])]}/{path}/{part}"


# The decoder's flax module paths against its torch names, and its
# transposed convolutions (state_dict_from_flax).
RAFT_RENAMES = (
    (r"(^|/)read_(\d)/readout", r"\1token2feature/read_\2/readoper"),
    (r"(^|/)read_1/sample", r"\1token2feature/read_1/sample"),
    (r"(^|/)read_0/sample", r"\1token2feature/read_0/sample/0"),
    (r"(^|/)upconv_", r"\1decoder_mono/upconv_"),
    (r"(^|/)depth_reg_(\d)", r"\1depth_regressor/\2"),
    (r"(^|/)normal_(\d)", r"\1normal_predictor/\2"),
    (r"(^|/)ctx_(hidden|context)_(res|conv)_(\d)", _ctx_name),
    (r"/downsample$", "/downsample/0"),
    (r"/norm3$", "/downsample/1"),
    (r"(^|/)ctx_zqr_(\d)", r"\1context_zqr_convs/\2"),
    (r"(^|/)(gru08|gru16|gru32|flow_head)", r"\1update_block/\2"),
    (r"(^|/)mask_(\d)", r"\1update_block/mask/\2"),
)
RAFT_TRANSPOSED = (r"(.*/)?read_1/sample",)


def nearest_indices(n_in: int, n_out: int, scale: float) -> np.ndarray:
    """torch mode='nearest' with an explicit scale factor: floor(dst / scale)."""
    return np.clip(np.floor(np.arange(n_out) / scale).astype(np.int64), 0, n_in - 1)


def pool2x(x):
    return F.avg_pool2d(x, 3, stride=2, padding=1)


def norm_normalize(out):
    """[B, 4, H, W]: xyz to unit norm, kappa = elu(k) + 1.01."""
    xyz, kappa = out[:, :3], out[:, 3:4]
    n = torch.sqrt(torch.sum(xyz * xyz, dim=1, keepdim=True)) + 1e-10
    return torch.cat([xyz / n, F.elu(kappa) + 1.01], dim=1)


class ChannelLayerNorm(nn.LayerNorm):
    """LayerNorm over the channels of [B, C, H, W] (flax's default eps 1e-6)."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-6)

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class Readout(nn.Module):
    def __init__(self, dim: int, n_prefix: int):
        super().__init__()
        self.project_patch = nn.Linear(dim, dim)
        self.project_learn = nn.Linear(n_prefix * dim, dim, bias=False)

    def forward(self, patch, learn):
        """patch [B, C, H, W]; learn [B, n_prefix * C] -> [B, C, H, W]."""
        x = self.project_patch(patch.permute(0, 2, 3, 1)) + self.project_learn(learn)[:, None, None]
        return F.gelu(x).permute(0, 3, 1, 2)


class Token2Feature(nn.Module):
    def __init__(self, dim: int, out: int, scale: float, n_prefix: int):
        super().__init__()
        self.scale = scale
        self.readoper = Readout(dim, n_prefix)
        if scale == 1:
            self.sample = nn.Identity()
        elif scale == 2:
            self.sample = nn.ConvTranspose2d(dim, out, 2, stride=2)
        else:  # a fractional scale: 1x1 conv and nearest upsampling (they commute)
            self.sample = nn.Sequential(nn.Conv2d(dim, out, 1))

    def forward(self, patch, learn):
        x = self.sample(self.readoper(patch, learn))
        if self.scale in (1, 2):
            return x
        h, w = x.shape[2:]
        iy = nearest_indices(h, int(h * self.scale), self.scale)
        ix = nearest_indices(w, int(w * self.scale), self.scale)
        return x[:, :, torch.as_tensor(iy, device=x.device)][:, :, :, torch.as_tensor(ix, device=x.device)]


class ConvBlock(nn.Module):
    """relu(x) + conv2(relu(conv1(relu(x)))): the reference's in-place ReLU
    aliases the residual input."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = conv3(ch, ch)
        self.conv2 = conv3(ch, ch)

    def forward(self, x):
        a = F.relu(x)
        return a + self.conv2(F.relu(self.conv1(a)))


class FuseBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, fuse: bool = True, upsample: bool = True,
                 scale: float = 2.0):
        super().__init__()
        self.upsample, self.scale = upsample, scale
        if fuse:
            self.way_branch = ConvBlock(in_ch)
        self.way_trunk = ConvBlock(in_ch)
        self.out_conv = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x1, x2=None):
        if x2 is not None:
            x1 = x1 + self.way_branch(x2)
        out = self.way_trunk(x1)
        if self.upsample:
            out = resize_align_corners(out, (int(out.shape[2] * self.scale), int(out.shape[3] * self.scale)))
        return self.out_conv(out)


class ResidualBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = conv3(in_ch, out_ch)
        self.norm1 = ChannelLayerNorm(out_ch)
        self.conv2 = conv3(out_ch, out_ch)
        self.norm2 = ChannelLayerNorm(out_ch)
        if in_ch != out_ch:
            self.downsample = nn.Sequential(nn.Conv2d(in_ch, out_ch, 1), ChannelLayerNorm(out_ch))

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if hasattr(self, "downsample"):
            x = self.downsample(x)
        return F.relu(x + y)


class ConvGRU(nn.Module):
    def __init__(self, hidden: int, in_dim: int):
        super().__init__()
        self.convz = conv3(hidden + in_dim, hidden)
        self.convr = conv3(hidden + in_dim, hidden)
        self.convq = conv3(hidden + in_dim, hidden)

    def forward(self, h, cz, cr, cq, *inputs):
        x = torch.cat(inputs, dim=1)
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx) + cz)
        r = torch.sigmoid(self.convr(hx) + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)) + cq)
        return (1 - z) * h + z * q


class FlowHead(nn.Module):
    """Depth (2) and normal (4) deltas through hd-wide 3x3 convs."""

    def __init__(self, hd: int):
        super().__init__()
        self.conv1d = conv3(hd, hd)
        self.conv2d = conv3(hd, 2)
        self.conv1n = conv3(hd, hd)
        self.conv2n = conv3(hd, 4)

    def forward(self, x):
        d = self.conv2d(F.relu(self.conv1d(x)))
        n = self.conv2n(F.relu(self.conv1n(x)))
        return torch.cat([d, n], dim=1)


class UpdateBlock(nn.Module):
    def __init__(self, hd: int, n_downsample: int):
        super().__init__()
        self.gru08 = ConvGRU(hd, 6 + hd)  # flow (6) and the 1/8 state
        self.gru16 = ConvGRU(hd, 2 * hd)  # the pooled 1/4 state and the 1/16 state
        self.gru32 = ConvGRU(hd, hd)  # the pooled 1/8 state
        self.flow_head = FlowHead(hd)
        self.mask = nn.Sequential(conv3(hd, hd), nn.ReLU(), nn.Conv2d(hd, 9 * 4**n_downsample, 1))


class RAFTDepthNormalDecoder(nn.Module):
    """The full decode head, configured for the Metric3D small and large
    presets by the channel tables of ``RAFT_CONFIGS``."""

    def __init__(
        self,
        vit_dim: int = 384,
        feature_channels: Sequence[int] = (96, 192, 384, 768),
        decoder_channels: Sequence[int] = (48, 96, 192, 384, 384),
        hidden_dim: int = 48,
        n_downsample: int = 2,
        iters: int = 4,
        num_anchors: int = 256,
        min_val: float = 0.1,
        max_val: float = 200.0,
        regress_scale: float = 100.0,
        n_prefix: int = 5,
    ):
        super().__init__()
        fc, dc, hd = tuple(feature_channels), tuple(decoder_channels), hidden_dim
        self.n_downsample, self.iters = n_downsample, iters
        self.num_anchors, self.min_val, self.max_val = num_anchors, min_val, max_val
        self.regress_scale = regress_scale
        self.token2feature = nn.Module()
        t2f = self.token2feature
        t2f.read_3 = Token2Feature(vit_dim, fc[3], 1, n_prefix)
        t2f.read_2 = Token2Feature(vit_dim, fc[2], 1, n_prefix)
        t2f.read_1 = Token2Feature(vit_dim, fc[1], 2, n_prefix)
        t2f.read_0 = Token2Feature(vit_dim, fc[0], 3.5, n_prefix)
        self.decoder_mono = nn.Module()
        self.decoder_mono.upconv_3 = FuseBlock(dc[4], dc[3], fuse=False, upsample=False)
        self.decoder_mono.upconv_2 = FuseBlock(dc[3], dc[2])
        self.decoder_mono.upconv_1 = FuseBlock(dc[2], dc[1] + 2, scale=7 / 4)
        self.depth_regressor = nn.Sequential(
            conv3(dc[1], num_anchors), nn.ReLU(), nn.Conv2d(num_anchors, num_anchors, 1)
        )
        self.normal_predictor = nn.Sequential(
            conv3(dc[1], 128), nn.ReLU(), nn.Conv2d(128, 128, 1), nn.ReLU(),
            nn.Conv2d(128, 128, 1), nn.ReLU(), nn.Conv2d(128, 3, 1),
        )
        self.context_feature_encoder = nn.Module()
        for lvl, cin in zip(_LEVELS, (fc[0], fc[1], vit_dim)):
            setattr(self.context_feature_encoder, lvl, nn.ModuleList(
                nn.Sequential(ResidualBlock(cin, hd), conv3(hd, hd)) for _ in range(2)
            ))
        self.context_zqr_convs = nn.ModuleList(conv3(hd, 3 * hd) for _ in range(3))
        self.update_block = UpdateBlock(hd, n_downsample)
        bins = np.exp(np.linspace(math.log(min_val), math.log(max_val), num_anchors))
        self._bins = bins.astype(np.float32)

    def _clamp(self, x):
        y = F.relu(x - self.min_val) + self.min_val
        return self.max_val - F.relu(self.max_val - y)

    def forward(self, patches, learns):
        """patches: 4 x [B, C, h, w] (shallow -> deep); learns: 4 x
        [B, (1 + registers) * C]. Returns depth [B, H, W], confidence
        [B, H, W] and normal [B, 4, H, W] at 14 h x 14 w."""
        t2f = self.token2feature
        x = t2f.read_3(patches[3], learns[3])
        x2 = t2f.read_2(patches[2], learns[2])
        x1 = t2f.read_1(patches[1], learns[1])
        x0 = t2f.read_0(patches[0], learns[0])

        dm = self.decoder_mono
        y = dm.upconv_3(x)
        y = dm.upconv_2(y, x2)
        y = dm.upconv_1(y, x1)
        feature_map, depth_conf, normal_conf = y[:, :-2], y[:, -2:-1], y[:, -1:]

        prob = torch.softmax(self.depth_regressor(feature_map), dim=1)
        bins = torch.as_tensor(self._bins, device=prob.device).view(1, -1, 1, 1)
        d = torch.sum(prob * bins, dim=1, keepdim=True)
        depth_pred = (self._clamp(d) - self.max_val) / self.regress_scale
        normal_pred = norm_normalize(torch.cat([self.normal_predictor(feature_map), normal_conf], dim=1))
        flow = torch.cat([depth_pred, depth_conf, normal_pred], dim=1)

        nets, inps = [], []
        cfe = self.context_feature_encoder
        for lvl, f, zqr in zip(_LEVELS, (x0, F.relu(x1), F.relu(x2)), self.context_zqr_convs):
            hidden, context = getattr(cfe, lvl)
            nets.append(torch.tanh(hidden(f)))
            inps.append(torch.chunk(zqr(F.relu(context(f))), 3, dim=1))

        ub = self.update_block

        def interp(a, dest):
            return resize_align_corners(a, dest.shape[2:])

        def step32():
            nets[2] = ub.gru32(nets[2], *inps[2], pool2x(nets[1]))

        def step16():
            nets[1] = ub.gru16(nets[1], *inps[1], interp(pool2x(nets[0]), nets[1]), interp(nets[2], nets[1]))

        for _ in range(self.iters):
            # Slow-fast scheduling: (32), (32, 16), (32, 16, 08 + flow head).
            step32()
            step32()
            step16()
            step32()
            step16()
            nets[0] = ub.gru08(nets[0], *inps[0], flow, interp(nets[1], nets[0]))
            flow = flow + ub.flow_head(nets[0])
        # The upsampling mask reads only the last iteration's state.
        mask = 0.25 * ub.mask(nets[0])

        up = convex_upsample(flow, mask, 2**self.n_downsample)
        depth = self._clamp(up[:, 0] * self.regress_scale + self.max_val)
        return depth, up[:, 1], norm_normalize(up[:, 2:])


def convex_upsample(flow, mask, factor: int):
    """Learned 9-neighbour convex upsampling: flow [B, D, h, w], mask
    [B, 9 * factor^2, h, w] -> [B, D, h * factor, w * factor]."""
    b, d, h, w = flow.shape
    mask = torch.softmax(mask.view(b, 9, factor * factor, h, w), dim=1)
    neigh = F.unfold(flow, 3, padding=1).view(b, d, 9, h, w)
    up = torch.einsum("bnkhw,bdnhw->bdkhw", mask, neigh)
    up = up.view(b, d, factor, factor, h, w).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(b, d, h * factor, w * factor)


RAFT_CONFIGS = {
    "small": dict(
        vit_dim=384,
        feature_channels=(96, 192, 384, 768),
        decoder_channels=(48, 96, 192, 384, 384),
        hidden_dim=48,
        iters=4,
    ),
    "large": dict(
        vit_dim=1024,
        feature_channels=(256, 512, 1024, 2048),
        decoder_channels=(128, 256, 512, 1024, 1024),
        hidden_dim=128,
        iters=8,
    ),
}
