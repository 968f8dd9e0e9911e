"""Gaussian parameter buffers — fixed capacity, mask-based liveness.

Port of ``gs_init_tpu/engine/params.py``. Gaussians live in static [CAP, ...]
buffers with an ``alive`` mask, as in the JAX package: densification moves
data between slots and flips mask bits, so shapes never change and dead
slots are culled in projection. PyTorch updates these buffers in place
(Adam, refine) where the JAX package rebuilt them.

``state_from_numpy`` / ``adam_from_numpy`` / ``strategy_from_numpy`` /
``aux_from_numpy`` carry a state across from numpy arrays (for example the
leaves of the JAX package's NamedTuples), so both packages can be run from
identical state.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.knn import mean_knn_dist
from .appearance import AppearanceParams
from ..ops.sh import num_sh_bases

SH0_C = 0.28209479177387814
PARAM_NAMES = ("means", "quats", "scales", "opacities", "sh0", "shN")


@dataclass
class GaussianParams:
    """Trainable buffers; leading dim = capacity CAP."""

    means: torch.Tensor  # [CAP, 3]
    quats: torch.Tensor  # [CAP, 4] (normalised in projection)
    scales: torch.Tensor  # [CAP, 3] log-scale
    opacities: torch.Tensor  # [CAP] logit
    sh0: torch.Tensor  # [CAP, 1, 3]
    shN: torch.Tensor  # [CAP, K-1, 3]

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    def items(self):
        return ((f.name, getattr(self, f.name)) for f in fields(self))

    def map(self, fn) -> "GaussianParams":
        return GaussianParams(**{k: fn(v) for k, v in self.items()})

    def sh_coeffs(self) -> torch.Tensor:
        return torch.cat([self.sh0, self.shN], dim=1)

    def activated(self):
        """(scales, opacities) after activation."""
        return torch.exp(self.scales), torch.sigmoid(self.opacities)


@dataclass
class GaussianState:
    params: GaussianParams
    alive: torch.Tensor  # [CAP] bool


def rgb_to_sh0(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / SH0_C


def sh0_to_rgb(sh0: torch.Tensor) -> torch.Tensor:
    return sh0 * SH0_C + 0.5


def _logit(p: float) -> float:
    return math.log(p / (1.0 - p))


def init_from_points(
    points: torch.Tensor,  # [N, 3]
    rgbs: torch.Tensor,  # [N, 3] in [0, 1]
    capacity: int,
    sh_degree: int = 3,
    init_opacity: float = 0.1,
    init_scale: float = 1.0,
    generator: Optional[torch.Generator] = None,
    scale_clamp_quantile: float = 0.0,
    fixed_scale: Optional[float] = None,
) -> GaussianState:
    """Point-cloud initialisation from SfM or monocular-depth points
    (reference runner.py:53-138).

    Scale = log(mean kNN(3) distance * init_scale); a uniform random subset
    when the cloud exceeds capacity; random unit quaternions. With
    ``scale_clamp_quantile`` > 0 the kNN distances are first clamped to
    that quantile, so a few isolated points cannot spawn huge gaussians
    (reference limit_init_scale). ``fixed_scale`` stands in for every kNN
    distance and skips the search (benchmark set-ups at millions of
    points). Tensors are made on ``points.device``; ``generator`` (on that
    device) draws the subset and the quaternions."""
    dev = points.device
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    n = min(points.shape[0], capacity)
    if points.shape[0] > capacity:
        sel = torch.randperm(points.shape[0], generator=generator, device=dev)[:capacity]
        points, rgbs = points[sel], rgbs[sel]
    else:
        points, rgbs = points[:n], rgbs[:n]
    if fixed_scale is not None:
        dist = torch.full((n,), float(fixed_scale), device=dev)
    else:
        dist = torch.clamp(mean_knn_dist(points, k=3), min=1e-7)
    if scale_clamp_quantile > 0.0:
        dist = torch.clamp(dist, max=quantile(dist, scale_clamp_quantile))
    scales = torch.log(dist * init_scale)[:, None].repeat(1, 3)

    k = num_sh_bases(sh_degree)
    quats = torch.randn((capacity, 4), generator=generator, device=dev)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)

    def place(buf, vals):
        buf[:n] = vals
        return buf

    params = GaussianParams(
        means=place(torch.zeros((capacity, 3), device=dev), points),
        quats=quats,
        scales=place(torch.full((capacity, 3), -10.0, device=dev), scales),
        opacities=torch.full((capacity,), _logit(init_opacity), device=dev),
        sh0=place(torch.zeros((capacity, 1, 3), device=dev), rgb_to_sh0(rgbs)[:, None, :]),
        shN=torch.zeros((capacity, k - 1, 3), device=dev),
    )
    alive = torch.arange(capacity, device=dev) < n
    return GaussianState(params=params, alive=alive)


def quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The q-quantile of a 1-D tensor with linear interpolation, as
    ``jnp.quantile``; by sorting, so any length (``torch.quantile`` refuses
    more than 2^24 elements)."""
    s = torch.sort(x).values
    pos = q * (s.shape[0] - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, s.shape[0] - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def init_random(
    generator: torch.Generator,
    num_points: int,
    capacity: int,
    extent: float = 3.0,
    scene_scale: float = 1.0,
    sh_degree: int = 3,
    init_opacity: float = 0.1,
    init_scale: float = 1.0,
    device: Optional[torch.device] = None,
) -> GaussianState:
    """Random-in-box init (reference init_type="random")."""
    pts = (torch.rand((num_points, 3), generator=generator, device=device) * 2.0 - 1.0)
    pts = pts * extent * scene_scale
    rgbs = torch.rand((num_points, 3), generator=generator, device=device)
    return init_from_points(
        pts, rgbs, capacity, sh_degree, init_opacity, init_scale, generator=generator
    )


def num_alive(state: GaussianState) -> int:
    return int(state.alive.sum())


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device)


def params_from_numpy(leaves: Dict[str, np.ndarray], device) -> GaussianParams:
    """GaussianParams from numpy arrays keyed by field name."""
    return GaussianParams(**{k: _t(leaves[k], device).float() for k in PARAM_NAMES})


def state_from_numpy(params: Dict[str, np.ndarray], alive: np.ndarray, device) -> GaussianState:
    """GaussianState from numpy leaves (e.g. the JAX GaussianState's)."""
    return GaussianState(
        params=params_from_numpy(params, device), alive=_t(alive, device).bool()
    )


@dataclass
class AuxParams:
    """Optional per-image / appearance parameter groups (None = disabled)."""

    pose: Optional[torch.Tensor] = None  # [n_images, 9]
    app: Optional[AppearanceParams] = None
    grids: Optional[torch.Tensor] = None  # [n_images, L, H, W, 12]


def aux_leaves(aux: AuxParams) -> List[torch.Tensor]:
    """The aux tensors in the order of the JAX package's
    ``tree_flatten(AuxParams)``: pose, the AppearanceParams fields, grids;
    disabled groups have none."""
    out = [] if aux.pose is None else [aux.pose]
    if aux.app is not None:
        out += [getattr(aux.app, f.name) for f in fields(aux.app)]
    return out + ([] if aux.grids is None else [aux.grids])


def aux_from_leaves(like: AuxParams, leaves: List[torch.Tensor]) -> AuxParams:
    """An AuxParams with ``like``'s enabled groups, filled from ``leaves``
    in ``aux_leaves`` order."""
    it = iter(leaves)
    pose = None if like.pose is None else next(it)
    app = None
    if like.app is not None:
        app = AppearanceParams(**{f.name: next(it) for f in fields(AppearanceParams)})
    grids = None if like.grids is None else next(it)
    return AuxParams(pose=pose, app=app, grids=grids)


def aux_from_numpy(pose, app: Optional[Dict[str, np.ndarray]], grids, device) -> AuxParams:
    """AuxParams from numpy arrays (e.g. the JAX AuxParams' leaves); ``app``
    is keyed by AppearanceParams field; None leaves a group disabled."""
    f = lambda x: None if x is None else _t(x, device).float()
    return AuxParams(
        pose=f(pose),
        app=None if app is None else AppearanceParams(
            **{k.name: f(app[k.name]) for k in fields(AppearanceParams)}
        ),
        grids=f(grids),
    )
