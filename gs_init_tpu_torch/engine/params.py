"""Gaussian parameter buffers — fixed capacity, mask-based liveness.

Port of ``gs_init_tpu/engine/params.py``. Gaussians live in static [CAP, ...]
buffers with an ``alive`` mask, as in the JAX package: densification moves
data between slots and flips mask bits, so shapes never change and dead
slots are culled in projection. PyTorch updates these buffers in place
(Adam, refine) where the JAX package rebuilt them.

``state_from_numpy`` / ``adam_from_numpy`` / ``strategy_from_numpy`` carry
a state across from numpy arrays (for example the leaves of the JAX
package's NamedTuples), so both packages can be run from identical state.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.knn import mean_knn_dist
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
) -> GaussianState:
    """SfM point-cloud initialisation (reference runner.py:53-138).

    Scale = log(mean kNN(3) distance * init_scale); a uniform random subset
    when the cloud exceeds capacity; random unit quaternions. Tensors are
    made on ``points.device``; ``generator`` (on that device) draws the
    subset and the quaternions."""
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
    dist = torch.clamp(mean_knn_dist(points, k=3), min=1e-7)
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
