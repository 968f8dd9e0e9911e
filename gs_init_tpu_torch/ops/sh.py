"""Real spherical-harmonics colour evaluation (degrees 0..3).

Port of ``gs_init_tpu/ops/sh.py``: plain elementwise PyTorch.
"""
from __future__ import annotations

from typing import Optional

import torch

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)

NUM_SH_BASES = {0: 1, 1: 4, 2: 9, 3: 16}


def num_sh_bases(degree: int) -> int:
    return NUM_SH_BASES[degree]


def eval_sh_bases(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """SH basis values [..., num_bases] at unit directions [..., 3]."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, _C0)]
    if degree >= 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        xy = x * y
        out += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)


def sh_to_color(
    sh_coeffs: torch.Tensor,  # [..., K, 3], K >= num_bases(degree)
    dirs: torch.Tensor,  # [..., 3], not necessarily normalised
    degree: int,
    basis_mask: Optional[torch.Tensor] = None,  # [num_bases(degree)] 0/1
) -> torch.Tensor:
    """RGB [..., 3] = max(SH . basis + 0.5, 0); the degree schedule rides
    ``basis_mask`` on the basis, not on the coefficient buffer."""
    n = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)
    basis = eval_sh_bases(degree, n)
    if basis_mask is not None:
        basis = basis * basis_mask
    b = basis.shape[-1]
    color = torch.einsum("...k,...kc->...c", basis, sh_coeffs[..., :b, :])
    return torch.clamp(color + 0.5, min=0.0)
