"""FP32 operations one training step needs, from its shapes and inputs.

Per alive gaussian and camera, forward (the backward counted as twice it):
the projection (the rotation from the quaternion, the 3D covariance, its
view transform and the Jacobian's product, the 2D inverse, the bounds:
``OPS_PROJECT``) and the SH colour (the bases of the active degree and three
dot products: ``sh_ops``). The compositor's forward and backward as
``composite.work`` counts them. Per pixel and channel, L1 and SSIM (five
maps through two 11-tap passes, the SSIM formula: ``OPS_LOSS_PER_PIXEL``),
the backward twice that. Adam over every slot of the capacity (59 floats a
gaussian at SH degree 3: ``OPS_ADAM`` each) and the densification
statistics per alive gaussian (``OPS_STATS``).
"""
from __future__ import annotations

OPS_PROJECT = 190
OPS_LOSS_PER_PIXEL = 5 * 2 * 11 * 2 + 30
OPS_ADAM = 12
OPS_STATS = 10
SH_BASIS_OPS = {0: 0, 1: 3, 2: 17, 3: 45}


def sh_ops(degree: int) -> int:
    bases = (degree + 1) ** 2
    return SH_BASIS_OPS[degree] + 6 + 3 * 2 * bases  # normalise the direction, 3 dot products


def step_ops(work: dict, alive: int, capacity: int, pixels: int, sh_degree: int, floats_per_gaussian: int = 59,
             channels: int = 3) -> int:
    per_gaussian = 3 * (OPS_PROJECT + sh_ops(sh_degree)) + OPS_STATS
    return int(alive * per_gaussian + work["fwd_ops"] + work["bwd_ops"]
               + 3 * OPS_LOSS_PER_PIXEL * pixels * channels + OPS_ADAM * floats_per_gaussian * capacity)
