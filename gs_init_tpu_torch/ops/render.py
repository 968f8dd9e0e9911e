"""High-level rasterization — port of ``gs_init_tpu/ops/render.py``.

Projection -> SH colours -> tile binning -> tile compositor (the CUDA
kernels on the card). The argument surface mirrors the JAX ``rasterize``;
the dense oracle (``impl="xla"``, JAX ``ops/rasterize_ref.py``) is not
ported yet, so the tile compositor is the only implementation.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .projection import project_gaussians
from .rasterize import render_tiles, unpack_tiles
from .sh import sh_to_color
from .tiles import TileBinning, bin_gaussians, pack_table


class RenderInfo(NamedTuple):
    radii: torch.Tensor  # [C, N] int32
    depths: torch.Tensor  # [C, N]
    overflow: torch.Tensor  # [] int32 pairs dropped by the pair capacity
    binning: TileBinning


def rasterize(
    means: torch.Tensor,  # [N, 3]
    quats: torch.Tensor,  # [N, 4]
    scales: torch.Tensor,  # [N, 3] post-activation
    opacities: torch.Tensor,  # [N] post-activation
    colors: torch.Tensor,  # [N, 3] rgb, [C, N, 3], or [N, K, 3] SH with sh_degree
    viewmats: torch.Tensor,  # [C, 4, 4]
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    *,
    sh_degree: Optional[int] = None,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    eps2d: float = 0.3,
    rasterize_mode: str = "classic",  # or "antialiased"
    render_mode: str = "RGB",  # or "RGB+ED"
    backgrounds: Optional[torch.Tensor] = None,  # [C, 3]
    camera_model: str = "pinhole",
    tile_size: int = 32,
    pair_capacity: int = 1 << 20,
    chunk_size: int = 128,
    alive: Optional[torch.Tensor] = None,  # [N] bool capacity mask
    masks: Optional[torch.Tensor] = None,  # [C, H, W] pixel mask
    means2d_dummy: Optional[torch.Tensor] = None,  # [C, N, 2] zeros; grad tap
    pair_dummy: Optional[torch.Tensor] = None,  # [C*N, 2] zeros; absgrad tap
    impl: str = "auto",
    sh_mask: Optional[torch.Tensor] = None,  # [num_bases] 0/1 schedule mask
):
    """Render gaussians. Returns (render [C,H,W,3|4], alpha [C,H,W,1], info).

    Differentiate w.r.t. ``means2d_dummy`` (zeros) for screen-space
    positional gradients, and w.r.t. ``pair_dummy`` (zeros) for absgrad."""
    if impl == "xla":
        raise NotImplementedError(
            "impl='xla' (the dense oracle, gs_init_tpu/ops/rasterize_ref.py) "
            "is queued for a later slice of the port; use the tile compositor"
        )
    if impl not in ("auto", "pallas"):
        raise ValueError(f"unknown rasterizer impl {impl!r}")
    if render_mode not in ("RGB", "RGB+ED"):
        raise ValueError(f"unsupported render_mode {render_mode!r}")

    proj = project_gaussians(
        means, quats, scales, opacities, viewmats, Ks, width, height,
        near_plane=near_plane, far_plane=far_plane, eps2d=eps2d,
        antialiased=(rasterize_mode == "antialiased"), radius_clip=radius_clip,
        camera_model=camera_model, alive=alive,
    )
    means2d = proj.means2d
    if means2d_dummy is not None:
        means2d = means2d + means2d_dummy

    num_cams = viewmats.shape[0]
    if sh_degree is not None:
        # Camera centres from world->camera: c = -R^T t.
        centers = -torch.einsum("cji,cj->ci", viewmats[:, :3, :3], viewmats[:, :3, 3])
        dirs = means[None, :, :] - centers[:, None, :]
        cam_colors = sh_to_color(
            colors[None].expand((num_cams,) + colors.shape), dirs, sh_degree,
            basis_mask=sh_mask,
        )
    elif colors.dim() == 2:
        cam_colors = colors[None].expand((num_cams,) + colors.shape)
    else:
        cam_colors = colors

    binning = bin_gaussians(
        means2d, proj.radii, proj.depths, width, height, tile_size, pair_capacity,
        chunk=chunk_size, extents=proj.extents,
    )
    table = pack_table(means2d, proj.conics, proj.opacities, cam_colors, proj.depths)
    num_tiles = num_cams * binning.num_tiles_x * binning.num_tiles_y
    want_absgrad = pair_dummy is not None
    if pair_dummy is None:
        pair_dummy = torch.zeros((table.shape[0], 2), dtype=table.dtype, device=table.device)
    out = render_tiles(
        table, pair_dummy, binning.gid_sorted, binning.tile_starts, num_tiles,
        binning.num_tiles_x, binning.num_tiles_y, tile_size, chunk_size,
        render_mode == "RGB+ED", want_absgrad,
    )
    color, alpha, depth_acc = unpack_tiles(
        out, num_cams, binning.num_tiles_x, binning.num_tiles_y, tile_size, width, height
    )
    if backgrounds is not None:
        color = color + (1.0 - alpha)[..., None] * backgrounds[:, None, None, :]
    if render_mode == "RGB+ED":
        ed = depth_acc / torch.clamp(alpha, min=1e-10)
        render = torch.cat([color, ed[..., None]], dim=-1)
    else:
        render = color
    if masks is not None:
        render = render * masks[..., None].to(render.dtype)
    info = RenderInfo(
        radii=proj.radii, depths=proj.depths, overflow=binning.overflow, binning=binning
    )
    return render, alpha[..., None], info
