"""High-level rasterization — port of ``gs_init_tpu/ops/render.py``.

Projection, SH colours and the table pack (``ops/project_pack.py``: one
CUDA kernel each way on the card) -> tile binning -> tile compositor (the
CUDA kernels on the card). The argument surface mirrors the JAX ``rasterize``.
``impl="xla"`` composites with the dense oracle (``ops/rasterize_ref.py``)
instead: no binning, no pair capacity (overflow 0), every gaussian against
every pixel in chunks of ``pixel_chunk``. ``composite`` is the binning and
the compositor alone, from a table: the sharded steps (``parallel/shard.py``)
call it on the gathered table.

``impl="auto"`` is the tile compositor on every device. The JAX package's
``auto`` picks its dense oracle on the CPU only because Pallas kernels run
slowly there in interpret mode; the port's CPU path is the compositor's
plain PyTorch version, which has no such cost.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .project_pack import PACK_MX, PACK_MY, camera_colors, project_pack
from .projection import project_gaussians
from .rasterize import render_tiles, unpack_tiles
from .rasterize_ref import rasterize_reference
from .tiles import TileBinning, bin_gaussians


class RenderInfo(NamedTuple):
    radii: torch.Tensor  # [C, N] int32
    depths: torch.Tensor  # [C, N]
    overflow: torch.Tensor  # [] int32 pairs dropped by the pair capacity (0 for xla)
    binning: Optional[TileBinning]  # None for the dense oracle


def composite(table, radii, extents, depths, width: int, height: int, tile_size: int, pair_capacity: int,
              chunk_size: int, want_depth_grad: bool, pair_dummy: Optional[torch.Tensor] = None):
    """Bin the gaussians of ``table`` [C*N, 16] (``project_pack``), whose
    radii [C, N] and extents [C, N, 2] (int32) and depths [C, N] are given,
    and composite them (K1 / K2 on the card); ``pair_dummy`` [C*N, 2] is
    the absgrad tap (zeros) or None. Returns (color [C,H,W,3], alpha
    [C,H,W], depth accumulator [C,H,W], binning)."""
    num_cams = radii.shape[0]
    means2d = table[:, PACK_MX : PACK_MY + 1].view(num_cams, -1, 2)
    binning = bin_gaussians(
        means2d, radii, depths, width, height, tile_size, pair_capacity,
        chunk=chunk_size, extents=extents,
    )
    ntx, nty = binning.num_tiles_x, binning.num_tiles_y
    want_absgrad = pair_dummy is not None
    if pair_dummy is None:
        pair_dummy = torch.zeros((table.shape[0], 2), dtype=table.dtype, device=table.device)
    out = render_tiles(
        table, pair_dummy, binning.gid_sorted, binning.tile_starts, num_cams * ntx * nty,
        ntx, nty, tile_size, chunk_size, want_depth_grad, want_absgrad,
    )
    color, alpha, depth_acc = unpack_tiles(out, num_cams, ntx, nty, tile_size, width, height)
    return color, alpha, depth_acc, binning


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
    pixel_chunk: int = 4096,  # the dense oracle's pixels per chunk
    sh_mask: Optional[torch.Tensor] = None,  # [num_bases] 0/1 schedule mask
):
    """Render gaussians. Returns (render [C,H,W,3|4], alpha [C,H,W,1], info).

    Differentiate w.r.t. ``means2d_dummy`` (zeros) for screen-space
    positional gradients, and w.r.t. ``pair_dummy`` (zeros) for absgrad
    (the dense oracle does not use ``pair_dummy``). Both must be zeros: on
    the card the kernels take only their gradients and never read them."""
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown rasterizer impl {impl!r}")
    if render_mode not in ("RGB", "RGB+ED"):
        raise ValueError(f"unsupported render_mode {render_mode!r}")

    proj_kw = dict(
        near_plane=near_plane, far_plane=far_plane, eps2d=eps2d,
        antialiased=(rasterize_mode == "antialiased"), radius_clip=radius_clip,
        camera_model=camera_model, alive=alive,
    )
    if impl == "xla":
        proj = project_gaussians(means, quats, scales, opacities, viewmats, Ks, width, height, **proj_kw)
        means2d = proj.means2d if means2d_dummy is None else proj.means2d + means2d_dummy
        cam_colors = camera_colors(means, colors, viewmats, sh_degree, sh_mask)
        color, alpha, depth_acc = rasterize_reference(
            proj._replace(means2d=means2d), cam_colors, width, height,
            pixel_chunk=pixel_chunk, tile_size=tile_size,
        )
        radii, depths = proj.radii, proj.depths
        binning = None
        overflow = torch.zeros((), dtype=torch.int32, device=means.device)
    else:
        table, radii, extents, depths = project_pack(
            means, quats, scales, opacities, colors, viewmats, Ks, width, height,
            sh_degree=sh_degree, sh_mask=sh_mask, means2d_dummy=means2d_dummy,
            **proj_kw,
        )
        color, alpha, depth_acc, binning = composite(
            table, radii, extents, depths, width, height, tile_size, pair_capacity, chunk_size,
            render_mode == "RGB+ED", pair_dummy,
        )
        overflow = binning.overflow
    if backgrounds is not None:
        color = color + (1.0 - alpha)[..., None] * backgrounds[:, None, None, :]
    if render_mode == "RGB+ED":
        ed = depth_acc / torch.clamp(alpha, min=1e-10)
        render = torch.cat([color, ed[..., None]], dim=-1)
    else:
        render = color
    if masks is not None:
        render = render * masks[..., None].to(render.dtype)
    info = RenderInfo(radii=radii, depths=depths, overflow=overflow, binning=binning)
    return render, alpha[..., None], info
