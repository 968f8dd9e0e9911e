"""Multi-GPU training — port of ``gs_init_tpu/parallel/shard.py``.

A 2-D mesh of processes, one per GPU, with axes ("data", "gauss"):
cameras (or pixel bands) are sharded over "data", the gaussian buffers
(parameters, Adam moments, strategy statistics) along axis 0 over "gauss",
and the aux groups (pose, appearance, bilateral grid) are replicated.

Each rank projects, colours and packs its gaussian slice for its cameras
through ``ops/project_pack`` (K4 / K5 on the card), as the one-card step
does; the table's 10 attribute columns and the radii and extents (10
floats and 3 ints per camera and gaussian) are all-gathered over "gauss";
binning and the tile compositor (``ops/render.composite``: K1 and K2 on
the card) then run on every rank for its own cameras. The setup before
the render and the updates after the backward are the one-card step's
(``engine/train_step.StepFrame``). The gradients follow ``jax.shard_map``'s
(``collectives.py``): the all_gather's backward is a summing
reduce-scatter, so per-rank gradients arrive ``n_gauss``-fold and the step
scales them by ``1 / (n_data * n_gauss)`` after a sum over "data", as the
JAX steps do.

``make_band_sharded_train_step`` shards horizontal tile-row bands of every
image over "data" instead (the batch is replicated): each rank culls the
gathered gaussians to its band, composites a band of ``band_h`` rows (a
whole number of tiles; rows past the image are rendered and dropped), and
the bands are all-gathered into the full image for a replicated loss, so
SSIM windows never straddle a band edge. This is the configuration for one
camera per step at millions of gaussians.

Both steps have the signature and return values of the port's
``make_train_step``: ``gstate``, ``adam`` and ``sstate`` are this rank's
slices, ``batch`` its cameras (the whole batch in band mode), ``bkgd`` the
whole batch's random background (every rank draws the same). Refine, MCMC
relocation, eval and checkpoints work on the gathered state
(``global_state``) and keep this rank's rows (``local_state``); the Runner
does that (``engine/runner.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..engine.optim import AdamState
from ..engine.params import GaussianState
from ..engine.train_step import Batch, StepFrame, image_loss, regulariser_loss
from ..ops.project_pack import (
    NATTR, PACK_B, PACK_CA, PACK_CB, PACK_CC, PACK_COLS, PACK_DEPTH, PACK_MX, PACK_MY, PACK_OPA, PACK_R,
    project_pack,
)
from ..ops.projection import Projected
from ..ops.rasterize_ref import rasterize_reference
from ..ops.render import composite
from . import collectives as col


@dataclass
class Mesh:
    """This rank's place in a (data, gauss) grid of ranks, and the process
    groups of its axes: ``data`` holds the ranks of its column (same gauss
    index), ``gauss`` those of its row, ``world`` every rank of the mesh.
    A rank outside the grid has ``di = gi = -1`` and no groups."""

    ranks: np.ndarray  # [n_data, n_gauss] global ranks
    di: int
    gi: int
    data: object = None
    gauss: object = None
    world: object = None

    @property
    def n_data(self) -> int:
        return self.ranks.shape[0]

    @property
    def n_gauss(self) -> int:
        return self.ranks.shape[1]

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "gauss": self.n_gauss}

    @property
    def member(self) -> bool:
        return self.di >= 0


def make_mesh(n_data: int, n_gauss: int, ranks=None, backend: Optional[str] = None) -> Mesh:
    """The (n_data, n_gauss) mesh over ``ranks`` (the first n_data * n_gauss
    ranks by default), reshaped row-major. Every rank of the process group
    must call it with the same arguments (``dist.new_group``); ``backend``
    defaults to the process group's."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group (parallel.multihost."
            "initialize_multihost, torchrun, or torch.distributed.init_process_group)"
        )
    ranks = np.arange(n_data * n_gauss) if ranks is None else np.asarray(ranks).reshape(-1)
    if ranks.size != n_data * n_gauss or ranks.max() >= dist.get_world_size():
        raise ValueError(
            f"a {n_data}x{n_gauss} mesh needs {n_data * n_gauss} ranks of the "
            f"{dist.get_world_size()} in the process group, got {ranks.tolist()}"
        )
    grid = ranks.reshape(n_data, n_gauss)
    new = lambda rs: dist.new_group([int(r) for r in rs], backend=backend)
    cols = [new(grid[:, j]) for j in range(n_gauss)]
    rows = [new(grid[i]) for i in range(n_data)]
    world = new(grid.reshape(-1))
    at = np.argwhere(grid == dist.get_rank())
    if not len(at):
        return Mesh(grid, -1, -1)
    di, gi = int(at[0][0]), int(at[0][1])
    return Mesh(grid, di, gi, data=cols[gi], gauss=rows[di], world=world)


# --------------------------------------------------- slices of the state


def gauss_rows(capacity: int, mesh: Mesh) -> slice:
    """This rank's rows of a gaussian buffer of ``capacity`` rows."""
    if capacity % mesh.n_gauss:
        raise ValueError(f"capacity {capacity} is not divisible by {mesh.n_gauss} gaussian shards")
    n = capacity // mesh.n_gauss
    return slice(mesh.gi * n, (mesh.gi + 1) * n)


def data_rows(batch_size: int, mesh: Mesh) -> slice:
    """This rank's cameras of a batch of ``batch_size``."""
    if batch_size % mesh.n_data:
        raise ValueError(f"batch_size {batch_size} is not divisible by the data mesh axis {mesh.n_data}")
    n = batch_size // mesh.n_data
    return slice(mesh.di * n, (mesh.di + 1) * n)


def local_batch(batch: Batch, mesh: Mesh) -> Batch:
    """This rank's cameras of a batch (every leaf along axis 0)."""
    rows = data_rows(batch.pixels.shape[0], mesh)
    return Batch(**{
        f.name: None if getattr(batch, f.name) is None else getattr(batch, f.name)[rows]
        for f in dataclasses.fields(Batch)
    })


def _map_fields(obj, fn):
    return dataclasses.replace(obj, **{f.name: fn(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def local_state(gstate: GaussianState, adam: AdamState, sstate, mesh: Mesh):
    """This rank's rows (copies) of the whole-capacity state."""
    rows = gauss_rows(gstate.alive.shape[0], mesh)
    cut = lambda x: x[rows].clone()
    return (
        GaussianState(params=gstate.params.map(cut), alive=cut(gstate.alive)),
        AdamState(mu=adam.mu.map(cut), nu=adam.nu.map(cut), count=adam.count),
        _map_fields(sstate, cut),
    )


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole-capacity buffer from every gaussian shard's rows."""
    if x.dtype == torch.bool:
        return col.gather_raw(x.to(torch.uint8), mesh.gauss).bool()
    return col.gather_raw(x, mesh.gauss)


def global_gaussians(gstate: GaussianState, mesh: Mesh) -> GaussianState:
    """The whole-capacity gaussians from every rank's slice (a collective
    over the gauss axis: every rank of the mesh calls it)."""
    g = lambda x: gather_rows(x, mesh)
    return GaussianState(params=gstate.params.map(g), alive=g(gstate.alive))


def global_state(gstate: GaussianState, adam: AdamState, sstate, mesh: Mesh):
    """``global_gaussians`` with the Adam moments and strategy statistics."""
    g = lambda x: gather_rows(x, mesh)
    return (
        global_gaussians(gstate, mesh),
        AdamState(mu=adam.mu.map(g), nu=adam.nu.map(g), count=adam.count),
        _map_fields(sstate, g),
    )


# ------------------------------------------------------------ the steps


def make_sharded_train_step(cfg, acfg, width: int, height: int, mesh: Mesh):
    """The camera / gaussian sharded train step: batch over "data",
    gaussians over "gauss" (the batch divisible by the data axis)."""
    return _make_step(cfg, acfg, width, height, mesh, band=False)


def make_band_sharded_train_step(cfg, acfg, width: int, height: int, mesh: Mesh, bands_per_rank: int = 1):
    """The pixel-band train step: tile-row bands over "data" (the batch
    replicated), gaussians over "gauss". With ``bands_per_rank`` > 1 each
    rank renders that many consecutive bands one after another (each with
    its own pair table): on a one-rank mesh this is the arithmetic of a
    mesh of that many band ranks, in one process."""
    return _make_step(cfg, acfg, width, height, mesh, band=True, bands_per_rank=bands_per_rank)


def band_height(height: int, tile: int, n_data: int) -> int:
    """Rows of one band: a whole number of tiles, the image's tile rows
    split over the data axis (the last bands may extend past the image)."""
    nty = -(-height // tile)
    return -(-nty // n_data) * tile


def _projected(table: torch.Tensor, radii, extents, c: int) -> Projected:
    """The dense oracle's input from a table [C*N, 16]: its columns, the
    conic diagonal doubled back (exact in float32, forwards and in the
    gradient)."""
    a = table.view(c, -1, PACK_COLS)
    conics = torch.stack([2.0 * a[..., PACK_CA], a[..., PACK_CB], 2.0 * a[..., PACK_CC]], -1)
    return Projected(means2d=a[..., PACK_MX:PACK_MY + 1], conics=conics, depths=a[..., PACK_DEPTH],
                     radii=radii, opacities=a[..., PACK_OPA], extents=extents)


def _make_step(cfg, acfg, width: int, height: int, mesh: Mesh, band: bool, bands_per_rank: int = 1):
    if not mesh.member:
        raise ValueError("this rank is outside the mesh")
    n_data, n_gauss = mesh.n_data, mesh.n_gauss
    frame = StepFrame(cfg, acfg, width, height)
    tiles = cfg.rasterizer_impl != "xla"
    tile = cfg.tile_size
    band_h = band_height(height, tile, n_data * bands_per_rank) if band else height
    # This rank's bands (their first rows); the camera step renders whole images.
    y0s = [float(k * band_h) for k in range(mesh.di * bands_per_rank, (mesh.di + 1) * bands_per_rank)] if band else [0.0]
    # Fold factors, as the JAX steps'. Cameras: a rank's gradient arrives
    # n_gauss-fold (the gather's backward sums the gauss ranks' identical
    # cotangents) and the global loss is the mean over "data" of the ranks'
    # losses. Bands: every rank's loss is the whole image's, the band
    # gather adds n_data folds, and the sum over "data" collects the bands.
    # Either way the sum over "data" scales by 1 / (n_data * n_gauss).
    norm = 1.0 / (n_data * n_gauss)
    proj_kw = dict(near_plane=cfg.near_plane, far_plane=cfg.far_plane, antialiased=cfg.antialiased,
                   camera_model=cfg.camera_model)

    def train_step(gstate, adam, sstate, aux, aux_opt, batch: Batch, step: int,
                   bkgd: Optional[torch.Tensor] = None, mark: Optional[Callable[[str], None]] = None):
        mark = mark or (lambda name: None)
        p = gstate.params
        alive = gstate.alive
        dev = p.means.device
        c = batch.pixels.shape[0]
        n_local = p.capacity
        n_global = n_local * n_gauss
        rows = slice(mesh.gi * n_local, (mesh.gi + 1) * n_local)
        if cfg.random_bkgd and bkgd is not None and not band:  # the whole batch's draw, this rank's cameras
            bkgd = bkgd[mesh.di * c:(mesh.di + 1) * c]
        f = frame.setup(gstate, aux, batch, step, bkgd, n_global if frame.use_absgrad and tiles else None,
                        app_rows=rows)
        table, radii, extents, _ = project_pack(
            f.lp.means, f.lp.quats, f.scales, f.opacities, f.colors, f.viewmats, batch.Ks, width, height,
            sh_degree=f.sh_degree, sh_mask=f.sh_mask, alive=alive, means2d_dummy=f.dummy, **proj_kw,
        )
        mark("setup")

        # The table's attribute columns, radii and extents of every gaussian
        # shard, re-padded to the compositor's 64-byte rows.
        attrs = col.all_gather(table[:, :NATTR].reshape(c, n_local, NATTR), mesh.gauss, dim=1)
        ints = col.gather_raw(torch.cat([radii[..., None], extents], -1).to(torch.int32), mesh.gauss, dim=1)
        table = F.pad(attrs, (0, PACK_COLS - NATTR)).reshape(c * n_global, PACK_COLS)
        depths = attrs[..., PACK_DEPTH]
        mark("gather")

        overflow = torch.zeros((), dtype=torch.int32, device=dev)
        pairs = torch.zeros((), dtype=torch.int32, device=dev)
        parts = []
        for y0 in y0s:
            tb, radii, extents = table, ints[..., 0], ints[..., 1:3]
            if band:
                # Band frame: cull gaussians whose footprint misses this
                # band (the elliptical y-extent, binning's own support
                # bound; clipped tile spans would re-admit every off-band
                # gaussian) and shift screen y by the band's first row.
                my = attrs[..., PACK_MY]
                rf = extents[..., 1].float()
                in_band = (my + rf >= y0) & (my - rf < y0 + band_h)
                radii = torch.where(in_band, radii, 0)
                extents = torch.where(in_band[..., None], extents, 0)
                tb = table.clone()
                tb[:, PACK_MY] -= y0
            if tiles:
                color, alpha, depth_acc, binning = composite(
                    tb, radii, extents, depths, width, band_h, tile, cfg.pair_capacity, cfg.chunk_size,
                    bool(cfg.depth_loss), f.pair_dummy,
                )
                parts.append((color, alpha, depth_acc))
                overflow = torch.maximum(overflow, binning.overflow.to(torch.int32))
                pairs = torch.maximum(pairs, binning.tile_starts[-1].to(torch.int32))
            else:
                parts.append(rasterize_reference(
                    _projected(tb, radii, extents, c), tb.view(c, n_global, PACK_COLS)[..., PACK_R:PACK_B + 1],
                    width, band_h, tile_size=tile,
                ))
        mark("composite")
        if band:
            # The full image from the bands; the gather's backward hands
            # each band its rows' cotangent, n_data-fold.
            img = torch.cat([torch.cat([co, al[..., None], de[..., None]], -1) for co, al, de in parts], 1)
            img = col.all_gather(img, mesh.data, dim=1)[:, :height]
            color, alpha, depth_acc = img[..., 0:3], img[..., 3], img[..., 4]
        else:
            color, alpha, depth_acc = parts[0]
        if f.bkgd is not None:
            color = color + (1.0 - alpha)[..., None] * f.bkgd[:, None, None, :]
        mark("render")

        # Cameras: the disparity loss over the GLOBAL valid count, times
        # n_data, so that the mean over "data" gives the one-device sum /
        # count. Bands: every rank holds the whole batch.
        depth_count = None if band else (
            lambda valid: torch.clamp(col.psum_raw(valid.sum().float(), mesh.data), min=1.0) / n_data
        )
        loss, l1, ssim_val, alpha = image_loss(
            cfg, f.la, batch, color, alpha[..., None],
            depth_acc / torch.clamp(alpha, min=1e-10) if cfg.depth_loss else None, depth_count,
        )
        # Regularisers over the whole capacity: psum the shard sums so the
        # loss stays the same on every gauss rank (the fold factor needs it).
        loss = loss + regulariser_loss(
            cfg, alive, f.opacities, f.scales,
            mean=lambda x: col.psum(x.sum(), mesh.gauss) / (x.numel() * n_gauss),
        )
        mark("loss")

        grads, taps, agrads = f.gradients(loss, [f.dummy] + ([f.pair_dummy] if f.pair_dummy is not None else []))
        mark("backward")
        grads = col.psum_flat(grads, mesh.data, norm)
        agrads = col.psum_flat(agrads, mesh.world, norm)
        stats = radii_local = None
        if frame.track_stats:
            if f.pair_dummy is not None:
                # Pair taps cross no collective: once per rank (d-fold in
                # band mode, summed over bands), the same on every gauss
                # rank; this shard's columns, by the data-mean factor.
                taps_g = taps[1]
                if band:
                    taps_g = col.psum_raw(taps_g, mesh.data)
                stats = taps_g.reshape(c, n_global, 2)[:, rows] * (1.0 / n_data)
            elif band:  # the means2d tap rides both gathers: d*g-fold
                stats = col.psum_raw(taps[0], mesh.data) * norm
            else:
                stats = taps[0] * norm
            radii_local = ints[..., 0][:, rows]
            if not band:  # the densification statistics sum over every camera
                stats = col.gather_raw(stats, mesh.data, 0)
                radii_local = col.gather_raw(radii_local.contiguous(), mesh.data, 0)
        mark("reduce")
        adam, aux_opt, sstate = frame.update(
            p, grads, adam, aux, aux_opt, agrads, sstate, stats, radii_local, step, mark
        )
        # Pair capacity is per data shard: report the worst, so the
        # Runner's retune sizes the capacity for it.
        worst = col.pmax(torch.stack([overflow.to(torch.int32), pairs.to(torch.int32)]), mesh.data)
        means = torch.stack([l1.detach(), ssim_val.detach(), alpha.detach().mean()])
        if not band:
            means = col.pmean(means, mesh.data)
        metrics = dict(
            loss=col.pmean(loss.detach(), mesh.world), l1=means[0], ssim=means[1],
            overflow=worst[0], alpha_mean=means[2], pairs=worst[1],
        )
        return gstate, adam, sstate, aux, aux_opt, metrics

    return train_step
