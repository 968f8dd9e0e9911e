"""Parity: the port's tile binning against ``gs_init_tpu/ops/tiles.py``.

tile_starts, overflow and the per-gaussian pair segments must be
identical; each tile must hold the same gaussians, in the same order when
depths are distinct (the JAX sort is unstable on ties).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_init_tpu.ops.projection import project_gaussians as j_project
from gs_init_tpu.ops.tiles import bin_gaussians as j_bin
from gs_init_tpu_torch.ops.tiles import bin_gaussians, tile_spans
from torch_parity import H, W, n, scene, t


def _proj(rng, n_g=64):
    sc = scene(rng, n_g=n_g)
    return j_project(
        *(jnp.asarray(sc[k]) for k in ("means", "quats", "scales", "opacities", "viewmats", "Ks")),
        W, H,
    )


def _both(proj, tile, cap, chunk=128):
    jb = j_bin(proj.means2d, proj.radii, proj.depths, W, H, tile, cap, chunk=chunk,
               extents=proj.extents)
    pb = bin_gaussians(
        t(proj.means2d), t(proj.radii, torch.int32), t(proj.depths), W, H, tile, cap,
        chunk=chunk, extents=t(proj.extents, torch.int32),
    )
    return jb, pb


@pytest.mark.parametrize("tile", [8, 16])
def test_binning_matches(rng, tile):
    proj = _proj(rng)
    jb, pb = _both(proj, tile, 8192)
    assert (pb.num_tiles_x, pb.num_tiles_y) == (jb.num_tiles_x, jb.num_tiles_y)
    np.testing.assert_array_equal(n(pb.tile_starts), n(jb.tile_starts))
    np.testing.assert_array_equal(n(pb.gauss_offsets), n(jb.gauss_offsets))
    np.testing.assert_array_equal(n(pb.gauss_counts), n(jb.gauss_counts))
    assert int(pb.overflow) == int(jb.overflow) == 0
    total = int(n(pb.tile_starts)[-1])
    assert total > 100
    depths = n(proj.depths)[0]
    assert len(np.unique(depths)) == len(depths)  # distinct: order is defined
    np.testing.assert_array_equal(n(pb.gid_sorted)[:total], n(jb.gid_sorted)[:total])


def test_overflow_matches(rng):
    proj = _proj(rng)
    jb, pb = _both(proj, 16, 128)
    assert int(jb.overflow) > 0
    assert int(pb.overflow) == int(jb.overflow)
    np.testing.assert_array_equal(n(pb.tile_starts), n(jb.tile_starts))
    starts = n(pb.tile_starts)
    gp, gj = n(pb.gid_sorted), n(jb.gid_sorted)
    for k in range(len(starts) - 1):
        seg = slice(starts[k], starts[k + 1])
        assert sorted(gp[seg]) == sorted(gj[seg])


def test_tile_spans_culled_and_clipped():
    m2 = torch.tensor([[-40.0, 10.0], [30.0, 20.0], [63.0, 47.0]])
    radii = torch.tensor([5, 0, 100], dtype=torch.int32)
    (x0, x1, y0, y1), counts, (ntx, nty) = tile_spans(m2, radii, W, H, 16)
    assert (ntx, nty) == (4, 3)
    assert counts.tolist() == [1, 0, 12]  # spans clip to the grid; culled -> 0
    assert (x0[2], x1[2], y0[2], y1[2]) == (0, 3, 0, 2)
