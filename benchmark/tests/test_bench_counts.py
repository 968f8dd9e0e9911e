"""The benchmark's operation counts against hand counts on tiny inputs."""
from __future__ import annotations

import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.counts import composite, step_ops  # noqa: E402

TILE = 16


def table_of(rows):
    """Table rows [n, 16] from (mx, my, a, b, c, opacity): the conic's
    diagonal halved, as the compositor's table holds it."""
    t = torch.zeros((len(rows), 16))
    for i, (mx, my, a, b, c, o) in enumerate(rows):
        t[i, :6] = torch.tensor([mx, my, 0.5 * a, b, 0.5 * c, o])
    return t


def one_tile(rows):
    n = len(rows)
    return table_of(rows), torch.arange(n, dtype=torch.int32), torch.tensor([0, n], dtype=torch.int32)


def hand_count(rows):
    """Front to back per pixel, each pair where it composites, until the
    pixel's transmittance is at most 1e-4."""
    comp = uncl = 0
    for y in range(TILE):
        for x in range(TILE):
            t = 1.0
            for mx, my, a, b, c, o in rows:
                if t <= 1e-4:
                    break
                dx, dy = x + 0.5 - mx, y + 0.5 - my
                sigma = 0.5 * a * dx * dx + 0.5 * c * dy * dy + b * dx * dy
                araw = o * math.exp(-sigma)
                if sigma >= 0 and araw >= 1 / 255:
                    comp += 1
                    uncl += araw <= 0.999
                    t *= 1 - min(araw, 0.999)
    return comp, uncl


@pytest.mark.parametrize("per_pass", [1, 3, 256])
def test_one_pair_over_one_tile(per_pass):
    rows = [(8.0, 8.0, 0.2, 0.0, 0.2, 0.9)]
    table, gid, starts = one_tile(rows)
    comp, uncl, used = composite.composited(table, gid, starts, 1, 1, 1, TILE, pairs_per_pass=per_pass)
    assert (comp, uncl) == hand_count(rows)
    assert used == 1
    # Inside the disc where 0.9 exp(-0.1 r^2) >= 1/255.
    r2 = 10 * math.log(0.9 * 255)
    assert comp == sum((x + 0.5 - 8) ** 2 + (y + 0.5 - 8) ** 2 <= r2 for x in range(TILE) for y in range(TILE))


@pytest.mark.parametrize("per_pass", [1, 2, 5, 256])
def test_opaque_layers_end_each_pixel(per_pass):
    """Three nearly opaque layers over the whole tile: the third is needed
    nowhere (0.001^2 < 1e-4), the later ones neither; the count does not
    depend on how many pairs a pass takes."""
    flat = (8.0, 8.0, 1e-6, 0.0, 1e-6, 1.0)
    rows = [flat] * 5
    table, gid, starts = one_tile(rows)
    comp, uncl, _ = composite.composited(table, gid, starts, 1, 1, 1, TILE, pairs_per_pass=per_pass)
    assert comp == 2 * TILE * TILE
    assert uncl == 0
    assert (comp, uncl) == hand_count(rows)


def test_random_pairs_match_hand_count():
    rng = np.random.default_rng(0)
    rows = [(float(rng.uniform(0, 16)), float(rng.uniform(0, 16)), float(rng.uniform(0.05, 1)),
             float(rng.uniform(-0.02, 0.02)), float(rng.uniform(0.05, 1)), float(rng.uniform(0.1, 1)))
            for _ in range(12)]
    table, gid, starts = one_tile(rows)
    for per_pass in (1, 4, 256):
        comp, uncl, _ = composite.composited(table, gid, starts, 1, 1, 1, TILE, pairs_per_pass=per_pass)
        assert (comp, uncl) == hand_count(rows)


def test_work_operations_and_bytes():
    rows = [(8.0, 8.0, 0.2, 0.0, 0.2, 0.9)]
    table, gid, starts = one_tile(rows)
    w = composite.work(table, gid, starts, 1, 1, 1, TILE, chunk=128)
    comp, uncl = hand_count(rows)
    assert w["fwd_ops"] == comp * (11 + 5 + 13)
    assert w["bwd_ops"] == comp * (11 + 5 + 29) + uncl * 13
    assert w["fwd_bytes"] == 1 * 10 * 4 + 1 * 4 + 2 * 4 + TILE * TILE * 5 * 4
    assert w["bwd_bytes"] == w["fwd_bytes"] + TILE * TILE * 4 * 4 + 9 * 4
    assert w == composite.work(table, gid, starts, 1, 1, 1, TILE, chunk=32)


def test_step_ops_add_up():
    w = dict(fwd_ops=1000, bwd_ops=3000)
    n = step_ops.step_ops(w, alive=10, capacity=20, pixels=4, sh_degree=0)
    per_g = 3 * (step_ops.OPS_PROJECT + step_ops.sh_ops(0)) + step_ops.OPS_STATS
    assert n == 10 * per_g + 4000 + 3 * step_ops.OPS_LOSS_PER_PIXEL * 4 * 3 + step_ops.OPS_ADAM * 59 * 20
    assert step_ops.sh_ops(3) > step_ops.sh_ops(0)
