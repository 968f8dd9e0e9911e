"""The work the tile compositor's inputs need, counted by the benchmark's own
plain compositing: no count is read from the port's kernels.

Inputs: the per-gaussian table ``[C*N, 16]`` (mx, my, the conic with its
diagonal halved, opacity, r, g, b, depth), the depth-sorted pair ids and
each tile's range of them. A pixel takes its tile's pairs front to back and
is done once its transmittance has fallen to ``TERM_EPS``; a pair needs
arithmetic at a pixel only where it composites there (alpha >= 1/255): an
ideal kernel knows the rest from the pair's bounds. So the counts do not
depend on any chunking of the pairs.

Operations per composited pair-pixel, from the compositor's per-pixel
arithmetic (copied from ``chip_smoke.py``'s ``OPS_*``): sigma and its cut 11,
alpha 5; forward compositing 13; backward 29, and 13 more where alpha is not
clamped. Bytes: each input read once (the 10 attributes of each gaussian
that has a pair, the pair ids, the tile ranges), each output written once:
the forward's colour, alpha and final transmittance per pixel; the backward
reads those and the colour and alpha cotangents and writes 9 gradients per
gaussian (the depth row takes none in RGB training).
"""
from __future__ import annotations

import torch

ALPHA_MAX = 0.999
ALPHA_MIN = 1.0 / 255.0
TERM_EPS = 1e-4
NATTR = 10
OPS_SIGMA = 11
OPS_ALPHA = 5
OPS_FWD_COMPOSITED = 13
OPS_BWD_COMPOSITED = 29
OPS_BWD_UNCLAMPED = 13
FWD_OUT_ROWS = 5  # r, g, b, alpha, T
BWD_COTANGENT_ROWS = 4  # r, g, b, alpha
BWD_GRADS = 9
PAIRS_PER_PASS = 256  # pairs of each tile taken together; the counts do not depend on it


@torch.no_grad()
def composited(table, gid_sorted, tile_starts, num_tiles, ntx, nty, tile, pairs_per_pass=PAIRS_PER_PASS,
               tiles_per_block=256):
    """(composited, unclamped) pair-pixels, and the gaussians with a pair."""
    dev = table.device
    starts = tile_starts[:-1].long()
    ends = tile_starts[1:].long()
    npix = tile * tile
    col = torch.arange(npix, device=dev)
    comp = uncl = 0
    for b0 in range(0, num_tiles, tiles_per_block):
        tiles = torch.arange(b0, min(b0 + tiles_per_block, num_tiles), device=dev)
        s, e = starts[tiles], ends[tiles]
        tloc = tiles % (ntx * nty)
        px = ((tloc % ntx) * tile)[:, None] + (col % tile)[None, :] + 0.5
        py = ((tloc // ntx) * tile)[:, None] + (col // tile)[None, :] + 0.5
        t = torch.ones((len(tiles), npix), dtype=torch.float32, device=dev)
        i = 0
        while True:
            live = torch.nonzero((s + i < e) & (t > TERM_EPS).any(1)).flatten()
            if live.numel() == 0:
                break
            idx = s[live, None] + i + torch.arange(pairs_per_pass, device=dev)[None]
            inr = idx < e[live, None]
            g = gid_sorted[idx.clamp(max=gid_sorted.shape[0] - 1)].long()
            rows = torch.where(inr[..., None], table[g][..., :6], 0.0)  # [L, K, 6]
            dx = px[live, None, :] - rows[..., 0:1]
            dy = py[live, None, :] - rows[..., 1:2]
            sigma = rows[..., 2:3] * dx * dx + rows[..., 4:5] * dy * dy + rows[..., 3:4] * dx * dy
            araw = rows[..., 5:6] * torch.exp(-sigma)
            ok = inr[..., None] & (sigma >= 0) & (araw >= ALPHA_MIN)
            alpha = torch.where(ok, araw.clamp(max=ALPHA_MAX), 0.0)
            # Transmittance in front of each pair: the pixel is still live there.
            tin = t[live][:, None, :] * torch.cumprod(torch.cat(
                [torch.ones_like(alpha[:, :1]), 1.0 - alpha[:, :-1]], 1), 1)
            need = ok & (tin > TERM_EPS)
            comp += int(need.sum())
            uncl += int((need & (araw <= ALPHA_MAX)).sum())
            t[live] = tin[:, -1] * (1.0 - alpha[:, -1])
            i += pairs_per_pass
    n_pairs = int(tile_starts[-1])
    used = torch.zeros(table.shape[0], dtype=torch.bool, device=dev)
    used[gid_sorted[:n_pairs].long()] = True
    return comp, uncl, int(used.sum())


def work(table, gid_sorted, tile_starts, num_tiles, ntx, nty, tile, chunk=None):
    """Operations and bytes of one forward and one backward over these
    inputs (``chunk``, the kernel's pairs per pass, is taken and ignored)."""
    comp, uncl, rows = composited(table, gid_sorted, tile_starts, num_tiles, ntx, nty, tile)
    pairs = int(tile_starts[-1])
    pixels = num_tiles * tile * tile
    in_bytes = rows * NATTR * 4 + pairs * 4 + (num_tiles + 1) * 4
    fwd_out = pixels * FWD_OUT_ROWS * 4
    return dict(
        composited=comp, unclamped=uncl, rows=rows, pairs=pairs, pixels=pixels,
        fwd_ops=comp * (OPS_SIGMA + OPS_ALPHA + OPS_FWD_COMPOSITED),
        bwd_ops=comp * (OPS_SIGMA + OPS_ALPHA + OPS_BWD_COMPOSITED) + uncl * OPS_BWD_UNCLAMPED,
        fwd_bytes=in_bytes + fwd_out,
        bwd_bytes=in_bytes + fwd_out + pixels * BWD_COTANGENT_ROWS * 4 + rows * BWD_GRADS * 4,
    )
