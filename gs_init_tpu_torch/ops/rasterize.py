"""Differentiable tile compositor: CUDA kernels and their plain twins.

Port of ``gs_init_tpu/ops/rasterize.py::render_tiles`` with the same
boundary: forward takes the per-gaussian table ``[C*N, 16]`` plus the
binning and returns ``out [num_tiles, 8, tile*tile]`` (rows r, g, b, acc,
depth, T_final, chunks processed, spare); backward returns ``dtable
[C*N, 16]`` and the absgrad tap's gradient ``[C*N, 2]``.

The semantics are the Pallas kernels' f32 path: alpha clamp 0.999, skip
below 1/255, 128-pair chunks of the tile's depth-sorted range, a tile
stops after the whole chunk in which its last pixel fell to T <= 1e-4,
and the backward replays exactly the processed chunks front to back.

On a CUDA tensor each wrapper launches its kernel (``csrc/composite_fwd.cu``,
``csrc/composite_bwd.cu``) or raises; on a CPU tensor it runs the plain
PyTorch version beside it, which the tests hold against the JAX package and
``chip_smoke.py`` holds the kernels against on the card. The plain versions
walk the same chunks vectorised over tiles ([tiles, chunk, pixels] per
chunk index with a per-tile live mask); the plain backward is the explicit
replay, not autograd through the plain forward.

``pair_bounds`` mirrors the bounds the CUDA kernels compute for each
staged pair (a cut on sigma and a bounding box), which let them skip work
whose result is known to be "not composited"; the tests and
``chip_smoke.py`` check it against ``_alpha_terms``. The kernels take the
tiles longest first (``tile_order``); outputs land at the same addresses.

``scan_probe`` (``csrc/scan_probe.cu``) ports the JAX package's third
Pallas kernel, the scan probe that ``_scan_mode`` runs once before the
first compositor trace; ``check_scan`` runs it once per train step
function (``engine/train_step.py``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels
from .tiles import PACK_COLS, PACK_DEPTH

ALPHA_MAX = 0.999
ALPHA_MIN = 1.0 / 255.0
TERM_EPS = 1e-4
OUT_ROWS = 8
ROW_R, ROW_G, ROW_B, ROW_ACC, ROW_DEPTH, ROW_T, ROW_NPROC = 0, 1, 2, 3, 4, 5, 6
NATTR = 10  # table columns the compositor reads: mx my ca cb cc opa r g b d
MAX_TILE_PIXELS = 1024  # 256 threads x 4 pixels in the CUDA kernels
# Shared memory of a block per pair of a chunk, as the C entry points size
# it: two staged 48-byte rows (double buffering) and three pair ids; the
# backward adds eight warps' ten partial sums. A block may take at most
# 232,448 B on sm_90, which bounds the chunk (543 pairs).
FWD_SMEM_PER_PAIR = 2 * 48 + 3 * 4
BWD_SMEM_PER_PAIR = FWD_SMEM_PER_PAIR + 8 * 10 * 4
MAX_CHUNK = 232_448 // BWD_SMEM_PER_PAIR


# ----------------------------------------------------------------- helpers


def _chunk_windows(tile_starts: torch.Tensor, chunk: int):
    """Per tile: start, end, aligned window base c0, and chunk count."""
    starts = tile_starts[:-1].long()
    ends = tile_starts[1:].long()
    c0 = torch.div(starts, chunk, rounding_mode="floor") * chunk
    nchunks = torch.where(
        ends > starts, torch.div(ends - c0 + chunk - 1, chunk, rounding_mode="floor"), 0
    )
    return starts, ends, c0, nchunks


def _pixel_coords(tiles: torch.Tensor, tile: int, ntx: int, nty: int):
    """Pixel-centre coordinates [L, 1, P] of the given tiles."""
    pixels = tile * tile
    tloc = tiles % (ntx * nty)
    col = torch.arange(pixels, device=tiles.device)
    px = ((tloc % ntx) * tile)[:, None] + (col % tile)[None, :]
    py = (torch.div(tloc, ntx, rounding_mode="floor") * tile)[:, None] + (
        torch.div(col, tile, rounding_mode="floor")
    )[None, :]
    return (px.float() + 0.5)[:, None, :], (py.float() + 0.5)[:, None, :]


def _gather_chunk(table, gid_sorted, starts, ends, c0, i, chunk):
    """Pair rows [L, chunk, 16] of chunk i of the given tiles, plus the
    in-range mask [L, chunk] and the gaussian ids. Rows outside the tile's
    range of the aligned window are zeros (opacity 0: skipped), as the CUDA
    kernels stage them, so no other gaussian's values leak in."""
    idx = c0[:, None] + i * chunk + torch.arange(chunk, device=c0.device)[None, :]
    inrange = (idx >= starts[:, None]) & (idx < ends[:, None])
    gid = torch.where(
        inrange, gid_sorted[idx.clamp(max=gid_sorted.shape[0] - 1)].long(), 0
    )
    return torch.where(inrange[:, :, None], table[gid], 0.0), inrange, gid


def _alpha_terms(rows, inrange, px, py):
    """Shared fwd/bwd alpha of one chunk, [L, chunk, P]; the diagonal conic
    entries arrive pre-halved (tiles.pack_table). Same operation order as
    the CUDA kernels' alpha_at, so both round alike."""
    col = lambda c: rows[:, :, c : c + 1]  # [L, chunk, 1]
    mx, my, ca, cb, cc, opa = (col(c) for c in range(6))
    dx = px - mx
    dy = py - my
    sigma = ca * dx * dx + cc * dy * dy + cb * dx * dy
    e = torch.exp(-sigma)
    araw = opa * e
    ok = inrange[:, :, None] & (sigma >= 0.0) & (araw >= ALPHA_MIN)
    alpha = torch.where(ok, torch.clamp(araw, max=ALPHA_MAX), 0.0)
    unclamped = ok & (araw <= ALPHA_MAX)
    return alpha, dict(dx=dx, dy=dy, e=e, unclamped=unclamped, ca=ca, cb=cb, cc=cc, opa=opa)


def pair_bounds(rows: torch.Tensor):
    """The CUDA kernels' bounds of each pair (``csrc/composite_common.cuh``
    ``pair_bounds``), from rows [..., >= 6] f32 (mx, my, ca, cb, cc, opa).

    Returns ``(s_cut, hx, hy)``: a pixel at which ``_alpha_terms`` gives
    ``ok`` has sigma <= s_cut (f32) and lies within hx, hy (f64) of the
    mean. A pair with opacity below 1/255 never composites: s_cut = -inf,
    hx = hy = -1. Non-finite inputs give s_cut = +inf; they and
    non-positive or near-degenerate conics give an unbounded box (inf). The
    source comment of the CUDA function argues the margins."""
    mx, my, ca, cb, cc, opa = (rows[..., c] for c in range(6))
    finite = torch.stack([mx, my, ca, cb, cc, opa]).isfinite().all(dim=0)
    s = torch.log(255.0 * opa)
    s_cut = s + 1e-3 * s.abs() + 1e-3
    a, b, c = ca.double(), cb.double(), cc.double()
    d = a * c - 0.25 * b * b
    boxed = finite & (a > 0) & (c > 0) & (d > 1e-5 * a * c)  # else degenerate: no box
    sb = s_cut.double() * (1.0 + 4e-6 * (a * c / d))
    hx = torch.sqrt(sb * c / d) * (1.0 + 1e-5) + 1e-3
    hy = torch.sqrt(sb * a / d) * (1.0 + 1e-5) + 1e-3
    never = ~(opa >= ALPHA_MIN)
    inf = float("inf")
    s_cut = torch.where(never, -inf, torch.where(finite, s_cut, inf))
    hx = torch.where(never, -1.0, torch.where(boxed, hx, inf))
    hy = torch.where(never, -1.0, torch.where(boxed, hy, inf))
    return s_cut, hx, hy


def tile_order(counts: torch.Tensor) -> torch.Tensor:
    """Tile ids by descending ``counts`` (ties in tile order), int32: block
    b of a compositor launch works on tile ``order[b]``, so the longest
    tiles start first and a long tile does not start in the last wave."""
    return torch.argsort(counts, descending=True, stable=True).to(torch.int32)


def _exclusive_cumprod(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    ones = torch.ones_like(x.narrow(dim, 0, 1))
    return torch.cat([ones, torch.cumprod(x, dim).narrow(dim, 0, x.shape[dim] - 1)], dim)


# ------------------------------------------------------- plain PyTorch twins


def composite_fwd_plain(
    table: torch.Tensor,  # [C*N, 16] f32
    gid_sorted: torch.Tensor,  # [PAIR_CAP] int
    tile_starts: torch.Tensor,  # [num_tiles + 1] int
    num_tiles: int,
    ntx: int,
    nty: int,
    tile: int,
    chunk: int,
) -> torch.Tensor:
    """Plain version of the forward kernel; differentiable in ``table``
    (the tests check the explicit backward against autograd through it)."""
    pixels = tile * tile
    dev = table.device
    starts, ends, c0, nchunks = _chunk_windows(tile_starts, chunk)
    color = torch.zeros((num_tiles, 4, pixels), dtype=table.dtype, device=dev)
    tcur = torch.ones((num_tiles, pixels), dtype=table.dtype, device=dev)
    nproc = torch.zeros((num_tiles,), dtype=torch.long, device=dev)
    alive = nchunks > 0
    i = 0
    while True:
        live = torch.nonzero(alive & (i < nchunks)).flatten()
        if live.numel() == 0:
            break
        rows, inrange, _ = _gather_chunk(
            table, gid_sorted, starts[live], ends[live], c0[live], i, chunk
        )
        px, py = _pixel_coords(live, tile, ntx, nty)
        alpha, _ = _alpha_terms(rows, inrange, px, py)
        om = 1.0 - alpha
        pexcl = _exclusive_cumprod(om)
        tk = tcur[live][:, None, :] * pexcl  # [L, chunk, P]
        w = alpha * tk
        contrib = torch.einsum("lkp,lkc->lcp", w, rows[:, :, 6:10])  # r g b d
        color = color.index_add(0, live, contrib)
        tnew = tcur[live] * (pexcl[:, -1, :] * om[:, -1, :])
        tcur = tcur.index_copy(0, live, tnew)
        nproc = nproc.index_add(0, live, torch.ones_like(live))
        alive = alive.index_copy(0, live, tnew.amax(dim=1) > TERM_EPS)
        i += 1
    out = torch.stack(
        [
            color[:, 0], color[:, 1], color[:, 2], 1.0 - tcur, color[:, 3], tcur,
            nproc[:, None].to(table.dtype).expand(num_tiles, pixels),
            torch.zeros_like(tcur),
        ],
        dim=1,
    )
    return out


def composite_bwd_plain(
    table: torch.Tensor,
    gid_sorted: torch.Tensor,
    tile_starts: torch.Tensor,
    fwd_out: torch.Tensor,  # [num_tiles, 8, P]
    g_out: torch.Tensor,  # [num_tiles, 8, P]
    num_tiles: int,
    ntx: int,
    nty: int,
    tile: int,
    chunk: int,
    want_absgrad: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel: the same front-to-back replay
    of the processed chunks (suffix sums from the forward totals, Kahan
    carry across chunks), reduced per pair and added into per-gaussian
    rows with ``index_add_``."""
    dev = table.device
    starts, ends, c0, _ = _chunk_windows(tile_starts, chunk)
    nproc = fwd_out[:, ROW_NPROC, 0].long()
    dtable = torch.zeros_like(table)
    absgrad = torch.zeros((table.shape[0], 2), dtype=table.dtype, device=dev)
    g_rgbd = g_out[:, [ROW_R, ROW_G, ROW_B, ROW_DEPTH], :]  # [T, 4, P]
    out_rgbd = fwd_out[:, [ROW_R, ROW_G, ROW_B, ROW_DEPTH], :]
    g_tn = g_out[:, ROW_ACC, :] - g_out[:, ROW_T, :]
    gt = g_tn * fwd_out[:, ROW_T, :]
    r_tot = (g_rgbd * out_rgbd).sum(dim=1)
    tcur = torch.ones_like(gt)
    rrem = r_tot - gt  # sum of u over chunks >= i, less the T_final term
    comp = torch.zeros_like(gt)  # Kahan compensation of rrem
    i = 0
    while True:
        live = torch.nonzero((i < nproc) & (ends > starts)).flatten()
        if live.numel() == 0:
            break
        rows, inrange, gid = _gather_chunk(
            table, gid_sorted, starts[live], ends[live], c0[live], i, chunk
        )
        px, py = _pixel_coords(live, tile, ntx, nty)
        alpha, aux = _alpha_terms(rows, inrange, px, py)
        om = 1.0 - alpha
        inv1m = 1.0 / om
        pexcl = _exclusive_cumprod(om)
        tk = tcur[live][:, None, :] * pexcl
        w = alpha * tk
        gr = g_rgbd[live]  # [L, 4, P]
        q = torch.einsum("lkc,lcp->lkp", rows[:, :, 6:10], gr)
        u = q * w
        usum = u.sum(dim=1)
        y = -usum - comp[live]
        rr = rrem[live]
        rnext = rr + y
        comp = comp.index_copy(0, live, (rnext - rr) - y)
        rrem = rrem.index_copy(0, live, rnext)
        rev = torch.flip(torch.cumsum(torch.flip(u, [1]), 1), [1])
        r_in = torch.cat([rev[:, 1:], torch.zeros_like(rev[:, :1])], 1) + rnext[:, None, :]
        dalpha = q * tk - r_in * inv1m
        dcols = torch.einsum("lkp,lcp->lkc", w, gr)  # dr dg db ddepth
        de = dalpha * torch.where(aux["unclamped"], aux["e"], 0.0)
        dopa = de.sum(dim=2)
        dsig = de * (-aux["opa"])
        dx, dy = aux["dx"], aux["dy"]
        dsx = dsig * dx
        dsy = dsig * dy
        dca = (dsx * dx).sum(dim=2)
        dcb = (dsx * dy).sum(dim=2)
        dcc = (dsy * dy).sum(dim=2)
        sx = dsx.sum(dim=2)
        sy = dsy.sum(dim=2)
        ca, cb, cc = (rows[:, :, c] for c in (2, 3, 4))
        dmx = -(2.0 * ca * sx + cb * sy)
        dmy = -(2.0 * cc * sy + cb * sx)
        grads = torch.stack([dmx, dmy, dca, dcb, dcc, dopa], dim=2)
        grads = torch.cat([grads, dcols], dim=2)  # [L, chunk, 10]
        m = inrange.reshape(-1)
        flat_gid = gid.reshape(-1)[m]
        dtable[:, :NATTR].index_add_(0, flat_gid, grads.reshape(-1, NATTR)[m])
        if want_absgrad:
            dm = torch.stack([dmx, dmy], dim=2).abs().reshape(-1, 2)[m]
            absgrad.index_add_(0, flat_gid, dm)
        tcur = tcur.index_copy(0, live, tcur[live] * (pexcl[:, -1, :] * om[:, -1, :]))
        i += 1
    return dtable, absgrad


def scan_probe_plain(x: torch.Tensor, m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exclusive prefix sum of ``x`` and exclusive prefix product of ``m``
    along axis 0 (the JAX probe's ``_hs_scan`` pair)."""
    zeros = torch.zeros_like(x[:1])
    return torch.cat([zeros, torch.cumsum(x, 0)[:-1]], 0), _exclusive_cumprod(m, 0)


# ------------------------------------------------------------ kernel wrappers


def _check(table, gid_sorted, tile_starts, num_tiles, tile, chunk):
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[1] != PACK_COLS:
        raise ValueError(f"table must be float32 [C*N, {PACK_COLS}], got {tuple(table.shape)} {table.dtype}")
    if gid_sorted.dtype != torch.int32 or tile_starts.dtype != torch.int32:
        raise ValueError("gid_sorted and tile_starts must be int32")
    if tile_starts.shape != (num_tiles + 1,):
        raise ValueError(f"tile_starts must have num_tiles + 1 = {num_tiles + 1} entries")
    if tile * tile > MAX_TILE_PIXELS or not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"tile {tile} / chunk {chunk} outside the kernels' limits")
    for name, x in (("table", table), ("gid_sorted", gid_sorted), ("tile_starts", tile_starts)):
        if not x.is_cuda or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
        if x.device != table.device:
            raise ValueError(f"{name} is on {x.device}, table on {table.device}")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (16-byte row copies)")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_order(tile_starts, chunk, order):
    """The blocks' tile order: ``order`` if given (int32, one entry per
    tile), else the tiles by descending chunk count."""
    if order is None:
        return tile_order(_chunk_windows(tile_starts, chunk)[3])
    if order.dtype != torch.int32 or order.shape != (tile_starts.shape[0] - 1,) or order.device != tile_starts.device:
        raise ValueError("order must be int32 with one entry per tile, on the tiles' device")
    return order.contiguous()


def composite_fwd(table, gid_sorted, tile_starts, num_tiles, ntx, nty, tile, chunk, order=None):
    """Forward compositor: the CUDA kernel for CUDA tensors, else plain.
    ``order`` (``tile_order``; computed when not given) only sets which
    block takes which tile."""
    if not table.is_cuda:
        return composite_fwd_plain(
            table, gid_sorted, tile_starts, num_tiles, ntx, nty, tile, chunk
        )
    _check(table, gid_sorted, tile_starts, num_tiles, tile, chunk)
    fn = kernels.function("composite_fwd")
    out = torch.empty((num_tiles, OUT_ROWS, tile * tile), dtype=torch.float32, device=table.device)
    order = _launch_order(tile_starts, chunk, order)
    code = fn(
        table.data_ptr(), gid_sorted.data_ptr(), tile_starts.data_ptr(), order.data_ptr(), out.data_ptr(),
        num_tiles, ntx, nty, tile, chunk, _stream(table),
    )
    kernels.check("composite_fwd", code)
    kernels.LAUNCHES["composite_fwd"] += 1
    return out


def composite_bwd(
    table, gid_sorted, tile_starts, fwd_out, g_out, num_tiles, ntx, nty, tile, chunk,
    want_absgrad=True, order=None,
):
    """Backward compositor: the CUDA kernel for CUDA tensors, else plain.
    Returns (dtable [C*N, 16], absgrad [C*N, 2]). ``order`` as in
    ``composite_fwd``; the autograd op passes the forward's."""
    if not table.is_cuda:
        return composite_bwd_plain(
            table, gid_sorted, tile_starts, fwd_out, g_out, num_tiles, ntx, nty,
            tile, chunk, want_absgrad,
        )
    _check(table, gid_sorted, tile_starts, num_tiles, tile, chunk)
    shape = (num_tiles, OUT_ROWS, tile * tile)
    for name, x in (("fwd_out", fwd_out), ("g_out", g_out)):
        if x.shape != shape or x.dtype != torch.float32 or not x.is_cuda or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor of shape {shape}")
    fn = kernels.function("composite_bwd")
    dtable = torch.zeros_like(table)
    absgrad = torch.zeros((table.shape[0], 2), dtype=torch.float32, device=table.device)
    order = _launch_order(tile_starts, chunk, order)
    code = fn(
        table.data_ptr(), gid_sorted.data_ptr(), tile_starts.data_ptr(), order.data_ptr(),
        fwd_out.data_ptr(), g_out.data_ptr(), dtable.data_ptr(), absgrad.data_ptr(),
        num_tiles, ntx, nty, tile, chunk, int(want_absgrad), _stream(table),
    )
    kernels.check("composite_bwd", code)
    kernels.LAUNCHES["composite_bwd"] += 1
    return dtable, absgrad


def scan_probe(x: torch.Tensor, m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exclusive prefix sum and product along axis 0 of two f32 [n, p]
    arrays (n <= 1024): the CUDA kernel for CUDA tensors, else plain."""
    if not x.is_cuda:
        return scan_probe_plain(x, m)
    if x.dim() != 2 or x.shape[0] > 1024 or m.shape != x.shape:
        raise ValueError(f"x and m must share a shape [n <= 1024, p], got {tuple(x.shape)}, {tuple(m.shape)}")
    for name, a in (("x", x), ("m", m)):
        if a.dtype != torch.float32 or not a.is_cuda or not a.is_contiguous() or a.device != x.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor on {x.device}")
    fn = kernels.function("scan_probe")
    s, q = torch.empty_like(x), torch.empty_like(m)
    code = fn(x.data_ptr(), m.data_ptr(), s.data_ptr(), q.data_ptr(), x.shape[0], x.shape[1], _stream(x))
    kernels.check("scan_probe", code)
    kernels.LAUNCHES["scan_probe"] += 1
    return s, q


def scan_probe_inputs(device, n: int = 128):
    """The JAX probe's inputs: linspace(-1, 1) and linspace(0.5, 1), [n, n]."""
    x = torch.linspace(-1.0, 1.0, n * n, dtype=torch.float32, device=device).reshape(n, n)
    m = torch.linspace(0.5, 1.0, n * n, dtype=torch.float32, device=device).reshape(n, n)
    return x, m


def check_scan(device) -> None:
    """Counterpart of the JAX package's ``_scan_mode`` probe: run the scan
    kernel once on the probe's inputs and check it against float64 scans
    to the probe's 1e-3. The JAX probe picks between two TPU lowerings; the
    port has one, so a disagreement raises."""
    x, m = scan_probe_inputs(device)
    s, q = scan_probe(x, m)
    ws, wq = scan_probe_plain(x.double(), m.double())
    ok = bool(
        torch.isfinite(s).all() and torch.isfinite(q).all()
        and (s.double() - ws).abs().max() < 1e-3 and (q.double() - wq).abs().max() < 1e-3
    )
    if not ok:
        raise RuntimeError(f"the scan probe kernel disagrees with its float64 reference on {device}")


# ----------------------------------------------------------- autograd op


class _RenderTiles(torch.autograd.Function):
    @staticmethod
    def forward(
        ctx, table, pair_dummy, gid_sorted, tile_starts, num_tiles, ntx, nty,
        tile, chunk, want_depth_grad, want_absgrad,
    ):
        del pair_dummy  # zeros by contract: its gradient is the absgrad tap
        # One tile order for both kernels (the plain versions need none).
        order = _launch_order(tile_starts, chunk, None) if table.is_cuda else None
        out = composite_fwd(table, gid_sorted, tile_starts, num_tiles, ntx, nty, tile, chunk, order)
        ctx.save_for_backward(table, gid_sorted, tile_starts, out)
        ctx.order = order
        ctx.meta = (num_tiles, ntx, nty, tile, chunk, want_depth_grad, want_absgrad)
        return out

    @staticmethod
    def backward(ctx, g_out):
        table, gid_sorted, tile_starts, out = ctx.saved_tensors
        num_tiles, ntx, nty, tile, chunk, want_depth_grad, want_absgrad = ctx.meta
        dtable, absgrad = composite_bwd(
            table, gid_sorted, tile_starts, out, g_out.contiguous(),
            num_tiles, ntx, nty, tile, chunk, want_absgrad, ctx.order,
        )
        if not want_depth_grad:
            dtable[:, PACK_DEPTH] = 0.0
        return (dtable, absgrad if want_absgrad else None) + (None,) * 9


def render_tiles(
    table: torch.Tensor,  # [C*N, 16] f32 (tiles.pack_table)
    pair_dummy: torch.Tensor,  # [C*N, 2] zeros: absgrad gradient tap
    gid_sorted: torch.Tensor,
    tile_starts: torch.Tensor,
    num_tiles: int,
    ntx: int,
    nty: int,
    tile: int,
    chunk: int,
    want_depth_grad: bool = True,
    want_absgrad: bool = True,
) -> torch.Tensor:
    """Composite the binned pairs; returns out [num_tiles, 8, tile*tile].

    The gradient w.r.t. ``pair_dummy`` is the per-gaussian sum over its
    (pair, tile) records of |d mean2d| (gsplat's absgrad signal)."""
    return _RenderTiles.apply(
        table, pair_dummy, gid_sorted, tile_starts, num_tiles, ntx, nty, tile,
        chunk, want_depth_grad, want_absgrad,
    )


def unpack_tiles(out, num_cams, ntx, nty, tile, width, height):
    """[num_tiles, 8, tile*tile] -> color [C,H,W,3], alpha/depth [C,H,W]."""
    rows = ROW_DEPTH + 1
    x = out.reshape(num_cams, nty, ntx, OUT_ROWS, tile, tile)[:, :, :, :rows]
    x = x.permute(0, 3, 1, 4, 2, 5).reshape(num_cams, rows, nty * tile, ntx * tile)
    x = x[:, :, :height, :width]
    color = x[:, ROW_R : ROW_B + 1].permute(0, 2, 3, 1)
    return color, x[:, ROW_ACC], x[:, ROW_DEPTH]
