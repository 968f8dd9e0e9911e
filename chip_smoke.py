#!/usr/bin/env python3
"""Drive gs_init_tpu_torch's main path on one NVIDIA H100 and hold its CUDA
kernels against their plain PyTorch versions.

    python3 chip_smoke.py   # from the repo root, on a machine with one card

Phases, each fatal: an exception ends the script with a non-zero code and
no result line.

1. The card's name and power limit (nvidia-smi); the kernels of
   gs_init_tpu_torch/csrc/ built with nvcc for sm_90a, one process each,
   timed.
2. Kernel against plain on the card: the compositor forward and backward
   on a mid-size scene (20k gaussians, 640x480, tile 32, and again at
   tiles 8 and 24) and on the deep stack of 96 gaussians at opacity 0.95
   (tile 16, and again at tile 8), with a count of the
   composited pair-pixels that fall outside the kernels' pair bounds
   (ops/rasterize.pair_bounds), which must be 0; the scan probe on its
   [128, 128] inputs. Then one train step of a small scene on the card
   against the same step on the CPU, where the wrappers run the plain
   versions; the dense oracle (render impl="xla") against the tile
   compositor on the card (2,000 gaussians, 160x120, tile 16), values and
   gradients; and one points_from_depth (RANSAC, 2,500 hypotheses,
   noise-free stub depth, 1296x840) on the card against the CPU. Also the
   same train step with pose, appearance and bilateral-grid optimisation
   on (the aux groups' Adam moments too); MCMC relocation and noise with
   the same draws (8192 slots), and the card's own draws; color_correct on
   a natural and on a constant image (648x420).
3. The main path: the train step at bench.py's flagship scenario (300k
   gaussians, capacity 393216, 1296x840, tile 32, chunk 128, SH degree 3,
   L1 + SSIM, Adam, densification statistics), a step function built
   afresh, 3 warm-up and 20 timed steps. The launch counts are set to 0
   just before and read just after; each compositor kernel must have
   launched once per step, the scan probe once (at the step function's
   first call). A profiler window of 3 more steps gives the device time by
   kernel.
4. Each kernel against its plain version on the flagship step's own inputs
   (captured from one more step), the pair-bounds count again, the chunks
   per tile, the time of both, and each kernel's bound from this run's
   data. The scan probe's device-only time from the profiler, beside an
   empty kernel launched the same way (the launch floor).
3b. The flagship under the mcmc preset (init opacity 0.5, scale 0.1,
   opacity and scale regularisers), a relocation every 10 steps from step
   0 (2 in the 20 timed steps): step, relocation and noise times, device
   busy time, peak memory, and the alive count after each relocation,
   which must be the 5% tranche. Compositor launches once per step.
3c. The flagship with pose, appearance and bilateral-grid optimisation:
   step and phase times (the aux Adam has its own mark), peak memory.
5. The Runner end to end: a synthetic COLMAP scene at 648x420 with 12
   cameras, 300 steps with refines at steps 100 and 200; eval PSNR must
   rise from the initial gaussians to the trained ones.
6. Monocular-depth init. (a) At full width: scripts/e2e_quality.py's
   clustered scene at 1296x840 with 24 cameras and 250 SfM points (the
   foreground only), the stub predictor over the scene's surface depth
   (scale 0.37, shift 1.3), three configurations: the defaults (RANSAC,
   2,500 hypotheses, static stride 10, SfM density mask, SfM points
   included); an interpolated RBF scale map; the defaults plus LOF removal
   and the native KD-split merge. Seconds per image and for the whole
   init, points out, the recovered scale against 1/0.37 (median and worst
   over images), peak memory. (b) The three arms of E2E_QUALITY.json:
   the clustered scene at 648x420 with 12 cameras, 800 steps with
   e2e_quality.py's run() settings, for sfm, monocular_depth and sfm+mdi
   init; both mdi arms' eval PSNR must beat the sfm arm's, and the
   compositor kernels must launch once per train step. Then the sfm arm
   again with the batch prefetch thread off, for its steps per second.
6c. The depth networks (random weights from seed 0; float32, TF32 off).
   Metric3D small on one image at its full 616x1064 crop and
   Depth-Anything-V2 vits at 518x798, on the card against the CPU: depth,
   confidence and normals within NET_RTOL of each output's max, masks
   equal. Then every network at its default backbone and input size on
   phase 6a's 1296x840 images at batch 1 and 4 (the default predictor,
   Metric3D large: ViT-L over 3,349 tokens; DA-V2 vitl, 2,109; MoGe-2 and
   UniDepth vitl, about 1,800; DepthPro large at 1536: 35 + 1 crops of
   384): seconds per image, peak memory, finite depth, unit normals; each
   net's device time beside its ViT runs'. Then the init
   alone with pick_model's Metric3D large behind a timer (its share of
   predicting and aligning), and Runner(cfg) with init_type
   monocular_depth, predictor metric3d, backbone vitl on phase 6a's scene
   (depth cache off): more than the SfM points, 20 train steps with finite
   losses and one launch of each compositor kernel per step.
7. The trainer entry point: gs_init_tpu_torch.trainer.main on phase 5's
   scene, once per preset, 300 steps with checkpoints at 150 and 300, PLY
   export and compression; eval PSNR must rise, MCMC's alive count stay
   within cap_max, the exports hold every live splat, the eval-only
   restart (--ckpt) reproduce the run's PSNR to 1e-6 and write trajectory
   frames, and a Runner loaded from ckpt_150 take a finite step.

The line before the last lists the kernels as JSON; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# FP32 outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# FP32 operations per pair-pixel, counted from the CUDA sources' per-pixel
# loops: every evaluated pair-pixel (one inside its pair's bounding box)
# computes sigma and tests it against the pair's cut (2 sub, 6 mul, 2 add,
# 1 compare = 11); one with sigma <= s_cut goes on to alpha (negate, exp,
# 1 mul, 2 compares = 5); a pair-pixel that composites clamps alpha (1 min) and
# adds, in the forward, w = alpha (T P) (2), four colour/depth FMAs (8) and
# P *= 1 - alpha (2); in the backward 1 - alpha, 1/(1 - alpha), T_k, w (4),
# q (7), u and the Kahan carry (5), dalpha (3), four colour FMAs (8) and
# P (1); an unclamped pair adds de, dsig, dsx, dsy and six moment sums (13).
OPS_SIGMA = 11
OPS_ALPHA = 5
OPS_FWD_COMPOSITED = 13
OPS_BWD_COMPOSITED = 29
OPS_BWD_UNCLAMPED = 13

KERNELS = {
    "composite_fwd": dict(
        route="cuda",
        source="gs_init_tpu_torch/csrc/composite_fwd.cu",
        replaces="gs_init_tpu/ops/rasterize.py:426",
    ),
    "composite_bwd": dict(
        route="cuda",
        source="gs_init_tpu_torch/csrc/composite_bwd.cu",
        replaces="gs_init_tpu/ops/rasterize.py:574",
    ),
    "scan_probe": dict(
        route="cuda",
        source="gs_init_tpu_torch/csrc/scan_probe.cu",
        replaces="gs_init_tpu/ops/rasterize.py:154",
    ),
}

# Forward rows 0-3 and 5 (colour, alpha, T: all at most 1) within 1e-5 abs.
# Row 4, the accumulated depth, within 1e-5 of max(1, the row's max |value|):
# it sums w * depth with depths of 7 to 14 at the flagship, where the two
# summation orders round apart by more than 1e-5 abs (1.383e-5 measured on
# an H100). Row 6 (chunks processed) must be equal.
FWD_ATOL = 1e-5
DEPTH_RTOL = 1e-5
BWD_RTOL = 1e-4  # of each column's max |grad|: float atomics reorder the sums
# Scan probe: the sum within 1e-5 of its max |value|, the product within
# 1e-5 relative per element (a tree and a sequential order of n-1 roundings).
SCAN_RTOL = 1e-5
# A whole train step, card against CPU: the projection's autograd also runs
# on two math libraries, so the first Adam moment (0.1 x gradient) is held
# to 1e-3 of each leaf's max.
STEP_RTOL = 1e-3
# The aux groups' first Adam moments in that step, each within 1e-3 of its
# leaf's max: the bilateral grid's backward is a float scatter-add whose
# order differs on the card, and the appearance MLP runs on cuBLAS.
AUX_RTOL = 1e-3
# MCMC relocation and noise, card against CPU with the same draws: each
# parameter within 1e-6 of its leaf's max |value| (opacity and scale
# corrections through lgamma, exp and log on two math libraries).
MCMC_RTOL = 1e-6
# color_correct (float64 normal equations) on the card against the CPU.
CC_ATOL = 1e-5
# The dense oracle against the tile compositor on a scene where no tile
# stops early (T stays above 1e-4): forward within 1e-4 abs, gradients
# within 1e-3 of each leaf's max (two compositing orders, autograd through
# the oracle's log-space cumulative sums against the kernels' VJP).
ORACLE_ATOL = 1e-4
ORACLE_GRAD_RTOL = 1e-3
# points_from_depth on the card against the CPU with the same hypotheses:
# (s, t) within 1e-4 relative, masks equal.
PFD_RTOL = 1e-4
# The depth networks (float32, TF32 off) on the card against the CPU with
# the same random weights: depth, confidence and normals within 1e-4 of
# each output's max |value|, the tolerance tests/test_torch_predictors.py
# holds two loading routes to (cuDNN and the CPU sum a 12-layer ViT, the
# fuse blocks and four GRU iterations in other orders); masks equal.
NET_RTOL = 1e-4
# Unit normals out of the predictors, at full width.
NORMAL_ATOL = 1e-3


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters, warmup=1):
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


# ------------------------------------------------------------------ phase 1


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def build_kernels():
    from gs_init_tpu_torch import kernels

    t0 = time.perf_counter()
    secs = kernels.build()
    total = time.perf_counter() - t0
    for name, text in kernels.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log(f"build: {json.dumps({k: round(v, 3) for k, v in secs.items()})} "
        f"total {total:.3f} s (0 = library already built)")


# ------------------------------------------------------------------ phase 2


def compositor_case(dev, kind, tile=None, seed=0):
    """Project, bin and pack a random scene, at the kind's own tile size
    unless `tile` is given; returns the compositor's arguments and a random
    output cotangent."""
    import torch
    from gs_init_tpu_torch.ops.projection import project_gaussians
    from gs_init_tpu_torch.ops.tiles import bin_gaussians, pack_table

    rng = np.random.default_rng(seed)
    if kind == "deep":
        # tests/test_rasterize_pallas.py's early-termination stack, with the
        # wider footprint of tests/torch_parity.py so that whole tiles
        # saturate and stop before their last chunk.
        n, width, height, cap = 96, 64, 48, 8192
        tile = tile or 16
        means = np.zeros((n, 3))
        means[:, 0] = rng.uniform(-0.1, 0.1, n)
        means[:, 1] = rng.uniform(-0.1, 0.1, n)
        means[:, 2] = np.linspace(2.0, 6.0, n)
        quats = np.tile([1.0, 0.0, 0.0, 0.0], (n, 1))
        scales = np.full((n, 3), 1.0)
        opac = np.full((n,), 0.95)
        focal = 50.0
    else:  # mid-size scene
        n, width, height = 20_000, 640, 480
        tile = tile or 32
        cap = 1 << 18 if tile == 32 else 1 << 20  # a smaller tile makes more pairs
        means = np.stack(
            [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 9, n)], -1
        )
        quats = rng.normal(size=(n, 4))
        scales = np.exp(rng.uniform(np.log(0.01), np.log(0.08), (n, 3)))
        opac = rng.uniform(0.2, 0.95, n)
        focal = 0.9 * width
    colors = rng.uniform(0, 1, (n, 3))
    K = np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]])
    T = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    proj = project_gaussians(
        T(means), T(quats), T(scales), T(opac), torch.eye(4, device=dev)[None], T(K)[None],
        width, height,
    )
    b = bin_gaussians(
        proj.means2d, proj.radii, proj.depths, width, height, tile, cap, chunk=128,
        extents=proj.extents,
    )
    if int(b.overflow):
        raise RuntimeError(f"{kind}: pair capacity {cap} overflowed by {int(b.overflow)}")
    table = pack_table(proj.means2d, proj.conics, proj.opacities, T(colors)[None], proj.depths)
    num_tiles = b.num_tiles_x * b.num_tiles_y
    g = rng.normal(size=(num_tiles, 8, tile * tile)).astype(np.float32)
    g[:, 6:] = 0.0  # bookkeeping rows carry no gradient
    args = (table, b.gid_sorted, b.tile_starts, num_tiles, b.num_tiles_x, b.num_tiles_y, tile, 128)
    return args, T(g)


def check_kernels(tag, fwd_args, g_out, want_absgrad=True):
    """Each kernel against its plain version on the same inputs (the
    backward of both on the kernel's forward output, so both replay the
    same chunks), and the pair bounds against the composited pair-pixels.
    Returns (forward max abs error, backward max abs error, work(...))."""
    import torch
    from gs_init_tpu_torch.ops import rasterize as prast

    table, gid, starts, num_tiles, ntx, nty, tile, chunk = fwd_args
    out_k = prast.composite_fwd(*fwd_args)
    out_p = prast.composite_fwd_plain(*fwd_args)
    torch.cuda.synchronize()
    if not (torch.isfinite(out_k).all() and torch.isfinite(out_p).all()):
        raise RuntimeError(f"{tag}: non-finite forward output")
    row_err = (out_k[:, :6] - out_p[:, :6]).abs().amax(dim=(0, 2))
    fwd_err = float(row_err.max())
    unit_err = float(row_err[[0, 1, 2, 3, 5]].max())
    depth_rel = float(row_err[4] / out_p[:, 4].abs().max().clamp(min=1.0))
    nproc_k, nproc_p = out_k[:, 6, 0], out_p[:, 6, 0]
    bargs = (table, gid, starts, out_k, g_out, num_tiles, ntx, nty, tile, chunk, want_absgrad)
    dk, ak = prast.composite_bwd(*bargs)
    dp, ap = prast.composite_bwd_plain(*bargs)
    torch.cuda.synchronize()
    got = torch.cat([dk[:, :10], ak], 1)
    want = torch.cat([dp[:, :10], ap], 1)
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError(f"{tag}: non-finite gradients")
    diff = (got - want).abs().amax(0)
    scale = want.abs().amax(0).clamp(min=1e-30)
    bwd_rel = float((diff / scale).max())
    bwd_err = float(diff.max())
    _, _, _, nchunks = prast._chunk_windows(starts, chunk)
    early = int((nproc_k.long() < nchunks).sum())
    wk = work(fwd_args, out_k)
    log(f"  {tag}: {num_tiles} tiles, {int(starts[-1])} pairs, {early} tiles stopped early; "
        f"{wk['composited']} composited pair-pixels, {wk['outside']} outside the pair bounds (must be 0); "
        f"fwd rows 0-5 max abs err by row {[float(f'{e:.3e}') for e in row_err.tolist()]}, "
        f"rows 0-3, 5 {unit_err:.3e} (tol {FWD_ATOL:g} abs), depth err / max(1, row max) "
        f"{depth_rel:.3e} (tol {DEPTH_RTOL:g}), row 6 equal {bool(torch.equal(nproc_k, nproc_p))}; "
        f"bwd max abs err {bwd_err:.3e}, max err / column max {bwd_rel:.3e} (tol {BWD_RTOL:g})")
    if unit_err > FWD_ATOL or depth_rel > DEPTH_RTOL or not torch.equal(out_k[:, 6], out_p[:, 6]):
        raise RuntimeError(f"{tag}: forward kernel disagrees with its plain version")
    if bwd_rel > BWD_RTOL:
        raise RuntimeError(f"{tag}: backward kernel disagrees with its plain version")
    if wk["outside"]:
        raise RuntimeError(f"{tag}: {wk['outside']} composited pair-pixels lie outside the pair bounds")
    return fwd_err, bwd_err, wk


def check_scan_kernel(dev):
    """The scan probe kernel against its plain version on the probe's
    [128, 128] inputs, the shapes the main path gives it. Returns the max
    abs error over both outputs."""
    import torch
    from gs_init_tpu_torch.ops import rasterize as prast

    x, m = prast.scan_probe_inputs(dev)
    s, q = prast.scan_probe(x, m)
    ws, wq = prast.scan_probe_plain(x, m)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(a).all()) for a in (s, q, ws, wq)):
        raise RuntimeError("scan probe: non-finite output")
    sum_err, prod_err = float((s - ws).abs().max()), float((q - wq).abs().max())
    sum_rel = sum_err / float(ws.abs().max().clamp(min=1e-30))
    prod_rel = float(((q - wq).abs() / wq.abs().clamp(min=1e-30)).max())
    log(f"  scan probe {tuple(x.shape)} x2: sum max abs err {sum_err:.3e}, / max |sum| "
        f"{sum_rel:.3e}; product max abs err {prod_err:.3e}, max rel err {prod_rel:.3e} "
        f"(tol {SCAN_RTOL:g})")
    if sum_rel > SCAN_RTOL or prod_rel > SCAN_RTOL:
        raise RuntimeError("scan probe: kernel disagrees with its plain version")
    return max(sum_err, prod_err)


def step_card_vs_cpu(dev, aux_groups=False):
    """One train step of a small scene on the card and on the CPU from the
    same state: same loss, Adam moments and densification statistics; with
    `aux_groups`, pose, appearance and bilateral-grid optimisation on and
    the aux groups' Adam moments too."""
    import torch
    from gs_init_tpu_torch.config import Config
    from gs_init_tpu_torch.datasets.synthetic import look_at
    from gs_init_tpu_torch.device import generator
    from gs_init_tpu_torch.engine import optim
    from gs_init_tpu_torch.engine.appearance import init_appearance_params
    from gs_init_tpu_torch.engine.params import (
        PARAM_NAMES, AuxParams, aux_from_numpy, aux_leaves, init_from_points, state_from_numpy,
    )
    from gs_init_tpu_torch.engine.strategy import default as dstrat
    from gs_init_tpu_torch.engine.train_step import Batch, init_aux_opt, make_train_step

    width, height, n, cap = 160, 120, 1500, 2048
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    rgbs = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    g0 = init_from_points(torch.as_tensor(pts), torch.as_tensor(rgbs), cap, 3)
    leaves = {k: getattr(g0.params, k).numpy().copy() for k in PARAM_NAMES}
    leaves["scales"] += rng.normal(0, 0.3, leaves["scales"].shape).astype(np.float32)
    leaves["shN"] = (rng.normal(size=leaves["shN"].shape) * 0.1).astype(np.float32)
    alive = g0.alive.numpy()
    cfg = Config(sh_degree=3, sh_degree_interval=1, max_gaussians=cap, pair_capacity=1 << 16,
                 tile_size=16, chunk_size=128, max_steps=100)
    aux_np = dict(pose=None, app=None, grids=None)
    if aux_groups:
        cfg.pose_opt = cfg.app_opt = cfg.use_bilateral_grid = True
        cfg.pose_opt_lr = 1e-3
        app = init_appearance_params(generator(1), 2, cap, sh_degree=3)
        aux_np = dict(
            pose=(rng.normal(size=(2, 9)) * 0.01).astype(np.float32),
            app={k: v.numpy() for k, v in vars(app).items()},
            grids=np.tile(np.eye(3, 4, dtype=np.float32).reshape(12), (2, 8, 16, 16, 1))
            + rng.normal(0, 0.01, (2, 8, 16, 16, 12)).astype(np.float32),
        )
    acfg = optim.make_adam_config(cfg, 2.0)
    c2w = look_at(np.array([0.0, 0.0, -4.0]), np.zeros(3)).astype(np.float32)
    f = 0.9 * width
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32)
    target = rng.uniform(0, 1, (1, height, width, 3)).astype(np.float32)
    res = []
    for d in (torch.device("cpu"), dev):
        T = lambda x: torch.as_tensor(x, device=d)
        g = state_from_numpy(leaves, alive, d)
        a = optim.init_adam_state(g.params)
        s = dstrat.init_state(cap, d)
        batch = Batch(camtoworlds=T(c2w)[None], Ks=T(K)[None], pixels=T(target),
                      image_ids=torch.ones((1,), dtype=torch.long, device=d))
        aux = aux_from_numpy(device=d, **aux_np)
        g, a, s, aux, aux_opt, m = make_train_step(cfg, acfg, width, height)(
            g, a, s, aux, init_aux_opt(aux), batch, 0
        )
        mu = [] if not aux_groups else aux_leaves(AuxParams(
            pose=aux_opt.pose.mu, app=aux_opt.app.mu, grids=aux_opt.grids.mu))
        res.append((float(m["loss"]), int(m["pairs"]), a, s, mu))
    (lc, pc, ac, sc, xc), (lg, pg, ag, sg, xg) = res
    worst = 0.0
    for k in PARAM_NAMES:
        want, got = getattr(ac.mu, k), getattr(ag.mu, k).cpu()
        worst = max(worst, float((got - want).abs().max() / want.abs().max().clamp(min=1e-30)))
    aux_err = [float((y.cpu() - x).abs().max() / x.abs().max().clamp(min=1e-30)) for x, y in zip(xc, xg)]
    gw, gg = sc.grad2d, sg.grad2d.cpu()
    g_err = float((gg - gw).abs().max() / gw.abs().max().clamp(min=1e-30))
    # A radius is a ceil of a float that the two math libraries may round
    # apart: allow one pixel, and a few gaussians whose visibility flips.
    seen_diff = int((sc.count != sg.count.cpu()).sum())
    r_diff = float((sc.radii_max - sg.radii_max.cpu()).abs().max()) * max(width, height)
    tag = " with pose, appearance and bilateral grid" if aux_groups else ""
    log(f"  train step{tag} card vs CPU ({width}x{height}, {n} gaussians, {pg} vs {pc} pairs): loss "
        f"{lg:.7f} vs {lc:.7f}; Adam mu max err / leaf max {worst:.3e}, grad2d {g_err:.3e} "
        f"(tol {STEP_RTOL:g}); visibility differs for {seen_diff}, max radius by {r_diff:.3f} px"
        + (f"; aux Adam mu max err / leaf max (pose, app x8, grids) "
           f"{[float(f'{e:.3e}') for e in aux_err]} (tol {AUX_RTOL:g})" if aux_groups else ""))
    if (abs(pg - pc) > 1e-3 * pc or abs(lg - lc) > 1e-4 * abs(lc) or worst > STEP_RTOL
            or g_err > STEP_RTOL or seen_diff > 2 or r_diff > 1.001 or max(aux_err, default=0) > AUX_RTOL):
        raise RuntimeError(f"the train step{tag} on the card disagrees with the same step on the CPU")


def mcmc_card_vs_cpu(dev, cap=8192, n=6000):
    """mcmc.refine and add_noise on the card and on the CPU with the same
    targets and normals: the same alive set and receivers (the slots whose
    moments were zeroed), parameters within MCMC_RTOL of each leaf's max,
    zeroed moments exactly zero. Then the card's own draws: every target a
    live slot, and slot 0 everywhere when none is live."""
    import torch
    from gs_init_tpu_torch.config import MCMCStrategyConfig
    from gs_init_tpu_torch.device import generator
    from gs_init_tpu_torch.engine import optim
    from gs_init_tpu_torch.engine.params import PARAM_NAMES, init_from_points, state_from_numpy
    from gs_init_tpu_torch.engine.strategy import default as dstrat
    from gs_init_tpu_torch.engine.strategy import mcmc

    rng = np.random.default_rng(4)
    pts = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    g0 = init_from_points(torch.as_tensor(pts), torch.as_tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
                          cap, 3)
    leaves = {k: getattr(g0.params, k).numpy().copy() for k in PARAM_NAMES}
    leaves["opacities"] = rng.normal(-2.0, 3.0, cap).astype(np.float32)  # some below min_opacity
    leaves["scales"] += rng.normal(0, 0.3, leaves["scales"].shape).astype(np.float32)
    moments = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in leaves.items()}
    alive = g0.alive.numpy()
    cfg = MCMCStrategyConfig(cap_max=7000)
    g = state_from_numpy(leaves, alive, "cpu")
    opa, _, live = mcmc.live_mask(g, cfg)
    targets = mcmc.draw_targets(opa, live, generator(5))
    eps = mcmc.noise_eps(cap, generator(6))
    res = []
    for d in (torch.device("cpu"), dev):
        g = state_from_numpy(leaves, alive, d)
        a = optim.adam_from_numpy(moments, {k: np.abs(v) for k, v in moments.items()}, 3, d)
        g, a, _ = mcmc.refine(g, a, dstrat.init_state(cap, d), targets.to(d), cfg)
        g = mcmc.add_noise(g, eps.to(d), 1.6e-4, cfg)
        res.append((g, a))
    (gc, ac), (gg, ag) = res
    zeroed_c = ac.mu.opacities == 0
    zeroed_g = (ag.mu.opacities == 0).cpu()
    p_err = max(float((getattr(gg.params, k).cpu() - getattr(gc.params, k)).abs().max()
                      / getattr(gc.params, k).abs().max()) for k in PARAM_NAMES)
    zero_ok = all(bool((getattr(m, k)[zeroed_g.to(dev)] == 0).all()) for m in (ag.mu, ag.nu) for k in PARAM_NAMES)
    n0, n1 = int(alive.sum()), int(gg.alive.sum())
    log(f"  mcmc relocate + noise card vs CPU ({cap} slots, {n0} alive, {int((~live & g0.alive).sum())} dead): "
        f"alive {n0} -> {n1}, alive equal {bool(torch.equal(gc.alive, gg.alive.cpu()))}, receivers equal "
        f"{bool(torch.equal(zeroed_c, zeroed_g))} ({int(zeroed_g.sum())} zeroed); params max err / leaf max "
        f"{p_err:.3e} (tol {MCMC_RTOL:g}); zeroed moments exactly 0: {zero_ok}")
    if not (torch.equal(gc.alive, gg.alive.cpu()) and torch.equal(zeroed_c, zeroed_g) and zero_ok
            and p_err <= MCMC_RTOL and n1 == min(cfg.cap_max, int(np.float32(n0) * np.float32(1.05)))):
        raise RuntimeError("mcmc relocation or noise on the card disagrees with the CPU")
    g = state_from_numpy(leaves, alive, dev)
    opa, _, live = mcmc.live_mask(g, cfg)
    t_card = mcmc.draw_targets(opa, live, generator(7, dev))
    t_none = mcmc.draw_targets(opa, torch.zeros_like(live), generator(7, dev))
    if not (bool(live[t_card].all()) and bool((t_none == 0).all())):
        raise RuntimeError("mcmc.draw_targets on the card drew a slot that is not live")


def color_correct_card_vs_cpu(dev, width=648, height=420):
    """color_correct on the card against the CPU, on a natural image (a
    smooth field under a colour warp) and on a constant one (rank 1: the
    minimum-norm fit gives each channel its reference mean)."""
    import torch
    from gs_init_tpu_torch.engine.appearance import color_correct

    rng = np.random.default_rng(8)
    ys, xs = np.mgrid[0:height, 0:width] / max(width, height)
    ref = np.stack([0.5 + 0.4 * np.sin(3 * xs + 1), 0.5 + 0.4 * np.cos(2 * ys), 0.5 + 0.3 * np.sin(xs + ys)], -1)
    ref = np.clip(ref + rng.normal(0, 0.02, ref.shape), 0, 1).astype(np.float32)
    natural = np.clip(0.8 * ref ** 1.3 + 0.05, 0, 1).astype(np.float32)
    flat = np.full_like(ref, 0.4)
    errs = []
    for name, img in (("natural", natural), ("constant", flat)):
        c = color_correct(torch.as_tensor(img), torch.as_tensor(ref))
        g = color_correct(torch.as_tensor(img, device=dev), torch.as_tensor(ref, device=dev)).cpu()
        errs.append(float((g - c).abs().max()))
        if not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"color_correct: non-finite output on the {name} image")
    mean_err = float((g - torch.as_tensor(ref.reshape(-1, 3).mean(0))).abs().max())
    log(f"  color_correct {width}x{height} card vs CPU: max abs err natural {errs[0]:.3e}, constant "
        f"{errs[1]:.3e} (tol {CC_ATOL:g}); constant image vs the reference's channel means {mean_err:.3e}")
    if max(errs) > CC_ATOL or mean_err > CC_ATOL:
        raise RuntimeError("color_correct on the card disagrees with the CPU")


def oracle_vs_compositor(dev, n=2000, width=160, height=120, tile=16):
    """render(impl="xla") against impl="pallas" on the card: a sparse scene
    (opacity 0.05-0.5) where no tile stops early, values and gradients."""
    import torch
    from gs_init_tpu_torch import kernels
    from gs_init_tpu_torch.ops.render import rasterize

    rng = np.random.default_rng(5)
    means = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 9, n)], -1)
    f = 0.9 * width
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]])
    T = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    inputs = (
        means, rng.normal(size=(n, 4)), np.exp(rng.uniform(np.log(0.01), np.log(0.05), (n, 3))),
        rng.uniform(0.05, 0.5, n), rng.uniform(0, 1, (n, 3)),
    )
    target = T(rng.uniform(0, 1, (1, height, width, 3)))
    out = {}
    launches0 = dict(kernels.LAUNCHES)
    for impl in ("xla", "pallas"):
        leaves = [T(x).requires_grad_(True) for x in inputs]
        render, alpha, info = rasterize(
            *leaves, torch.eye(4, device=dev)[None], T(K)[None], width, height, tile_size=tile,
            pair_capacity=1 << 18, render_mode="RGB+ED", impl=impl,
        )
        loss = ((render[..., :3] - target) ** 2).mean() + alpha.mean()
        grads = torch.autograd.grad(loss, leaves)
        out[impl] = (render.detach(), alpha.detach(), grads, int(info.overflow))
    torch.cuda.synchronize()
    (r0, a0, g0, _), (r1, a1, g1, ov) = out["xla"], out["pallas"]
    if ov:
        raise RuntimeError(f"oracle check: the pair table overflowed by {ov}")
    launched = {k: kernels.LAUNCHES[k] - launches0[k] for k in ("composite_fwd", "composite_bwd")}
    if launched != {"composite_fwd": 1, "composite_bwd": 1}:
        raise RuntimeError(f"oracle check: the compositor launched {launched}, not once each")
    fwd_err = max(float((r0[..., :3] - r1[..., :3]).abs().max()), float((a0 - a1).abs().max()))
    names = ("means", "quats", "scales", "opacities", "colors")
    rel = {k: float((x - y).abs().max() / y.abs().max().clamp(min=1e-30)) for k, x, y in zip(names, g0, g1)}
    log(f"  dense oracle vs tile compositor ({n} gaussians, {width}x{height}, tile {tile}; max alpha "
        f"{float(a1.max()):.3f}): colour and alpha max abs err {fwd_err:.3e} (tol {ORACLE_ATOL:g}); "
        f"gradient err / leaf max {json.dumps({k: float(f'{v:.3e}') for k, v in rel.items()})} "
        f"(tol {ORACLE_GRAD_RTOL:g})")
    if not (torch.isfinite(r0).all() and all(bool(torch.isfinite(g).all()) for g in g0)):
        raise RuntimeError("oracle check: non-finite oracle output")
    if fwd_err > ORACLE_ATOL or max(rel.values()) > ORACLE_GRAD_RTOL:
        raise RuntimeError("the dense oracle disagrees with the tile compositor on the card")


def plane_view(width=1296, height=840, m=300, seed=0):
    """A slanted plane with a step, seen by one camera; SfM points on it
    (some out of frame, the rest of the padding invalid) and the stub's
    noise-free prediction 0.37 depth + 1.3."""
    rng = np.random.default_rng(seed)
    f = 0.85 * width
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1, -0.2, 0.3]
    ys, xs = np.mgrid[0:height, 0:width] + 0.5
    true = 2.0 + 2.0 * xs / width + 3.0 * ys / height
    true[:, width * 2 // 3:] += 2.0
    true = true.astype(np.float32)
    px, py = rng.uniform(-20, width + 20, m), rng.uniform(0, height, m)
    z = true[np.clip(py.astype(int), 0, height - 1), np.clip(px.astype(int), 0, width - 1)]
    cam = np.stack([(px - K[0, 2]) / f * z, (py - K[1, 2]) / f * z, z], -1)
    sfm = np.zeros((m + 20, 3), np.float32)
    sfm[:m] = cam + c2w[:3, 3]
    valid = np.arange(m + 20) < m
    pred = (0.37 * true + 1.3).astype(np.float32)
    return pred, np.ones(pred.shape, bool), c2w, K, sfm, valid


def points_from_depth_card_vs_cpu(dev):
    """One points_from_depth (RANSAC, 2,500 hypotheses) on the card and on
    the CPU with the same hypotheses: (s, t) and the masks."""
    import torch
    from gs_init_tpu_torch.device import generator
    from gs_init_tpu_torch.mdi.alignment.ransac import sample_hypotheses
    from gs_init_tpu_torch.mdi.points_from_depth import points_from_depth

    pred, pmask, c2w, K, sfm, valid = plane_view()
    h, w = pred.shape
    kw = dict(width=w, height=h, align_method="ransac", ransac_iters=2500, use_grad_mask=True,
              use_sfm_density_mask=True)
    idx = sample_hypotheses(torch.as_tensor(valid), 2500, 4, generator(0))
    res = []
    for d in (torch.device("cpu"), dev):
        T = lambda x: torch.as_tensor(x, device=d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = points_from_depth(T(pred), T(pmask), T(c2w), T(K), T(sfm), T(valid), idx.to(d), **kw)
        res.append((float(out.scale), float(out.shift), out.mask.cpu(), time.perf_counter() - t0))
    drawn = points_from_depth(
        *(torch.as_tensor(x, device=dev) for x in (pred, pmask, c2w, K, sfm, valid)),
        generator=generator(0, dev), **kw,
    )
    (sc, tc, mc, secs_c), (sg, tg, mg, secs_g) = res
    s_rel = abs(sg - sc) / abs(sc)
    t_rel = abs(tg - tc) / abs(tc)
    log(f"  points_from_depth {w}x{h}, RANSAC 2500 hypotheses: card (s, t) = ({sg:.7f}, {tg:.7f}), "
        f"CPU ({sc:.7f}, {tc:.7f}), rel err {s_rel:.3e}, {t_rel:.3e} (tol {PFD_RTOL:g}); masks equal "
        f"{bool(torch.equal(mc, mg))} ({int(mg.sum())} points); the card's own draws s = "
        f"{float(drawn.scale):.7f} (1/0.37 = {1 / 0.37:.7f}); {secs_g * 1e3:.3f} ms on the card "
        f"(first call), {secs_c * 1e3:.3f} ms on the CPU")
    if s_rel > PFD_RTOL or t_rel > PFD_RTOL or not torch.equal(mc, mg):
        raise RuntimeError("points_from_depth on the card disagrees with the CPU")
    if abs(float(drawn.scale) * 0.37 - 1.0) > 1e-3:
        raise RuntimeError("points_from_depth with the card's own draws missed the stub's scale")


# ------------------------------------------------------------------ phase 3


def flagship_setup(dev, n=300_000, cap=393_216, width=1296, height=840, variant="default"):
    """bench.py's scenario: a uniform random cloud in a box, kNN scale init,
    one camera, a random target image. `variant` "mcmc" takes the mcmc
    preset's init opacity and scale and regularisers with a relocation every
    10 steps from step 0; "aux" turns on pose, appearance and bilateral-grid
    optimisation."""
    import torch
    from gs_init_tpu_torch.config import Config, MCMCStrategyConfig
    from gs_init_tpu_torch.datasets.synthetic import look_at
    from gs_init_tpu_torch.device import generator
    from gs_init_tpu_torch.engine import optim
    from gs_init_tpu_torch.engine.appearance import (
        init_appearance_params, init_bilateral_grids, init_pose_params,
    )
    from gs_init_tpu_torch.engine.params import AuxParams, init_from_points
    from gs_init_tpu_torch.engine.runner import snug_pair_capacity
    from gs_init_tpu_torch.engine.strategy import default as dstrat
    from gs_init_tpu_torch.engine.train_step import Batch, init_aux_opt, make_train_step
    from gs_init_tpu_torch.trainer import build_presets

    rng = np.random.default_rng(0)
    pts = np.stack(
        [rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(-1, 6, n)], -1
    ).astype(np.float32)
    rgbs = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    cfg = build_presets()["mcmc" if variant == "mcmc" else "default"]
    cfg.max_steps, cfg.max_gaussians, cfg.pair_capacity = 30_000, cap, 1 << 21
    if variant == "mcmc":
        cfg.strategy = MCMCStrategyConfig(refine_start_iter=0, refine_every=10)
    aux = AuxParams()
    if variant == "aux":
        cfg.pose_opt = cfg.app_opt = cfg.use_bilateral_grid = True
        aux = AuxParams(
            pose=init_pose_params(1, device=dev),
            app=init_appearance_params(generator(1, dev), 1, cap, sh_degree=cfg.sh_degree, device=dev),
            grids=init_bilateral_grids(1, cfg.bilateral_grid_shape, device=dev),
        )
    t0 = time.perf_counter()
    gstate = init_from_points(torch.as_tensor(pts, device=dev), torch.as_tensor(rgbs, device=dev),
                              cap, cfg.sh_degree, init_opacity=cfg.init_opa, init_scale=cfg.init_scale,
                              generator=generator(0, dev))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    acfg = optim.make_adam_config(cfg, scene_scale=4.0)
    c2w = look_at(np.array([0.0, 0.0, -8.0]), np.zeros(3)).astype(np.float32)
    f = 0.85 * width
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32)
    target = rng.uniform(0, 1, (1, height, width, 3)).astype(np.float32)
    T = lambda x: torch.as_tensor(x, device=dev)
    ctx = dict(
        cfg=cfg, acfg=acfg, gstate=gstate, adam=optim.init_adam_state(gstate.params),
        sstate=dstrat.init_state(cap, dev), aux=aux, aux_opt=init_aux_opt(aux),
        batch=Batch(camtoworlds=T(c2w)[None], Ks=T(K)[None], pixels=T(target),
                    image_ids=torch.zeros((1,), dtype=torch.long, device=dev)),
        make_step=lambda: make_train_step(cfg, acfg, width, height), step=0,
        gen=generator(cfg.seed, dev), alive_after_relocation=[],
    )
    ctx["step_fn"] = ctx["make_step"]()
    # Size the pair table from one step by the Runner's rule; under MCMC the
    # demand grows by the two 5% tranches of alive gaussians in the timed run.
    m = run_step(ctx)
    pairs, overflow = int(m["pairs"]), int(m["overflow"])
    growth = 1.05 ** 2 if variant == "mcmc" else 1.0
    cfg.pair_capacity = snug_pair_capacity(int((pairs + overflow) * growth))
    log(f"  flagship set-up ({variant}): {n} gaussians (capacity {cap}) at {width}x{height}, init "
        f"opacity {cfg.init_opa}, scale {cfg.init_scale}, kNN init {init_s:.3f} s; first step {pairs} "
        f"pairs + {overflow} overflow -> pair capacity {cfg.pair_capacity}")
    return ctx


def run_step(ctx, mark=None):
    """One train step; under the MCMC strategy followed, as in
    Runner.train_iteration, by a relocation on its steps and the noise."""
    from gs_init_tpu_torch.config import MCMCStrategyConfig
    from gs_init_tpu_torch.engine.strategy import mcmc

    mark = mark or (lambda name: None)
    step, s = ctx["step"], ctx["cfg"].strategy
    ctx["gstate"], ctx["adam"], ctx["sstate"], ctx["aux"], ctx["aux_opt"], m = ctx["step_fn"](
        ctx["gstate"], ctx["adam"], ctx["sstate"], ctx["aux"], ctx["aux_opt"], ctx["batch"], step,
        mark=mark,
    )
    if isinstance(s, MCMCStrategyConfig):
        if s.refine_start_iter < step < s.refine_stop_iter and step % s.refine_every == 0:
            n_before = ctx["gstate"].alive.sum()
            ctx["gstate"], ctx["adam"], ctx["sstate"] = mcmc.relocate(
                ctx["gstate"], ctx["adam"], ctx["sstate"], ctx["gen"], s
            )
            mark("relocate")
            ctx["alive_after_relocation"].append((step, n_before, ctx["gstate"].alive.sum()))
        acfg = ctx["acfg"]
        lr = float(acfg.lrs["means"] * acfg.means_decay_gamma**step)
        ctx["gstate"] = mcmc.add_noise(ctx["gstate"], mcmc.noise_eps(ctx["cfg"].max_gaussians, ctx["gen"]), lr, s)
        mark("noise")
    ctx["step"] += 1
    return m


def main_path(ctx, warm=3, timed=20, tag="main path"):
    """The counted run: launch counts from 0, warm-up, timed steps."""
    import torch
    from gs_init_tpu_torch import kernels

    kernels.reset_launch_counts()
    # The path's own peak, without the set-up step's oversized pair table.
    torch.cuda.reset_peak_memory_stats()
    # A fresh step function: its first call runs the scan probe, as the
    # Runner's does.
    ctx["step_fn"] = ctx["make_step"]()
    for _ in range(warm):
        run_step(ctx)
    torch.cuda.synchronize()
    records = []
    t0 = time.perf_counter()
    for _ in range(timed):
        ev = {}

        def mark(name, ev=ev):
            ev[name] = torch.cuda.Event(enable_timing=True)
            ev[name].record()

        mark("start")
        m = run_step(ctx, mark)
        mark("end")
        records.append((ev, m))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    steps = warm + timed
    want = dict(composite_fwd=steps, composite_bwd=steps, scan_probe=1)
    for name in KERNELS:
        if launches.get(name, 0) != want[name]:
            raise RuntimeError(f"{tag}: {name} launched {launches.get(name, 0)} times in {steps} steps, "
                               f"not {want[name]}")
    losses = torch.stack([m["loss"] for _, m in records])
    if not bool(torch.isfinite(losses).all()):
        raise RuntimeError(f"non-finite loss on the {tag}")
    overflow = max(int(m["overflow"]) for _, m in records)
    if overflow:
        raise RuntimeError(f"pair table overflowed by {overflow} on the {tag}")
    step_ms = np.array([ev["start"].elapsed_time(ev["end"]) for ev, _ in records])
    # Each phase's mean over the steps that ran it (the relocation runs on
    # every refine_every-th step only).
    phase = {}
    for ev, _ in records:
        names = list(ev)
        for a, b in zip(names, names[1:]):
            phase.setdefault(b, []).append(ev[a].elapsed_time(ev[b]))
    phase_ms = {k: float(np.mean(v)) for k, v in phase.items()}
    log(f"  {tag}: {steps} steps, launches {json.dumps(launches)}")
    log(f"  step wall time (CUDA events, {timed} steps after {warm} warm-up): median "
        f"{np.median(step_ms):.3f} ms, min {step_ms.min():.3f}, max {step_ms.max():.3f}; "
        f"host clock {wall / timed * 1e3:.3f} ms/step = {timed / wall:.3f} steps/s")
    log(f"  phases (mean ms over the steps that ran each; 'end' = after the last): "
        f"{json.dumps({k: round(v, 4) for k, v in phase_ms.items()})} "
        f"(runs: {json.dumps({k: len(v) for k, v in phase.items()})})")
    log(f"  loss {float(losses[0]):.6f} -> {float(losses[-1]):.6f}; pairs {int(records[-1][1]['pairs'])}, "
        f"overflow 0; peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return launches, step_ms, phase_ms


def mcmc_flagship(dev):
    """Phase 3b: the flagship under the mcmc preset, a relocation every 10
    steps; the alive count after each relocation must be the 5% tranche,
    never above min(cap_max, capacity)."""
    ctx = flagship_setup(dev, variant="mcmc")
    _, step_ms, _ = main_path(ctx, tag="mcmc flagship")
    profile_window(ctx, float(np.median(step_ms)))
    s, cap = ctx["cfg"].strategy, ctx["cfg"].max_gaussians
    rel = [(st, int(a), int(b)) for st, a, b in ctx["alive_after_relocation"]]
    log(f"  relocations (step, alive before, after): {rel}; cap_max {s.cap_max}, capacity {cap}")
    for st, a, b in rel:
        want = min(s.cap_max, cap, int(np.float32(a) * np.float32(1.05)))
        if b != want:
            raise RuntimeError(f"relocation at step {st}: {a} -> {b} alive, not the 5% tranche {want}")
    if sum(1 for st, _, _ in rel if st >= 4) != 2:
        raise RuntimeError(f"expected 2 relocations in the timed steps, got {rel}")


def aux_flagship(dev):
    """Phase 3c: the flagship with pose, appearance and bilateral-grid
    optimisation on."""
    ctx = flagship_setup(dev, variant="aux")
    _, step_ms, _ = main_path(ctx, tag="aux flagship")
    profile_window(ctx, float(np.median(step_ms)))


def profile_window(ctx, step_ms, nsteps=3):
    """Device time by kernel over a few steps (torch.profiler), and the
    device's idle share: 1 - busy time / the unprofiled median step time
    (the profiler slows the host, so its own window overstates idleness)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(nsteps):
            run_step(ctx)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((us / nsteps, evt.count // nsteps, evt.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) * nsteps
    if busy <= 0:  # a measurement gap, not a fault of the path
        log("  profiler saw no device time here; the CUDA-event phase times above stand")
        return
    busy_ms = busy / 1e3 / nsteps
    log(f"  profiler ({nsteps} steps): device busy {busy_ms:.3f} ms/step; idle share "
        f"{max(0.0, 1 - busy_ms / step_ms):.3f} of the unprofiled {step_ms:.3f} ms step "
        f"({max(0.0, 1 - busy / wall_us):.3f} of the profiled {wall_us / 1e3 / nsteps:.3f} ms); "
        f"top kernels by device time:")
    for us, cnt, key in rows[:12]:
        log(f"    {us / 1e3:9.3f} ms/step  x{cnt:<3d} {key[:110]}")


# ------------------------------------------------------------------ phase 4


def capture_inputs(ctx):
    """Run one more step with recording wrappers around the compositor
    calls; returns the forward and backward arguments it used."""
    from gs_init_tpu_torch.ops import rasterize as prast

    seen = {}
    fwd, bwd = prast.composite_fwd, prast.composite_bwd

    detach = lambda args: tuple(a.detach() if hasattr(a, "detach") else a for a in args)

    # Without the tile order that the autograd op passes: the wrappers
    # compute the same one when none is given.
    def rec_fwd(*args):
        seen["fwd"] = detach(args[:8])
        return fwd(*args)

    def rec_bwd(*args):
        seen["bwd"] = detach(args[:11])
        return bwd(*args)

    prast.composite_fwd, prast.composite_bwd = rec_fwd, rec_bwd
    try:
        run_step(ctx)
    finally:
        prast.composite_fwd, prast.composite_bwd = fwd, bwd
    return seen["fwd"], seen["bwd"]


def work(fwd_args, out):
    """Pair-pixels of the processed chunks: in range (in-range pairs, every
    pixel of their tile), evaluated (those inside the pair's bounding box
    from ops/rasterize.pair_bounds, clipped to the tile: a pixel outside it
    needs no per-pixel arithmetic), within the cut (inside the box with
    sigma <= s_cut: these go on to exp), composited (alpha >= 1/255),
    unclamped composited, and composited ones outside the pair bounds (must
    be 0); plus the gaussian rows read."""
    import torch
    from gs_init_tpu_torch.ops import rasterize as prast

    table, gid, starts, num_tiles, ntx, nty, tile, chunk = fwd_args
    s, e, c0, _ = prast._chunk_windows(starts, chunk)
    nproc = out[:, prast.ROW_NPROC, 0].long()
    w = dict(in_range=0, evaluated=0, within_cut=0, composited=0, unclamped=0, outside=0)
    used = torch.zeros(table.shape[0], dtype=torch.bool, device=table.device)

    def span(centre, half):  # pixel centres c + 0.5 of [0, tile) with |c - centre| <= half
        lo = torch.ceil(centre - half).clamp(0, tile)
        hi = torch.floor(centre + half).clamp(-1, tile - 1)
        n = (hi - lo + 1).clamp(min=0)
        return torch.where(torch.isinf(half) & (half > 0), float(tile), n.nan_to_num(0.0))

    for i in range(int(nproc.max())):
        live = torch.nonzero(i < nproc).flatten()
        rows, inr, g = prast._gather_chunk(table, gid, s[live], e[live], c0[live], i, chunk)
        px, py = prast._pixel_coords(live, tile, ntx, nty)
        alpha, aux = prast._alpha_terms(rows, inr, px, py)
        s_cut, hx, hy = prast.pair_bounds(rows)
        mx, my = rows[:, :, 0:1].double(), rows[:, :, 1:2].double()
        dx, dy = aux["dx"], aux["dy"]
        sigma = aux["ca"] * dx * dx + aux["cc"] * dy * dy + aux["cb"] * dx * dy
        inside = (
            (sigma <= s_cut[..., None])
            & ((px.double() - mx).abs() <= hx[..., None])
            & ((py.double() - my).abs() <= hy[..., None])
        )
        ok = alpha > 0
        ox = px[:, :, 0:1].double() - 0.5  # tile origin: pixel 0 is its top-left corner
        oy = py[:, :, 0:1].double() - 0.5
        box = span(mx[..., 0] - ox[..., 0] - 0.5, hx) * span(my[..., 0] - oy[..., 0] - 0.5, hy)
        w["in_range"] += int(inr.sum()) * tile * tile
        w["evaluated"] += int(box[inr].sum())
        w["within_cut"] += int((inside & inr[..., None]).sum())
        w["composited"] += int(ok.sum())
        w["unclamped"] += int(aux["unclamped"].sum())
        w["outside"] += int((ok & ~inside).sum())
        used[g[inr]] = True
    w["rows_used"] = int(used.sum())
    return w


# An empty kernel with the scan probe's signature, grid and block, launched
# through ctypes the same way: its time is the floor under any launch.
EMPTY_SRC = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel(const float*, const float*, float*, float*, int, int) {}
extern "C" int empty_launch(const void* x, const void* m, void* s, void* q, int n, int p,
                            void* stream) {
  empty_kernel<<<p, (n + 31) / 32 * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(m), static_cast<float*>(s),
      static_cast<float*>(q), n, p);
  return static_cast<int>(cudaGetLastError());
}
"""


def launch_floor(dev, launches=100):
    """The scan probe's device-only time (profiler) and CUDA-event time per
    launch, beside the same two for an empty kernel launched the same way."""
    import ctypes

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from gs_init_tpu_torch import kernels
    from gs_init_tpu_torch.ops import rasterize as prast

    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = os.path.join(tmp, "empty.cu"), os.path.join(tmp, "libempty.so")
        with open(src, "w") as f:
            f.write(EMPTY_SRC)
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib_path, src],
                       check=True, capture_output=True, timeout=300)
        lib = ctypes.CDLL(lib_path)
    fn = lib.empty_launch
    fn.argtypes = kernels.KERNELS["scan_probe"][1]
    fn.restype = ctypes.c_int
    x, m = prast.scan_probe_inputs(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def empty():
        s, q = torch.empty_like(x), torch.empty_like(m)
        if fn(x.data_ptr(), m.data_ptr(), s.data_ptr(), q.data_ptr(), x.shape[0], x.shape[1], stream):
            raise RuntimeError("the empty kernel failed to launch")

    probe = lambda: prast.scan_probe(x, m)
    res = {}
    for name, call, key in (("scan_probe", probe, "scan_probe_kernel"), ("empty", empty, "empty_kernel")):
        event_ms = cuda_ms(call, launches, warmup=3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                call()
            torch.cuda.synchronize()
        dev_us = [
            getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA and key in e.key
        ]
        res[name] = (event_ms, sum(dev_us) / launches / 1e3 if dev_us else float("nan"))
    log(f"  launch floor ({launches} launches each, ctypes, {x.shape[1]} blocks of {x.shape[0]} "
        f"threads): scan probe {res['scan_probe'][0]:.5f} ms by CUDA events, "
        f"{res['scan_probe'][1]:.5f} ms on the device (profiler); empty kernel "
        f"{res['empty'][0]:.5f} ms by CUDA events, {res['empty'][1]:.5f} ms on the device")
    return res


def kernel_report(ctx, launches, scan_err):
    from gs_init_tpu_torch.ops import rasterize as prast

    fargs, bargs = capture_inputs(ctx)
    log(f"  captured the flagship step's compositor inputs: table {tuple(fargs[0].shape)}, "
        f"{int(fargs[2][-1])} pairs, {fargs[3]} tiles of {fargs[6]}x{fargs[6]}")
    g_out = bargs[4]
    fwd_err, bwd_err, wk = check_kernels("flagship", fargs, g_out, want_absgrad=bargs[10])
    out = prast.composite_fwd(*fargs)
    _, _, _, nchunks = prast._chunk_windows(fargs[2], fargs[7])
    for name, c in (("in the tile's range", nchunks), ("processed (row 6)", out[:, prast.ROW_NPROC, 0])):
        c = c.double()
        log(f"  chunks per tile, {name}: min {int(c.min())}, median {float(c.median()):g}, "
            f"max {int(c.max())}, mean {float(c.mean()):.3f}")
    bk = (fargs[0], fargs[1], fargs[2], out, g_out) + fargs[3:] + (bargs[10],)

    t = {}
    for _ in range(2):  # plain, kernel, kernel, plain, as two rounds
        t.setdefault("fwd_plain", []).append(cuda_ms(lambda: prast.composite_fwd_plain(*fargs), 1))
        t.setdefault("fwd", []).append(cuda_ms(lambda: prast.composite_fwd(*fargs), 20))
        t.setdefault("bwd", []).append(cuda_ms(lambda: prast.composite_bwd(*bk), 20))
        t.setdefault("bwd_plain", []).append(cuda_ms(lambda: prast.composite_bwd_plain(*bk), 1))
    x, m = prast.scan_probe_inputs(fargs[0].device)
    for _ in range(2):
        t.setdefault("scan_plain", []).append(cuda_ms(lambda: prast.scan_probe_plain(x, m), 100))
        t.setdefault("scan", []).append(cuda_ms(lambda: prast.scan_probe(x, m), 100))
        t.setdefault("scan", []).append(cuda_ms(lambda: prast.scan_probe(x, m), 100))
        t.setdefault("scan_plain", []).append(cuda_ms(lambda: prast.scan_probe_plain(x, m), 100))
    t = {k: float(np.min(v)) for k, v in t.items()}

    evals, cut, comp, uncl = wk["evaluated"], wk["within_cut"], wk["composited"], wk["unclamped"]
    rows_used = wk["rows_used"]
    table, gid, starts, num_tiles = fargs[:4]
    pixels = fargs[6] ** 2
    pairs = int(starts[-1])
    # Inputs read once (the 48 bytes of each used table row that the
    # kernels load, the pair ids, the tile ranges), outputs written once;
    # the backward reads the forward's output and its cotangent and writes
    # dtable and absgrad.
    in_bytes = rows_used * 48 + pairs * 4 + (num_tiles + 1) * 4
    out_bytes = num_tiles * 8 * pixels * 4
    fwd_bytes = in_bytes + out_bytes
    bwd_bytes = in_bytes + 2 * out_bytes + table.shape[0] * (16 + 2) * 4
    eval_ops = evals * OPS_SIGMA + cut * OPS_ALPHA
    fwd_ops = eval_ops + comp * OPS_FWD_COMPOSITED
    bwd_ops = eval_ops + comp * OPS_BWD_COMPOSITED + uncl * OPS_BWD_UNCLAMPED
    log(f"  shared memory per block at chunk {fargs[7]}: forward {prast.FWD_SMEM_PER_PAIR * fargs[7]} B, "
        f"backward {prast.BWD_SMEM_PER_PAIR * fargs[7]} B")
    log(f"  work: {wk['in_range']} pair-pixels in range, {evals} evaluated (inside the pair bounds' box), "
        f"{cut} within the sigma cut, {comp} composited, {uncl} unclamped; {rows_used} gaussian rows read; "
        f"operations forward {fwd_ops}, backward {bwd_ops}")

    def entry(name, err, ms, plain_ms, nbytes, ops):
        tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_FLOPS * 1e3
        return dict(
            name=name, **KERNELS[name], launches=launches[name], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=max(tb, to), bound_by="bytes" if tb > to else "operations",
            library_ms=None,
        )

    rows = [
        entry("composite_fwd", fwd_err, t["fwd"], t["fwd_plain"], fwd_bytes, fwd_ops),
        entry("composite_bwd", bwd_err, t["bwd"], t["bwd_plain"], bwd_bytes, bwd_ops),
        # Two inputs read and two outputs written once; one add or one
        # multiply per element of each output.
        entry("scan_probe", scan_err, t["scan"], t["scan_plain"], 4 * x.numel() * 4, 2 * x.numel()),
    ]
    for r in rows:
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms), bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bound_ms'] / r['ms']:.3f} of the bound)")
    return rows


# ------------------------------------------------------------------ phase 5


def runner_e2e(steps=300, width=648, height=420):
    import torch
    from gs_init_tpu_torch import kernels
    from gs_init_tpu_torch.config import Config, DefaultStrategyConfig
    from gs_init_tpu_torch.datasets.synthetic import make_scene, write_colmap_scene
    from gs_init_tpu_torch.engine.runner import Runner

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sc = make_scene(seed=0, n_gaussians=400, n_cams=12, width=width, height=height)
        data_dir = write_colmap_scene(tmp, sc, n_points=300)
        cfg = Config(
            data_dir=data_dir, data_factor=1, result_dir=os.path.join(tmp, "res"), max_steps=steps,
            eval_steps=[], test_every=4, max_gaussians=4096, pair_capacity=1 << 18,
            sh_degree=3, sh_degree_interval=100, tb_every=100,
            strategy=DefaultStrategyConfig(refine_start_iter=50, refine_every=100, reset_every=10_000),
        )
        runner = Runner(cfg)
        n0 = int(runner.gstate.alive.sum())
        kernels.reset_launch_counts()
        psnr0 = runner.eval(0)["psnr"]
        t1 = time.perf_counter()
        runner.train()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with open(os.path.join(cfg.result_dir, "stats", f"val_step{steps}.json")) as f:
            psnr1 = json.load(f)["psnr"]
        n1 = int(runner.gstate.alive.sum())
        log(f"  runner: {len(runner.trainset)} train / {len(runner.valset)} val views at "
            f"{width}x{height}, gaussians {n0} -> {n1}, {steps} steps in {t2 - t1:.3f} s "
            f"(set-up {t1 - t0:.3f} s), launches {json.dumps(dict(kernels.LAUNCHES))}; "
            f"eval PSNR {psnr0:.3f} -> {psnr1:.3f}")
        if not psnr1 > psnr0:
            raise RuntimeError("eval PSNR did not rise over the Runner's training")
        if n1 <= n0:
            raise RuntimeError("the Runner's refines did not grow the gaussians")


# ------------------------------------------------------------------ phase 7


def trainer_entry(steps=300, width=648, height=420):
    """Phase 7: gs_init_tpu_torch.trainer.main on phase 5's scene, once per
    preset, with checkpoints at the middle and the end, PLY export and
    compression; then the eval-only restart from the last checkpoint and a
    resumed step from the middle one."""
    import torch
    from gs_init_tpu_torch import kernels, trainer
    from gs_init_tpu_torch.config import parse_cli
    from gs_init_tpu_torch.datasets.synthetic import make_scene, write_colmap_scene
    from gs_init_tpu_torch.engine.runner import Runner
    from gs_init_tpu_torch.utils.compression import decompress_splats
    from gs_init_tpu_torch.utils.ply import read_ply_splats

    half = steps // 2
    with tempfile.TemporaryDirectory() as tmp:
        sc = make_scene(seed=0, n_gaussians=400, n_cams=12, width=width, height=height)
        data_dir = write_colmap_scene(tmp, sc, n_points=300)
        for preset, extra in (
            ("default", ["--strategy.refine_start_iter=50", "--strategy.refine_every=100",
                         "--strategy.reset_every=10000"]),
            ("mcmc", ["--strategy.refine_start_iter=50", "--strategy.refine_every=50",
                      "--strategy.cap_max=350"]),
        ):
            res = os.path.join(tmp, preset)
            argv = [preset, f"--data_dir={data_dir}", "--data_factor=1", f"--result_dir={res}",
                    f"--max_steps={steps}", f"--eval_steps=[{steps}]", f"--save_steps=[{half},{steps}]",
                    f"--ply_steps=[{steps}]", "--save_ply", "--compression=quantized", "--test_every=4",
                    "--max_gaussians=4096", "--pair_capacity=262144", "--sh_degree_interval=100",
                    "--tb_every=100"] + extra
            t0 = time.perf_counter()
            psnr0 = Runner(parse_cli(argv, trainer.build_presets())).eval(0)["psnr"]
            kernels.reset_launch_counts()
            t1 = time.perf_counter()
            runner = trainer.main(argv)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            launches = {k: kernels.LAUNCHES[k] for k in ("composite_fwd", "composite_bwd")}
            with open(os.path.join(res, "stats", f"val_step{steps}.json")) as f:
                psnr1 = json.load(f)["psnr"]
            n1 = int(runner.gstate.alive.sum())
            ply_means = read_ply_splats(os.path.join(res, f"splats_{steps}.ply"))[0]
            comp_means = decompress_splats(os.path.join(res, f"compressed_{steps}.npz"))[0]
            ckpt = os.path.join(res, "ckpts", f"ckpt_{steps}.npz")
            restart = trainer.main([preset, f"--data_dir={data_dir}", "--data_factor=1",
                                    f"--result_dir={res}_restart", "--test_every=4", "--max_gaussians=4096",
                                    "--pair_capacity=262144", f"--ckpt=[{ckpt}]"])
            t3 = time.perf_counter()
            with open(os.path.join(f"{res}_restart", "stats", f"val_step{steps}.json")) as f:
                psnr_re = json.load(f)["psnr"]
            frames = sorted(x for x in os.listdir(os.path.join(f"{res}_restart", "renders"))
                            if x.startswith(f"traj_{steps}_"))
            resumed = Runner(parse_cli(argv, trainer.build_presets()))
            at = resumed.load(os.path.join(res, "ckpts", f"ckpt_{half}.npz"))
            m = resumed.train_iteration(at + 1)
            finite = all(bool(torch.isfinite(v).all()) for v in m.values())
            log(f"  trainer {preset}: {steps} steps in {t2 - t1:.3f} s ({steps / (t2 - t1):.3f} steps/s, one "
                f"npz per save step and the PLY, compression and eval inside), set-up and initial eval "
                f"{t1 - t0:.3f} s; eval PSNR {psnr0:.4f} -> {psnr1:.4f}; alive {n1} "
                f"(cap_max {runner.cfg.strategy.cap_max if preset == 'mcmc' else '-'}); launches in main() "
                f"{json.dumps(launches)}; PLY {len(ply_means)} and compressed {len(comp_means)} splats; "
                f"eval-only restart PSNR {psnr_re:.6f} (|diff| {abs(psnr_re - psnr1):.2e}), "
                f"{len(frames)} trajectory frames, {t3 - t2:.3f} s; resumed step {at + 1} from ckpt_{half}: "
                f"loss {float(m['loss']):.5f}, finite {finite}")
            if not psnr1 > psnr0:
                raise RuntimeError(f"trainer {preset}: eval PSNR did not rise over training")
            if preset == "mcmc" and n1 > runner.cfg.strategy.cap_max:
                raise RuntimeError(f"trainer mcmc: {n1} alive above cap_max")
            if len(ply_means) != n1 or len(comp_means) != n1:
                raise RuntimeError(f"trainer {preset}: the PLY or compressed export lost splats")
            if abs(psnr_re - psnr1) > 1e-6 or not frames:
                raise RuntimeError(f"trainer {preset}: the eval-only restart did not reproduce the run")
            if not finite or at != half:
                raise RuntimeError(f"trainer {preset}: resuming from ckpt_{half} failed")
            want = dict(composite_fwd=steps + len(runner.valset), composite_bwd=steps)
            if launches != want:
                raise RuntimeError(f"trainer {preset}: launches {launches}, not {want}")
            del restart, resumed, runner


# ------------------------------------------------------------------ phase 6


def surface_depth_stub(scene, parser):
    """scripts/e2e_quality.py's oracle predictor: the scene's surface depth
    per training image (NaN where alpha <= 0.3), in trainset order, under
    the stub's affine distortion (0.37 depth + 1.3)."""
    from gs_init_tpu_torch.mdi.predictors.stub import StubPredictor

    depths = [
        np.where(scene.alphas[i] > 0.3, scene.surface_depths[i], np.nan).astype(np.float32)
        for i in parser.split_indices("train")
    ]
    calls = iter(range(1 << 30))
    return StubPredictor(oracle=lambda image, intr: depths[next(calls) % len(depths)], scale=0.37, shift=1.3)


def clustered_colmap(tmp, width, height, n_cams, dev):
    from gs_init_tpu_torch.datasets.synthetic import make_clustered_scene, write_colmap_scene

    t0 = time.perf_counter()
    scene = make_clustered_scene(seed=3, n_cams=n_cams, width=width, height=height, device=dev)
    data_dir = write_colmap_scene(tmp, scene, n_points=250)  # the foreground cluster only
    log(f"  clustered scene {width}x{height}, {n_cams} cameras, {len(scene.points)} gaussians, "
        f"250 SfM points: built in {time.perf_counter() - t0:.3f} s")
    return scene, data_dir


def mdi_init_full_width(dev, scene, data_dir):
    """Phase 6a: the monocular-depth init in three configurations."""
    import torch
    from gs_init_tpu_torch.config import Config
    from gs_init_tpu_torch.datasets.parser import Parser
    from gs_init_tpu_torch.mdi.init import pts_and_rgb_from_monocular_depth

    def defaults(c):
        pass

    def interpolate_rbf(c):
        c.mdi.alignment.method = "interpolate"
        c.mdi.alignment.interp.method = "rbf"

    def lof_native(c):
        c.mdi.postprocess.lof_outlier_removal = True
        c.mdi.postprocess.merge_subsample = True
        c.mdi.postprocess.merge_impl = "native"

    with tempfile.TemporaryDirectory() as tmp:
        parser = Parser(data_dir, factor=1, test_every=8)
        # Depths in the parser's world are the scene's times its similarity scale.
        k = float(np.cbrt(np.linalg.det(parser.transform[:3, :3])))
        want = k / 0.37
        for setup in (defaults, interpolate_rbf, lof_native):
            cfg = Config(data_dir=data_dir, data_factor=1, test_every=8, init_type="monocular_depth",
                         result_dir=os.path.join(tmp, "res"))
            cfg.mdi.predictor = "stub"
            cfg.mdi.use_cache = False
            setup(cfg)
            per_image = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            pts, rgbs = pts_and_rgb_from_monocular_depth(
                cfg, parser, model=surface_depth_stub(scene, parser), device=dev, per_image=per_image
            )
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            ratio = np.array([r["scale"] for r in per_image]) / want
            per = np.array([r["seconds"] for r in per_image])
            worst = float(ratio[np.argmax(np.abs(ratio - 1))])
            log(f"  mdi init [{setup.__name__}]: {len(per_image)} images, {secs:.3f} s in all, "
                f"{per.mean():.4f} s per image (median {np.median(per):.4f}, max {per.max():.4f}); "
                f"{len(pts)} points out; scale / (similarity scale / 0.37): median "
                f"{float(np.median(ratio)):.5f}, worst {worst:.5f}; peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
            if not (len(pts) > 1000 and np.isfinite(pts).all() and np.isfinite(rgbs).all()):
                raise RuntimeError(f"mdi init [{setup.__name__}]: no usable cloud")
            if abs(float(np.median(ratio)) - 1) > 0.01:
                raise RuntimeError(f"mdi init [{setup.__name__}]: the stub's scale was not recovered")


def three_arms(dev, steps=800, width=648, height=420, n_cams=12):
    """Phase 6b: E2E_QUALITY.json's scenario through the port's Runner; then
    the sfm arm again with the batch prefetch thread off, for its rate."""
    import torch
    from gs_init_tpu_torch import kernels
    from gs_init_tpu_torch.config import Config
    from gs_init_tpu_torch.datasets.parser import Parser
    from gs_init_tpu_torch.engine.runner import Runner

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        scene, data_dir = clustered_colmap(tmp, width, height, n_cams, dev)
        for arm, prefetch in (("sfm", 2), ("monocular_depth", 2), ("sfm+mdi", 2), ("sfm", 0)):
            label = arm if prefetch else f"{arm}, no prefetch"
            init_type = "sfm" if arm == "sfm" else "monocular_depth"
            # scripts/e2e_quality.py run()'s settings.
            cfg = Config(
                data_dir=data_dir, data_factor=1, data_prefetch=prefetch,
                result_dir=os.path.join(tmp, label.replace("+", "_").replace(", ", "_").replace(" ", "_")),
                max_steps=steps, test_every=8, sh_degree=2, max_gaussians=131072,
                init_type=init_type, batch_size=1, eval_steps=[], save_steps=[steps], tb_every=200,
            )
            cfg.mdi.include_sfm_points = arm == "sfm+mdi"
            cfg.auto_pair_capacity = False
            cfg.pair_capacity = 1 << 21
            cfg.strategy.refine_start_iter = 300
            cfg.strategy.refine_stop_iter = int(steps * 0.6)
            cfg.strategy.reset_every = max(steps // 2, 600)
            cfg.strategy.refine_every = 150
            cfg.mdi.predictor = "stub"
            cfg.mdi.use_cache = False
            cfg.mdi.subsampling.factor = 6
            cfg.mdi.depth_gradient_mask = True
            t0 = time.perf_counter()
            parser = Parser(data_dir, factor=1, test_every=cfg.test_every)
            model = surface_depth_stub(scene, parser) if init_type == "monocular_depth" else None
            runner = Runner(cfg, parser=parser, mdi_model=model, device=dev)
            n0 = int(runner.gstate.alive.sum())
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            kernels.reset_launch_counts()
            runner.train()  # evaluates once, at the last step
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            launches = dict(kernels.LAUNCHES)
            stats = runner.eval(steps)
            n_val = len(runner.valset)
            want = dict(composite_fwd=steps + n_val, composite_bwd=steps)
            log(f"  arm {label}: init {t1 - t0:.3f} s ({n0} gaussians), {steps} steps in {t2 - t1:.3f} s "
                f"({steps / (t2 - t1):.3f} steps/s), {stats['num_GS']} gaussians at the end; eval PSNR "
                f"{stats['psnr']:.4f}, SSIM {stats['ssim']:.4f}; launches in train() "
                f"{json.dumps({k: launches[k] for k in want})} (want {json.dumps(want)}: one per step, "
                f"and the forward once per view of train()'s final eval)")
            if any(launches[k] != v for k, v in want.items()):
                raise RuntimeError(f"arm {label}: the compositor did not launch once per train step")
            if not np.isfinite(stats["psnr"]):
                raise RuntimeError(f"arm {label}: non-finite eval PSNR")
            if prefetch:
                res[arm] = stats
    psnr = {k: round(v["psnr"], 4) for k, v in res.items()}
    log(f"  three arms, eval PSNR: {json.dumps(psnr)}")
    if not (res["monocular_depth"]["psnr"] > res["sfm"]["psnr"] and res["sfm+mdi"]["psnr"] > res["sfm"]["psnr"]):
        raise RuntimeError("the mdi arms did not beat the sfm arm in eval PSNR")
    return res


# ----------------------------------------------------------------- phase 6c


def held(tag, got, want, rtol):
    """|got - want| / max|want|, raising above rtol."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))
    if not err <= rtol:
        raise RuntimeError(f"{tag}: card against CPU {err:.3e} of max, above {rtol:g}")
    return err


def depth_card_vs_cpu(dev):
    """Phase 6c (1): Metric3D small on one image at its full crop and DA-V2
    vits at 518x798, each built twice from seed 0 (the weights are drawn on
    the CPU, so both copies hold the same), on the card and on the CPU."""
    from gs_init_tpu_torch.mdi.predictors.depth_anything_v2 import DepthAnythingV2Predictor
    from gs_init_tpu_torch.mdi.predictors.interface import CameraIntrinsics
    from gs_init_tpu_torch.mdi.predictors.metric3d import CROP, Metric3DPredictor

    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (1,) + CROP + (3,), dtype=np.uint8)
    intr = [CameraIntrinsics(fx=900.0, fy=900.0, cx=CROP[1] / 2, cy=CROP[0] / 2)]
    m3d = {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        out = Metric3DPredictor("small", allow_random_weights=True, device=where, seed=0).predict_depth_batch(img, intr)[0]
        m3d[where] = out
        log(f"  metric3d small, one {CROP[1]}x{CROP[0]} image on {where}: built and run in "
            f"{time.perf_counter() - t0:.3f} s")
    g, w = m3d[dev], m3d["cpu"]
    errs = {k: held(f"metric3d small {k}", getattr(g, k), getattr(w, k), NET_RTOL)
            for k in ("depth", "depth_confidence", "normal", "normal_confidence")}
    if not np.array_equal(g.mask, w.mask):
        raise RuntimeError("metric3d small: the card's mask differs from the CPU's")
    log(f"  metric3d small card vs CPU, of each output's max (limit {NET_RTOL:g}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f"; depth range {w.depth.min():.4f}"
        f"..{w.depth.max():.4f}")

    img = rng.integers(0, 256, (1, 518, 798, 3), dtype=np.uint8)
    dav = {where: DepthAnythingV2Predictor("vits", metric=True, allow_random_weights=True, device=where,
                                           seed=0).predict_depth_batch(img, [None])[0]
           for where in (dev, "cpu")}
    err = held("depth_anything_v2 vits depth", dav[dev].depth, dav["cpu"].depth, NET_RTOL)
    if not np.array_equal(dav[dev].mask, dav["cpu"].mask):
        raise RuntimeError("depth_anything_v2 vits: the card's mask differs from the CPU's")
    log(f"  depth_anything_v2 vits at 518x798 (37x57 patches) card vs CPU: depth {err:.3e} of max "
        f"(limit {NET_RTOL:g}); depth range {dav['cpu'].depth.min():.4f}..{dav['cpu'].depth.max():.4f}")


def vit_flops(tokens, dim, depth):
    """Multiply-adds x 2 of a ViT's blocks: qkv, proj and the 4x MLP
    (2 N 12 d^2) and the two attention products (4 N^2 d), per layer."""
    return depth * (2 * tokens * 12 * dim * dim + 4 * tokens * tokens * dim)


def full_width_nets(dev):
    """Each depth network at its default backbone and input size: (label,
    predictor factory, the net's input at 1296x840, the ViT runs inside it
    as (module, input, tokens per sequence), the whole net's call)."""
    import torch
    from gs_init_tpu_torch.mdi.predictors import apple_depth_pro, depth_anything_v2, metric3d, moge, unidepth
    from gs_init_tpu_torch.models.depth_pro import split_to_patches

    kw = dict(allow_random_weights=True, device=dev)
    rnd = lambda *shape: torch.randn(shape, device=dev, generator=torch.Generator(dev).manual_seed(0))
    mh, mw = moge.token_budget_hw(840, 1296)

    def depth_pro_vits(net, x):
        enc = net.depth_pro.encoder
        crops = torch.cat([split_to_patches(x[..., : int(1536 * r), : int(1536 * r)], 384, ov)
                           for r, ov in zip(net.ratios, net.overlaps)])
        return [(enc.patch_encoder.model, crops, 577), (enc.image_encoder.model, x[..., :384, :384], 577)]

    K = torch.tensor([[[0.9 * mw, 0, mw / 2], [0, 0.9 * mw, mh / 2], [0, 0, 1]]], device=dev)
    return (
        ("metric3d large (the default)", lambda: metric3d.Metric3DPredictor("large", **kw),
         rnd(1, 3, *metric3d.CROP), lambda n, x: [(n.encoder, x, 44 * 76 + 5)], lambda n, x: n(x)),
        ("depth_anything_v2 vitl", lambda: depth_anything_v2.DepthAnythingV2Predictor("vitl", metric=True, **kw),
         rnd(1, 3, 518, 798), lambda n, x: [(n.pretrained, x, 37 * 57 + 1)], lambda n, x: n(x)),
        ("moge vitl", lambda: moge.MoGePredictor("vitl", **kw), rnd(1, 3, mh, mw),
         lambda n, x: [(n.encoder, x, mh * mw // 196 + 1)], lambda n, x: n(x)),
        ("unidepth vitl", lambda: unidepth.UniDepthPredictor("vitl", **kw), rnd(1, 3, mh, mw),
         lambda n, x: [(n.encoder, x, mh * mw // 196 + 1)], lambda n, x: n(x, K)),
        ("depth_pro large (1536, 35 + 1 crops of 384)", lambda: apple_depth_pro.AppleDepthProPredictor(**kw),
         rnd(1, 3, 1536, 1536), depth_pro_vits, lambda n, x: n(x)),
    )


def depth_full_width(dev, scene, batches=((1, 3), (4, 2))):
    """Phase 6c (2): every depth network at its default backbone and input
    size on the clustered scene's 1296x840 images, at batch 1 and 4, random
    weights: seconds per image, peak memory, finite outputs, unit normals;
    then at batch 1 the whole net's device time and its ViT runs' (CUDA
    events), with the ViTs' FLOP rate."""
    import torch
    from gs_init_tpu_torch.mdi.predictors.interface import CameraIntrinsics
    from gs_init_tpu_torch.models.common import full_fp32

    images = np.asarray(scene.images[:4])
    intr = [CameraIntrinsics(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]))
            for K in np.asarray(scene.Ks[:4])]
    for label, make, x, vit_runs, whole in full_width_nets(dev):
        t0 = time.perf_counter()
        pred = make()
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in pred.net.parameters())
        log(f"  {label}: {n_params} parameters, built with random weights in "
            f"{time.perf_counter() - t0:.3f} s; network input {x.shape[3]}x{x.shape[2]}")
        for b, reps in batches:
            pred.predict_depth_batch(images[:b], intr[:b])  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(reps):
                outs = pred.predict_depth_batch(images[:b], intr[:b])
            per = (time.perf_counter() - t0) / (reps * b)
            peak = torch.cuda.max_memory_allocated() / 2**30
            note = ""
            for o in outs:
                if not (np.isfinite(o.depth).all() and o.mask.any()):
                    raise RuntimeError(f"{label}: non-finite depth or an empty mask")
                if o.normal is not None:
                    nn_err = float(np.abs(np.linalg.norm(o.normal, axis=-1) - 1).max())
                    if not (np.isfinite(o.normal).all() and nn_err <= NORMAL_ATOL):
                        raise RuntimeError(f"{label}: normals not unit ({nn_err:.3e})")
                    note = f", |normal| - 1 at most {nn_err:.2e}"
            log(f"  {label}, batch {b}: {per:.4f} s per image ({reps} calls), peak memory {peak:.3f} GiB"
                f"{note}; depth {outs[0].depth.min():.3f}..{outs[0].depth.max():.3f}")
        with torch.inference_mode(), full_fp32():
            net_ms = cuda_ms(lambda: whole(pred.net, x), 3)
            parts = []
            for mod, inp, tokens in vit_runs(pred.net, x):
                blk = mod.blocks
                fl = vit_flops(tokens, blk[0].norm1.normalized_shape[0], len(blk)) * inp.shape[0]
                parts.append((cuda_ms(lambda: mod(inp), 3), fl, inp.shape[0], tokens))
            top = top_kernels(lambda: whole(pred.net, x))
        vit_ms = sum(p[0] for p in parts)
        fl = sum(p[1] for p in parts)
        log(f"  {label}, batch 1, device time: whole net {net_ms:.3f} ms; ViT "
            + " + ".join(f"{ms:.3f} ms ({n} x {tok} tokens)" for ms, _, n, tok in parts)
            + f" = {vit_ms:.3f} ms, {fl / 1e12:.3f} TFLOP at {fl / vit_ms / 1e9:.2f} TFLOP/s (FP32 bound "
            f"{fl / PEAK_FP32_FLOPS * 1e3:.3f} ms); the rest {net_ms - vit_ms:.3f} ms; top kernels (profiler, "
            f"one call): " + "; ".join(f"{ms:.3f} ms x{n} {name[:60]}" for ms, n, name in top))
        del pred
        torch.cuda.empty_cache()


def top_kernels(fn, k=4):
    """The k kernels with the most device time in one call of fn (torch.profiler):
    (ms, launches, name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", None)
            rows.append(((evt.self_cuda_time_total if us is None else us) / 1e3, evt.count, evt.key))
    return sorted(rows, reverse=True)[:k]


class TimedPredictor:
    """A predictor whose predict_depth_batch calls are timed (they return
    numpy, so each call ends synchronised)."""

    def __init__(self, inner):
        self.inner, self.name, self.seconds, self.calls = inner, inner.name, 0.0, 0

    def predict_depth_batch(self, images, intrinsics):
        t0 = time.perf_counter()
        out = self.inner.predict_depth_batch(images, intrinsics)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out


def depth_runner_e2e(dev, data_dir, steps=20):
    """Phase 6c (3): the default predictor end to end. The init alone first
    (pick_model's Metric3D large behind a timer), for its share of
    predicting and aligning; then Runner(cfg) builds its own through
    pick_model, initialises and takes 20 train steps."""
    import torch
    from gs_init_tpu_torch import kernels
    from gs_init_tpu_torch.config import Config
    from gs_init_tpu_torch.datasets.parser import Parser
    from gs_init_tpu_torch.engine.runner import Runner
    from gs_init_tpu_torch.mdi.init import pts_and_rgb_from_monocular_depth
    from gs_init_tpu_torch.mdi.predictors.interface import pick_model

    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config(data_dir=data_dir, data_factor=1, test_every=8, init_type="monocular_depth",
                     result_dir=os.path.join(tmp, "res"), max_steps=steps, eval_steps=[], save_steps=[],
                     tb_every=10**6)
        cfg.mdi.predictor, cfg.mdi.backbone = "metric3d", "vitl"
        cfg.mdi.allow_random_weights = True
        cfg.mdi.use_cache = False
        cfg.mdi.predict_batch_size = 4
        parser = Parser(data_dir, factor=1, test_every=8)

        t0 = time.perf_counter()
        model = TimedPredictor(pick_model(cfg, device=dev))
        t1 = time.perf_counter()
        per_image = []
        pts, rgbs = pts_and_rgb_from_monocular_depth(cfg, parser, model=model, device=dev, per_image=per_image)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        n_img = len(per_image)
        total, align = t2 - t1, sum(r["seconds"] for r in per_image)
        log(f"  init alone, metric3d large, batch {cfg.mdi.predict_batch_size}: predictor built in "
            f"{t1 - t0:.3f} s; {n_img} images in {total:.3f} s ({total / max(n_img, 1):.4f} s per image): "
            f"predicting {model.seconds:.3f} s ({model.seconds / total:.3f}) in {model.calls} calls, aligning "
            f"and unprojecting {align:.3f} s ({align / total:.3f}), the rest (post-processing, "
            f"host) {total - model.seconds - align:.3f} s; {len(pts)} points out")
        if not (n_img > 0 and len(pts) > 0 and np.isfinite(pts).all() and np.isfinite(rgbs).all()):
            raise RuntimeError("the metric3d init gave no usable cloud")
        del model
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        runner = Runner(cfg, parser=parser, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n0 = int(runner.gstate.alive.sum())
        kernels.reset_launch_counts()
        losses = [runner.train_iteration(step) for step in range(steps)]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = dict(kernels.LAUNCHES)
        loss = np.array([float(m["loss"]) for m in losses])
        want = dict(composite_fwd=steps, composite_bwd=steps)
        log(f"  Runner(cfg), metric3d vitl: set-up and init {t1 - t0:.3f} s, {n0} gaussians "
            f"({len(parser.points)} of them SfM points); {steps} steps in {t2 - t1:.3f} s, loss "
            f"{loss[0]:.4f} -> {loss[-1]:.4f}, pairs {int(losses[-1]['pairs'])} (overflow "
            f"{int(losses[-1]['overflow'])}); launches {json.dumps(launches)} (want {json.dumps(want)})")
        if n0 <= len(parser.points):  # the SfM points are included by default
            raise RuntimeError("the Runner's metric3d init gave no depth points")
        if not np.isfinite(loss).all():
            raise RuntimeError("non-finite loss after the metric3d init")
        if any(launches[k] != v for k, v in want.items()):
            raise RuntimeError("the compositor did not launch once per train step after the metric3d init")


# --------------------------------------------------------------------- main


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import gs_init_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    card = card_line()
    log("phase 1: card and build")
    build_kernels()

    log("phase 2: kernels against plain, and a train step against the CPU")
    check_kernels("mid-size scene", *compositor_case(dev, "mid"))
    check_kernels("deep stack", *compositor_case(dev, "deep"))
    # Tiles other than 16 and 32 take the kernels' other pixel layout (a
    # row of lanes per warp): a small tile and one that is not a power of 2.
    check_kernels("mid-size scene, tile 8", *compositor_case(dev, "mid", tile=8))
    check_kernels("mid-size scene, tile 24", *compositor_case(dev, "mid", tile=24))
    check_kernels("deep stack, tile 8", *compositor_case(dev, "deep", tile=8))
    scan_err = check_scan_kernel(dev)
    step_card_vs_cpu(dev)
    step_card_vs_cpu(dev, aux_groups=True)
    mcmc_card_vs_cpu(dev)
    color_correct_card_vs_cpu(dev)
    oracle_vs_compositor(dev)
    points_from_depth_card_vs_cpu(dev)

    log("phase 3: the main path, train steps at the flagship scenario")
    ctx = flagship_setup(dev)
    launches, step_ms, _ = main_path(ctx)
    profile_window(ctx, float(np.median(step_ms)))

    log("phase 4: kernels on the flagship step's inputs")
    rows = kernel_report(ctx, launches, scan_err)
    launch_floor(dev)
    del ctx
    torch.cuda.empty_cache()
    log("phase 3b: the flagship under the mcmc preset")
    mcmc_flagship(dev)
    torch.cuda.empty_cache()
    log("phase 3c: the flagship with pose, appearance and bilateral-grid optimisation")
    aux_flagship(dev)
    torch.cuda.empty_cache()

    log("phase 5: the Runner end to end")
    runner_e2e()

    with tempfile.TemporaryDirectory() as tmp:
        scene, data_dir = clustered_colmap(tmp, 1296, 840, 24, dev)
        log("phase 6a: monocular-depth init at full width")
        mdi_init_full_width(dev, scene, data_dir)
        log("phase 6b: the three arms, sfm, monocular_depth and sfm+mdi; sfm without prefetch")
        three_arms(dev)
        log("phase 6c: the depth networks, card against CPU, at full width, and the Runner's metric3d init")
        depth_card_vs_cpu(dev)
        depth_full_width(dev, scene)
        depth_runner_e2e(dev, data_dir)
    log("phase 7: the trainer entry point, both presets, checkpoints and the eval-only restart")
    trainer_entry()

    log(f"total {time.perf_counter() - t_start:.3f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
