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
   on a mid-size scene (20k gaussians, 640x480, tile 32) and on the deep
   stack of 96 gaussians at opacity 0.95 (tile 16); the scan probe on its
   [128, 128] inputs. Then one train step of a small scene on the card
   against the same step on the CPU, where the wrappers run the plain
   versions.
3. The main path: the train step at bench.py's flagship scenario (300k
   gaussians, capacity 393216, 1296x840, tile 32, chunk 128, SH degree 3,
   L1 + SSIM, Adam, densification statistics), a step function built
   afresh, 3 warm-up and 20 timed steps. The launch counts are set to 0
   just before and read just after; each compositor kernel must have
   launched once per step, the scan probe once (at the step function's
   first call). A profiler window of 3 more steps gives the device time by
   kernel.
4. Each kernel against its plain version on the flagship step's own inputs
   (captured from one more step), the time of both, and each kernel's bound
   from this run's data.
5. The Runner end to end: a synthetic COLMAP scene at 648x420 with 12
   cameras, 300 steps with refines at steps 100 and 200; eval PSNR must
   rise from the initial gaussians to the trained ones.

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

# FP32 operations per pair-pixel, counted from the CUDA sources:
# every evaluated pair-pixel runs alpha_at (2 sub, 6 mul, 2 add for sigma,
# exp, 1 mul, 2 compares, 1 min = 16); a pair that composites adds, in the
# forward, w = alpha (T P) (2), four colour/depth FMAs (8) and P *= 1 - alpha
# (2); in the backward 1 - alpha, 1/(1 - alpha), T_k, w (4), q (7), u and
# the Kahan carry (5), dalpha (3), four colour FMAs (8) and P (1); an
# unclamped pair adds de, dsig, dsx, dsy and six moment sums (13).
OPS_EVAL = 16
OPS_FWD_COMPOSITED = 12
OPS_BWD_COMPOSITED = 28
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


def compositor_case(dev, kind, seed=0):
    """Project, bin and pack a random scene; returns the compositor's
    arguments and a random output cotangent."""
    import torch
    from gs_init_tpu_torch.ops.projection import project_gaussians
    from gs_init_tpu_torch.ops.tiles import bin_gaussians, pack_table

    rng = np.random.default_rng(seed)
    if kind == "deep":
        # tests/test_rasterize_pallas.py's early-termination stack, with the
        # wider footprint of tests/torch_parity.py so that whole tiles
        # saturate and stop before their last chunk.
        n, width, height, tile, cap = 96, 64, 48, 16, 8192
        means = np.zeros((n, 3))
        means[:, 0] = rng.uniform(-0.1, 0.1, n)
        means[:, 1] = rng.uniform(-0.1, 0.1, n)
        means[:, 2] = np.linspace(2.0, 6.0, n)
        quats = np.tile([1.0, 0.0, 0.0, 0.0], (n, 1))
        scales = np.full((n, 3), 1.0)
        opac = np.full((n,), 0.95)
        focal = 50.0
    else:  # mid-size scene
        n, width, height, tile, cap = 20_000, 640, 480, 32, 1 << 18
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
    same chunks). Returns (forward max abs error, backward max abs error)."""
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
    log(f"  {tag}: {num_tiles} tiles, {int(starts[-1])} pairs, {early} tiles stopped early; "
        f"fwd rows 0-5 max abs err by row {[float(f'{e:.3e}') for e in row_err.tolist()]}, "
        f"rows 0-3, 5 {unit_err:.3e} (tol {FWD_ATOL:g} abs), depth err / max(1, row max) "
        f"{depth_rel:.3e} (tol {DEPTH_RTOL:g}), row 6 equal {bool(torch.equal(nproc_k, nproc_p))}; "
        f"bwd max abs err {bwd_err:.3e}, max err / column max {bwd_rel:.3e} (tol {BWD_RTOL:g})")
    if unit_err > FWD_ATOL or depth_rel > DEPTH_RTOL or not torch.equal(out_k[:, 6], out_p[:, 6]):
        raise RuntimeError(f"{tag}: forward kernel disagrees with its plain version")
    if bwd_rel > BWD_RTOL:
        raise RuntimeError(f"{tag}: backward kernel disagrees with its plain version")
    return fwd_err, bwd_err


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


def step_card_vs_cpu(dev):
    """One train step of a small scene on the card and on the CPU from the
    same state: same loss, Adam moments and densification statistics."""
    import torch
    from gs_init_tpu_torch.config import Config
    from gs_init_tpu_torch.datasets.synthetic import look_at
    from gs_init_tpu_torch.engine import optim
    from gs_init_tpu_torch.engine.params import PARAM_NAMES, init_from_points, state_from_numpy
    from gs_init_tpu_torch.engine.strategy import default as dstrat
    from gs_init_tpu_torch.engine.train_step import Batch, make_train_step

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
    acfg = optim.make_adam_config(cfg, 2.0)
    c2w = look_at(np.array([0.0, 0.0, -4.0]), np.zeros(3)).astype(np.float32)
    f = 0.9 * width
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32)
    target = rng.uniform(0, 1, (1, height, width, 3)).astype(np.float32)
    res = {}
    for d in (torch.device("cpu"), dev):
        T = lambda x: torch.as_tensor(x, device=d)
        g = state_from_numpy(leaves, alive, d)
        a = optim.init_adam_state(g.params)
        s = dstrat.init_state(cap, d)
        batch = Batch(camtoworlds=T(c2w)[None], Ks=T(K)[None], pixels=T(target),
                      image_ids=torch.zeros((1,), dtype=torch.long, device=d))
        g, a, s, m = make_train_step(cfg, acfg, width, height)(g, a, s, batch, 0)
        res[d.type] = (float(m["loss"]), int(m["pairs"]), a, s)
    (lc, pc, ac, sc), (lg, pg, ag, sg) = res["cpu"], res["cuda"]
    worst = 0.0
    for k in PARAM_NAMES:
        want, got = getattr(ac.mu, k), getattr(ag.mu, k).cpu()
        worst = max(worst, float((got - want).abs().max() / want.abs().max().clamp(min=1e-30)))
    gw, gg = sc.grad2d, sg.grad2d.cpu()
    g_err = float((gg - gw).abs().max() / gw.abs().max().clamp(min=1e-30))
    # A radius is a ceil of a float that the two math libraries may round
    # apart: allow one pixel, and a few gaussians whose visibility flips.
    seen_diff = int((sc.count != sg.count.cpu()).sum())
    r_diff = float((sc.radii_max - sg.radii_max.cpu()).abs().max()) * max(width, height)
    log(f"  train step card vs CPU ({width}x{height}, {n} gaussians, {pg} vs {pc} pairs): loss "
        f"{lg:.7f} vs {lc:.7f}; Adam mu max err / leaf max {worst:.3e}, grad2d {g_err:.3e} "
        f"(tol {STEP_RTOL:g}); visibility differs for {seen_diff}, max radius by {r_diff:.3f} px")
    if (abs(pg - pc) > 1e-3 * pc or abs(lg - lc) > 1e-4 * abs(lc) or worst > STEP_RTOL
            or g_err > STEP_RTOL or seen_diff > 2 or r_diff > 1.001):
        raise RuntimeError("the train step on the card disagrees with the same step on the CPU")


# ------------------------------------------------------------------ phase 3


def flagship_setup(dev, n=300_000, cap=393_216, width=1296, height=840):
    """bench.py's scenario: a uniform random cloud in a box, kNN scale init,
    one camera, a random target image."""
    import torch
    from gs_init_tpu_torch.config import Config
    from gs_init_tpu_torch.datasets.synthetic import look_at
    from gs_init_tpu_torch.device import generator
    from gs_init_tpu_torch.engine import optim
    from gs_init_tpu_torch.engine.params import init_from_points
    from gs_init_tpu_torch.engine.runner import grown_pair_capacity
    from gs_init_tpu_torch.engine.strategy import default as dstrat
    from gs_init_tpu_torch.engine.train_step import Batch, make_train_step

    rng = np.random.default_rng(0)
    pts = np.stack(
        [rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(-1, 6, n)], -1
    ).astype(np.float32)
    rgbs = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    cfg = Config(max_steps=30_000, sh_degree=3, max_gaussians=cap, pair_capacity=1 << 21,
                 tile_size=32, chunk_size=128)
    t0 = time.perf_counter()
    gstate = init_from_points(torch.as_tensor(pts, device=dev), torch.as_tensor(rgbs, device=dev),
                              cap, cfg.sh_degree, generator=generator(0, dev))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    acfg = optim.make_adam_config(cfg, scene_scale=4.0)
    c2w = look_at(np.array([0.0, 0.0, -8.0]), np.zeros(3)).astype(np.float32)
    f = 0.85 * width
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32)
    target = rng.uniform(0, 1, (1, height, width, 3)).astype(np.float32)
    T = lambda x: torch.as_tensor(x, device=dev)
    ctx = dict(
        cfg=cfg, gstate=gstate, adam=optim.init_adam_state(gstate.params),
        sstate=dstrat.init_state(cap, dev),
        batch=Batch(camtoworlds=T(c2w)[None], Ks=T(K)[None], pixels=T(target),
                    image_ids=torch.zeros((1,), dtype=torch.long, device=dev)),
        make_step=lambda: make_train_step(cfg, acfg, width, height), step=0,
    )
    ctx["step_fn"] = ctx["make_step"]()
    # Size the pair table from one step, as the Runner does on overflow.
    m = run_step(ctx)
    pairs, overflow = int(m["pairs"]), int(m["overflow"])
    cfg.pair_capacity = grown_pair_capacity(pairs, overflow, cfg.chunk_size)
    log(f"  flagship set-up: {n} gaussians (capacity {cap}) at {width}x{height}, kNN init "
        f"{init_s:.3f} s; first step {pairs} pairs + {overflow} overflow -> pair capacity "
        f"{cfg.pair_capacity}")
    return ctx


def run_step(ctx, mark=None):
    ctx["gstate"], ctx["adam"], ctx["sstate"], m = ctx["step_fn"](
        ctx["gstate"], ctx["adam"], ctx["sstate"], ctx["batch"], ctx["step"], mark=mark
    )
    ctx["step"] += 1
    return m


def main_path(ctx, warm=3, timed=20):
    """The counted run: launch counts from 0, warm-up, timed steps."""
    import torch
    from gs_init_tpu_torch import kernels

    phases = ("setup", "render", "loss", "backward", "adam", "stats")
    kernels.reset_launch_counts()
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
            raise RuntimeError(f"{name} launched {launches.get(name, 0)} times in {steps} steps, "
                               f"not {want[name]}")
    losses = torch.stack([m["loss"] for _, m in records])
    if not bool(torch.isfinite(losses).all()):
        raise RuntimeError("non-finite loss on the main path")
    overflow = max(int(m["overflow"]) for _, m in records)
    if overflow:
        raise RuntimeError(f"pair table overflowed by {overflow} on the main path")
    step_ms = np.array([ev["start"].elapsed_time(ev["end"]) for ev, _ in records])
    order = ("start",) + phases + ("end",)
    phase_ms = {
        order[i + 1]: float(np.mean([ev[order[i]].elapsed_time(ev[order[i + 1]]) for ev, _ in records]))
        for i in range(len(order) - 1)
    }
    log(f"  main path: {steps} steps, launches {json.dumps(launches)}")
    log(f"  step wall time (CUDA events, {timed} steps after {warm} warm-up): median "
        f"{np.median(step_ms):.3f} ms, min {step_ms.min():.3f}, max {step_ms.max():.3f}; "
        f"host clock {wall / timed * 1e3:.3f} ms/step = {timed / wall:.3f} steps/s")
    log(f"  phases (mean ms; 'end' = after the stats): {json.dumps({k: round(v, 4) for k, v in phase_ms.items()})}")
    log(f"  loss {float(losses[0]):.6f} -> {float(losses[-1]):.6f}; pairs {int(records[-1][1]['pairs'])}, "
        f"overflow 0; peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return launches, step_ms, phase_ms


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

    def rec_fwd(*args):
        seen["fwd"] = detach(args)
        return fwd(*args)

    def rec_bwd(*args):
        seen["bwd"] = detach(args)
        return bwd(*args)

    prast.composite_fwd, prast.composite_bwd = rec_fwd, rec_bwd
    try:
        run_step(ctx)
    finally:
        prast.composite_fwd, prast.composite_bwd = fwd, bwd
    return seen["fwd"], seen["bwd"]


def work(fwd_args, out):
    """Pair-pixels this run's data needs: evaluated (in-range pairs of the
    processed chunks, every pixel of their tile), composited (alpha >=
    1/255), and unclamped composited; plus the gaussian rows they read."""
    import torch
    from gs_init_tpu_torch.ops import rasterize as prast

    table, gid, starts, num_tiles, ntx, nty, tile, chunk = fwd_args
    s, e, c0, _ = prast._chunk_windows(starts, chunk)
    nproc = out[:, prast.ROW_NPROC, 0].long()
    evals = comp = uncl = 0
    used = torch.zeros(table.shape[0], dtype=torch.bool, device=table.device)
    for i in range(int(nproc.max())):
        live = torch.nonzero(i < nproc).flatten()
        rows, inr, g = prast._gather_chunk(table, gid, s[live], e[live], c0[live], i, chunk)
        px, py = prast._pixel_coords(live, tile, ntx, nty)
        alpha, aux = prast._alpha_terms(rows, inr, px, py)
        evals += int(inr.sum()) * tile * tile
        comp += int((alpha > 0).sum())
        uncl += int(aux["unclamped"].sum())
        used[g[inr]] = True
    return evals, comp, uncl, int(used.sum())


def kernel_report(ctx, launches, scan_err):
    from gs_init_tpu_torch.ops import rasterize as prast

    fargs, bargs = capture_inputs(ctx)
    log(f"  captured the flagship step's compositor inputs: table {tuple(fargs[0].shape)}, "
        f"{int(fargs[2][-1])} pairs, {fargs[3]} tiles of {fargs[6]}x{fargs[6]}")
    g_out = bargs[4]
    fwd_err, bwd_err = check_kernels("flagship", fargs, g_out, want_absgrad=bargs[10])
    out = prast.composite_fwd(*fargs)
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

    evals, comp, uncl, rows_used = work(fargs, out)
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
    fwd_ops = evals * OPS_EVAL + comp * OPS_FWD_COMPOSITED
    bwd_ops = evals * OPS_EVAL + comp * OPS_BWD_COMPOSITED + uncl * OPS_BWD_UNCLAMPED
    log(f"  work: {evals} evaluated pair-pixels, {comp} composited, {uncl} unclamped; "
        f"{rows_used} gaussian rows read")

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
    scan_err = check_scan_kernel(dev)
    step_card_vs_cpu(dev)

    log("phase 3: the main path, train steps at the flagship scenario")
    ctx = flagship_setup(dev)
    launches, step_ms, _ = main_path(ctx)
    profile_window(ctx, float(np.median(step_ms)))

    log("phase 4: kernels on the flagship step's inputs")
    rows = kernel_report(ctx, launches, scan_err)
    del ctx
    torch.cuda.empty_cache()

    log("phase 5: the Runner end to end")
    runner_e2e()

    log(f"total {time.perf_counter() - t_start:.3f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
