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
   empty kernel and a copy of its inputs to its outputs launched the same
   way: its bound that a launch can reach is the larger of its bytes and
   operations bound and the copy's time (the launch and copy floor).
3b. The flagship under the mcmc preset (init opacity 0.5, scale 0.1,
   opacity and scale regularisers), a relocation every 10 steps from step
   0 (2 in the 20 timed steps): step, relocation and noise times, device
   busy time, peak memory, and the alive count after each relocation,
   which must be the 5% tranche. Compositor launches once per step.
3c. The flagship with pose, appearance and bilateral-grid optimisation:
   step and phase times (the aux Adam has its own mark), peak memory.
5. The Runner end to end: a synthetic COLMAP scene at 648x420 with 12
   cameras, 300 steps with refines at steps 100 and 200; eval PSNR must
   rise from the initial gaussians to the trained ones, and the port's
   reader must find train/loss, train/num_GS, train/mem_peak_gb and
   val/psnr in the run's TensorBoard event file.
6. Monocular-depth init. (a) At full width: scripts/e2e_quality.py's
   clustered scene at 1296x840 with 12 cameras and 250 SfM points (the
   foreground only), the stub predictor over the scene's surface depth
   (scale 0.37, shift 1.3), three configurations: the defaults (RANSAC,
   2,500 hypotheses, static stride 10, SfM density mask, SfM points
   included); an interpolated RBF scale map; the defaults plus LOF removal
   and the native KD-split merge. Seconds per image and for the whole
   init, points out, the recovered scale against 1/0.37 (median and worst
   over images), peak memory. (b) The three arms of E2E_QUALITY.json:
   the clustered scene at 648x420 with 12 cameras, 800 steps with
   e2e_quality.py's run() settings (a refine at 450), for sfm, monocular_depth and sfm+mdi
   init; both mdi arms' eval PSNR must beat the sfm arm's, and the
   compositor kernels must launch once per train step. Then the sfm arm
   again with the batch prefetch thread off, for its steps per second.
6c. The depth networks (random weights from seed 0; float32, TF32 off).
   Metric3D small on one image at its full 616x1064 crop and
   Depth-Anything-V2 vits at 518x798, then MoGe-2 vits, UniDepth-v2 vits
   and a narrow DepthPro (ViT width 64, 4 blocks, 768 input, FOV head) on
   one 1296x840 image, on the card against the CPU: depth, confidence and
   normals within NET_RTOL of each output's max, masks equal. Then every network at its default backbone and input size on
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
6d. SAM (random weights). A narrow SAM (width 64, 4 blocks, 128 px) on
   the card against the CPU, each output within SAM_RTOL of its max; SAM
   ViT-H at 1024, batch 1: the encoder's device time, TFLOP/s and peak
   memory, a 64-prompt decoder call, the top kernels of each; the
   automatic mask generator on one of phase 6a's 1296x840 images (seconds,
   masks kept, at the default filters and with every mask passing them);
   Runner(cfg) with the stub depth aligned per SAM region
   (segmentation.method="sam", ViT-H) on phase 6a's scene (its first
   SAM_CAMERAS cameras) into 20 train steps, one launch of each compositor
   kernel per step.
7. The trainer entry point: gs_init_tpu_torch.trainer.main on phase 5's
   scene, once per preset, 300 steps with checkpoints at 150 and 300, PLY
   export and compression; eval PSNR must rise, MCMC's alive count stay
   within cap_max, the exports hold every live splat, the eval-only
   restart (--ckpt) reproduce the run's PSNR to 1e-6 and write trajectory
   frames, and a Runner loaded from ckpt_150 take a finite step.
8. Eval and integration, with random LPIPS weights written in the npz
   layout to a temporary GS_TPU_CHECKPOINT_DIR. LPIPS at 1296x840 on the
   card against the CPU (within LPIPS_RTOL of the value) and its time per
   eval image, with and without cuDNN; phase 5 again, now with lpips in
   its eval stats and TensorBoard scalars; a two-run sweep (sh_degree 1
   and 3, 200 steps each, a refine at 100) on phase 5's scene through the port's trainer as
   subprocesses, each run rescored from its saved renders, then the
   results tables with the TensorBoard columns; the Method's lifecycle
   with the appearance embedding (50 steps, save, render,
   optimize_embedding's 128 Adam steps, export_demo); the live viewer on
   an ephemeral port while the Runner trains 300 steps on a thread, its
   last /render equal to Runner.render. Every path's compositor launches
   are counted and must match its steps and renders.
9. Multi-GPU (parallel/). The card's machine has one H100, so times here
   are shared-card figures, not scaling. (a) A one-rank NCCL group: the
   sharded and band steps on mesh 1x1 at the flagship (phase 3's cloud
   with anisotropic scales, step 5) against make_train_step from the same
   state, one K1 and one K2 launch each, then each timed beside the plain
   step. (b) Four processes sharing cuda:0 over gloo: meshes 2x1 cameras
   (batch 2), 1x2 gaussians, 2x2 (batch 2), 2x1 and 2x2 bands (batch 1),
   each step against the one-rank step on the card and against its
   witness (the same split of the sums computed by one-rank steps in one
   process), one K1 and one K2 launch per rank per step, the pair-pixels
   outside the pair bounds of each band (must be 0); per rank the step,
   all-gather and gradient all-reduce times and peak memory. (c)
   trainer.main in two processes launched as the JAX trainer's
   (COORDINATOR_ADDRESS), on phase 5's scene for 150 steps, 2x1 cameras
   (batch 2) and 2x1 bands (batch 1), each beside the one-rank run: the
   loss at every step before the first refine against the one-rank run's
   (CURVE_RTOL over the first 12, PRE_REFINE_RTOL to step 99), eval PSNR
   rising, rank 0's npz restarting eval-only on one device to the same
   PSNR, the sharded checkpoint restoring onto one rank equal to the npz. (d) SIFT descriptors and the image filters on one of
   phase 6a's 1296x840 images, card against CPU.
10. The whole path at garden scale (GARDEN): a scene with Mip-NeRF 360
   garden's widths at data_factor 4 built from a seed (96 of its 185
   cameras at 1296x840, test_every 8; 10^6 ground-truth gaussians in make_clustered_
   scene's layout, rendered through K1; 100,000 SfM points on the
   foreground alone, written through write_colmap_scene), then the entry
   points a user calls: parse_cli with the default preset and override
   strings (init_type monocular_depth with the stub over the expected
   depth, capacity 3,000,000, 800 steps, eval and a checkpoint at 800,
   an opacity reset at 600), Runner(cfg, parser, mdi_model=stub).train()
   and the eval-only restart through trainer.main(["--ckpt", ...]). Held:
   the median recovered scale, a finite loss at every step, the alive
   count rising from the first refine to the last within the capacity,
   eval PSNR above the initial gaussians', one K1 and one K2 launch per
   step plus K1 per eval render (the Runner's own count), the restart's
   PSNR equal to 1e-6. Printed: the scene build, the init's seconds per
   image (predict, align, host), the kNN scale init's time and peak
   memory, steps per second between refines, each refine, the retunes and
   overflowed steps, a profiler window after the last refine, eval ms per
   image, the checkpoint's bytes and save / load seconds, peak memory.
   Also: the rim-bias witness (the scale fitted to the exact surface
   depth at the SfM observations' pixels must come out within the median's
   limit); the kNN scale init against two plain searches over the init
   cloud, timed, within KNN_ULP; and the growth run, the same scene from
   a stride-40 mdi init (GROWTH_OVERRIDES), whose alive count must more
   than double across the refines and whose pair table must grow after one.
11. Both presets at their default capacity at garden scale (DEFAULTS):
   the scene of phase 10 with all 185 cameras (161 train, 24 test), whose
   mdi init cloud (~1.68M points) exceeds the presets' max_gaussians of
   1,000,000. Per preset, parse_cli with no capacity, cap_max, pair-table
   or refine override, Runner(cfg, parser, mdi_model=stub), an eval of the
   initial gaussians, train() for 800 steps with the preset's refines
   (default) or relocations and noise (mcmc), and its eval. Held: the
   Runner's subset line, alive == 1,000,000 after init with no repeated
   mean, finite kNN scales, a finite loss at every step, the refines or
   relocations at the preset's steps, alive within the capacity (default)
   or min(cap_max, capacity) (mcmc) after each, no refine granting more
   slots than were free, at least one refine granting a slot (default) or
   one relocation moving a dead gaussian (mcmc), eval PSNR at least PSNR_GAIN_DB over the initial
   gaussians', the card's per-image PSNR and SSIM against the CPU
   (EVAL_PSNR_ATOL, EVAL_SSIM_ATOL), one K1 and one K2 launch per step plus
   K1 per eval render, the scan probe once. Printed: init seconds per
   image and points, the subset's and the kNN's seconds, steps/s per 100
   steps, each refine (candidates, free slots, granted, dropped, median
   scale) or relocation (dead moved, added), noise ms per step (CUDA
   events), retunes and overflowed steps, eval ms per image (render,
   metrics, LPIPS), peak memory, launches.
12. The monocular-depth init's other configurations at garden scale, on
   phase 11's scene with a second COLMAP model whose images observe every
   SfM point they see (write_colmap_scene keeps 40 an image). Each arm is
   parse_cli's defaults plus its overrides, run through
   pts_and_rgb_from_monocular_depth on the card: (a) MSAC, (c) the
   interpolated scale map with the thin-plate RBF, (d) SLIC regions
   (SLIC_CAMERAS cameras), (e) the adaptive stride ((a), (c) and (e) on
   ARM_CAMERAS cameras), (f) LOF and the native
   KD-split merge, (g) the voxel merge on (f)'s cloud after its LOF; (b),
   the interpolated scale map over Delaunay on ARM_CAMERAS cameras, is the
   init of a training run (parse_cli -> Runner(cfg, parser,
   mdi_model=stub).train(), the default preset with LOF and the native
   merge, MDI_TRAIN_STEPS steps, eval).
   Printed per arm: images and cameras, the largest and median SfM
   observations per image, seconds per image by stage (SLIC and the region
   merge within the alignment), points before and after the postprocess,
   the recovered scale (the pipeline arms: the median over pixels of the
   aligned depth over the depth that undoes the stub), the card's peak
   memory and the host's RSS growth. Held: a finite cloud of at least
   MDI_MIN_POINTS, the median recovered scale within SCALE_RTOL, an
   interpolate arm's host RSS growth under MDI_HOST_RSS_GIB, LOF keeping
   LOF_KEEP_MIN of the cloud; LOF's bounded neighbour search against the
   brute force knn over the same cloud (sampled query blocks, timed) and
   the scale-outlier test's pixel neighbours against the [M, M] sort,
   equal apart from ties; the scale-outlier test itself at M =
   OUTLIER_M seeded pixels, its host RSS growth under MDI_HOST_RSS_GIB and
   its injected outliers found; the training run's PSNR gain of PSNR_GAIN_DB,
   one K1 and one K2 launch per step and K1 per eval render, K3 once, no
   alive gaussian with a non-finite parameter; the deterministic arms on
   the first CARD_CPU_IMAGES training images on the card against the CPU
   (equal point counts, points within CARD_CPU_ATOL of the extent).
13. The depth cache and the Runner on a mesh at garden scale, on phase 11's
   scene (161 training images at 1296x840). (a) parse_cli with the default
   predictor and backbone (Metric3D large, random weights) and the cache in
   a temporary directory, on the first CACHE_CAMERAS cameras; a cold pts_and_rgb_from_monocular_depth that
   predicts and writes every entry, then a warm one whose predictor raises
   if it is asked. Held: one .npz per training image in the JAX layout
   (depth, mask, normal at the image's size), no *.tmp left, the warm cloud
   equal to the cold one to the bit with the same per-image scales and
   shifts. Printed: seconds per image by stage (the network and the cache
   write, or the cache read), the cache's bytes, card peak and host RSS
   growth. (b) The stub's predictions written into a second cache; two
   processes sharing cuda:0 over gloo, each a rank of a 1x2 gaussian mesh
   running the default preset at its capacity of 1,000,000 from that cache
   (rank 0 reads every entry and broadcasts the ~1.68M-point cloud; every
   rank keeps the same uniform subset), eval of the initial gaussians,
   MESH_STEPS steps with refines at 100 and 200 on the gathered state, eval,
   rank 0's npz and the sharded checkpoint; beside them a one-rank Runner
   with the same config. Held: rank 0 read every entry and predicted
   nothing, 1,000,000 alive on each rank, the same initial state on both
   ranks and on one device, the loss against the one-rank run (CURVE_RTOL
   over CURVE_STEPS, PRE_REFINE_RTOL to step 99), the refines at 100 and 200
   with equal alive counts and grants on both ranks, the retunes at 0, 100
   and 200 equal on both ranks, eval PSNR above the initial gaussians' and
   within MESH_PSNR_ATOL of the one-rank run's, one K1 and K2 launch per
   step plus K1 per eval render and K3 once per rank, the sharded checkpoint
   restored onto one device equal to the npz to the bit, trainer.main --ckpt
   on the npz reproducing the PSNR to RESTART_PSNR_ATOL. Printed per rank:
   set-up seconds (init, broadcast, subset, kNN), steps/s per 100 steps,
   the step's all-gather, backward and gradient all-reduce ms (CUDA events
   at its marks), each refine with the gather and slice of the state,
   checkpoint bytes and seconds, card peak and host RSS growth.

The line before the last lists the kernels as JSON; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import contextlib
import dataclasses
import gc
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
# MoGe-2's mask is its mask logit > 0, and a random network's logit map
# crosses 0 all over the image: a pixel whose logit lies within rounding of
# 0 may fall on either side on the card and on the CPU. MoGe-2, UniDepth and
# DepthPro masks may differ at up to 1e-4 of the pixels (Metric3D's and
# DA-V2's must be equal).
MASK_FLIP_FRACTION = 1e-4
# The narrow SAM on the card against the CPU with the same random weights:
# each output within 1e-5 of its max |value| (four blocks and the two-way
# decoder in f32, summed in other orders).
SAM_RTOL = 1e-5
# LPIPS on the card against the CPU with the same random weights, within
# 1e-5 of the value (five f32 convolutions and means over 1296x840).
LPIPS_RTOL = 1e-5


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


def cuda_rows(prof, nsteps):
    """(device ms per step, launches per step, name) of each kernel in a
    torch.profiler window of nsteps steps, most device time first."""
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((us / 1e3 / nsteps, evt.count // nsteps, evt.key))
    return sorted(rows, reverse=True)


def profile_window(ctx, step_ms, nsteps=3):
    """Device time by kernel over a few steps (torch.profiler), and the
    device's idle share: 1 - busy time / the unprofiled median step time
    (the profiler slows the host, so its own window overstates idleness)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(nsteps):
            run_step(ctx)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / nsteps
    rows = cuda_rows(prof, nsteps)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:  # a measurement gap, not a fault of the path
        log("  profiler saw no device time here; the CUDA-event phase times above stand")
        return
    log(f"  profiler ({nsteps} steps): device busy {busy_ms:.3f} ms/step; idle share "
        f"{max(0.0, 1 - busy_ms / step_ms):.3f} of the unprofiled {step_ms:.3f} ms step "
        f"({max(0.0, 1 - busy_ms / wall_ms):.3f} of the profiled {wall_ms:.3f} ms); "
        f"top kernels by device time:")
    for ms, cnt, key in rows[:12]:
        log(f"    {ms:9.3f} ms/step  x{cnt:<3d} {key[:110]}")


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
# An empty kernel and a copy kernel, each on p blocks of n threads (rounded
# up to a warp; the scan probe's first grid): the copy reads the probe's two
# [n, p] inputs once and writes its two outputs once, thread i of block b
# on element b n + i (coalesced), the least that a launch doing the
# probe's traffic can take.
EMPTY_SRC = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel(const float*, const float*, float*, float*, int, int) {}
__global__ void copy_kernel(const float* x, const float* m, float* s, float* q, int n, int p) {
  if (threadIdx.x < n) {
    const int i = blockIdx.x * n + threadIdx.x;
    s[i] = x[i];
    q[i] = m[i];
  }
}
extern "C" int empty_launch(const void* x, const void* m, void* s, void* q, int n, int p,
                            void* stream) {
  empty_kernel<<<p, (n + 31) / 32 * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(m), static_cast<float*>(s),
      static_cast<float*>(q), n, p);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int copy_launch(const void* x, const void* m, void* s, void* q, int n, int p,
                           void* stream) {
  copy_kernel<<<p, (n + 31) / 32 * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(m), static_cast<float*>(s),
      static_cast<float*>(q), n, p);
  return static_cast<int>(cudaGetLastError());
}
"""


def launch_floor(dev, launches=100):
    """The scan probe's device-only time (profiler) and CUDA-event time per
    launch, beside the same two for an empty kernel and a copy kernel
    launched the same way. The probe's bound that a launch can reach (the
    launch and copy floor) is the larger of its bytes-and-operations bound
    and the copy's device time; the probe is held against half of it."""
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
    x, m = prast.scan_probe_inputs(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def bound(symbol):
        fn = getattr(lib, symbol)
        fn.argtypes = kernels.KERNELS["scan_probe"][1]
        fn.restype = ctypes.c_int

        def call():
            s, q = torch.empty_like(x), torch.empty_like(m)
            if fn(x.data_ptr(), m.data_ptr(), s.data_ptr(), q.data_ptr(), x.shape[0], x.shape[1], stream):
                raise RuntimeError(f"{symbol} failed")
            return s, q
        return call

    empty, copy = bound("empty_launch"), bound("copy_launch")
    s, q = copy()
    if not (torch.equal(s, x) and torch.equal(q, m)):
        raise RuntimeError("the copy kernel did not copy")
    probe = lambda: prast.scan_probe(x, m)
    res = {}
    for name, call, key in (("scan_probe", probe, "scan_probe_kernel"), ("empty", empty, "empty_kernel"),
                            ("copy", copy, "copy_kernel")):
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
    log(f"  launch floor ({launches} launches each, ctypes; the empty and copy kernels on {x.shape[1]} "
        f"blocks of {x.shape[0]} threads): scan probe {res['scan_probe'][0]:.5f} ms by CUDA events, "
        f"{res['scan_probe'][1]:.5f} ms on the device (profiler); empty kernel "
        f"{res['empty'][0]:.5f} ms by CUDA events, {res['empty'][1]:.5f} ms on the device; copy kernel "
        f"{res['copy'][0]:.5f} ms by CUDA events, {res['copy'][1]:.5f} ms on the device")
    # kernel_report's bound for the probe: two inputs read and two outputs
    # written once, one add or multiply per output element.
    nbytes, ops = 4 * x.numel() * 4, 2 * x.numel()
    floor = max(nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_FLOPS * 1e3, res["copy"][1])
    share = floor / res["scan_probe"][1]
    log(f"  scan probe against its bound (launch and copy floor) {floor:.5f} ms: {share:.3f} of it on the "
        f"device, {'at' if share >= 0.5 else 'below'} half of its bound")
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


def phase5_scene(root, width=648, height=420):
    """Phase 5's scene (400 gaussians, 12 cameras at 648x420, 300 SfM
    points) as a COLMAP dataset, root/scene."""
    from gs_init_tpu_torch.datasets.synthetic import make_scene, write_colmap_scene

    sc = make_scene(seed=0, n_gaussians=400, n_cams=12, width=width, height=height)
    return write_colmap_scene(root, sc, n_points=300)


def runner_e2e(steps=300, width=648, height=420):
    """The Runner from SfM init for `steps` steps with refines at 100 and
    200; eval PSNR must rise. Its TensorBoard scalars (train/loss,
    train/num_GS, train/mem_peak_gb, val/psnr) are read back with the
    port's reader, and with LPIPS weights present the eval reports lpips."""
    import torch
    from gs_init_tpu_torch import kernels
    from gs_init_tpu_torch.config import Config, DefaultStrategyConfig
    from gs_init_tpu_torch.engine.runner import Runner
    from gs_init_tpu_torch.ops.lpips import lpips_available
    from gs_init_tpu_torch.utils.tb import read_scalars

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data_dir = phase5_scene(tmp, width, height)
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
            stats = json.load(f)
        psnr1 = stats["psnr"]
        n1 = int(runner.gstate.alive.sum())
        scalars = read_scalars(os.path.join(cfg.result_dir, "tb"))
        log(f"  runner: {len(runner.trainset)} train / {len(runner.valset)} val views at "
            f"{width}x{height}, gaussians {n0} -> {n1}, {steps} steps in {t2 - t1:.3f} s "
            f"(set-up {t1 - t0:.3f} s), launches {json.dumps(dict(kernels.LAUNCHES))}; "
            f"eval PSNR {psnr0:.3f} -> {psnr1:.3f}, LPIPS {stats.get('lpips', 'not computed (no weights)')}; "
            f"TensorBoard tags read back: {json.dumps({k: len(v) for k, v in sorted(scalars.items())})}")
        if not psnr1 > psnr0:
            raise RuntimeError("eval PSNR did not rise over the Runner's training")
        if n1 <= n0:
            raise RuntimeError("the Runner's refines did not grow the gaussians")
        want_tags = ("train/loss", "train/num_GS", "train/mem_peak_gb", "val/psnr") + (
            ("val/lpips",) if lpips_available() else ())
        missing = [k for k in want_tags if not scalars.get(k)]
        if missing or scalars["val/psnr"][-1] != (steps, float(np.float32(psnr1))):
            raise RuntimeError(f"the Runner's TensorBoard scalars miss {missing} or disagree with its stats")
        if lpips_available() and not np.isfinite(stats.get("lpips", np.nan)):
            raise RuntimeError("LPIPS weights are present but the eval reported no finite lpips")


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
    return depth_stub([
        np.where(scene.alphas[i] > 0.3, scene.surface_depths[i], np.nan).astype(np.float32)
        for i in parser.split_indices("train")
    ])


def depth_stub(depths):
    """The stub predictor (0.37 depth + 1.3) over depths [H, W], one per
    call, in order from the first and round again."""
    from gs_init_tpu_torch.mdi.predictors.stub import StubPredictor

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


# Phase 6b's sfm arm without the prefetch thread, for its rate: the arms'
# config (strategy schedule of an 800-step run) cut to 300 steps, before
# its refine at 450, so that the script with phase 13 keeps within its time.
NO_PREFETCH_STEPS = 300


def three_arms(dev, steps=800, width=648, height=420, n_cams=12):
    """Phase 6b: E2E_QUALITY.json's scenario through the port's Runner; then
    the sfm arm again with the batch prefetch thread off, for its rate
    (NO_PREFETCH_STEPS of the same config)."""
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
            n_steps = steps if prefetch else NO_PREFETCH_STEPS
            init_type = "sfm" if arm == "sfm" else "monocular_depth"
            # scripts/e2e_quality.py run()'s settings.
            cfg = Config(
                data_dir=data_dir, data_factor=1, data_prefetch=prefetch,
                result_dir=os.path.join(tmp, label.replace("+", "_").replace(", ", "_").replace(" ", "_")),
                max_steps=n_steps, test_every=8, sh_degree=2, max_gaussians=131072,
                init_type=init_type, batch_size=1, eval_steps=[], save_steps=[n_steps], tb_every=200,
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
            stats = runner.eval(n_steps)
            n_val = len(runner.valset)
            want = dict(composite_fwd=n_steps + n_val, composite_bwd=n_steps)
            log(f"  arm {label}: init {t1 - t0:.3f} s ({n0} gaussians), {n_steps} steps in {t2 - t1:.3f} s "
                f"({n_steps / (t2 - t1):.3f} steps/s), {stats['num_GS']} gaussians at the end; eval PSNR "
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

    # MoGe-2 and UniDepth-v2 on their vits backbone at the default token
    # budget, and a narrow DepthPro (ViT width 64, 4 blocks, 192-px crops
    # of a 768 input, the FOV head on), on one 1296x840 image.
    from gs_init_tpu_torch.mdi.predictors.apple_depth_pro import AppleDepthProPredictor
    from gs_init_tpu_torch.mdi.predictors.moge import MoGePredictor
    from gs_init_tpu_torch.mdi.predictors.unidepth import UniDepthPredictor

    img = rng.integers(0, 256, (1, 840, 1296, 3), dtype=np.uint8)
    intr = [CameraIntrinsics(fx=1100.0, fy=1100.0, cx=648.0, cy=420.0)]
    narrow_pro = dict(vit_dim=64, vit_depth=4, vit_heads=4, vit_image_size=192, vit_patch=16, fusion=32,
                      intermediate_hook_ids=(1, 0), intermediate_feature_dims=(32, 32),
                      scaled_images_feature_dims=(64, 64, 32), use_fov=True, input_size=768)
    for label, make, intrinsics in (
        ("moge vits", lambda where: MoGePredictor("vits", allow_random_weights=True, device=where), [None]),
        ("unidepth vits", lambda where: UniDepthPredictor("vits", allow_random_weights=True, device=where), intr),
        ("depth_pro narrow (768 input, FOV head)",
         lambda where: AppleDepthProPredictor(allow_random_weights=True, device=where, **narrow_pro), [None]),
    ):
        t0 = time.perf_counter()
        out = {where: make(where).predict_depth_batch(img, intrinsics)[0] for where in (dev, "cpu")}
        g, w = out[dev], out["cpu"]
        errs = {k: held(f"{label} {k}", getattr(g, k), getattr(w, k), NET_RTOL)
                for k in ("depth", "depth_confidence", "normal") if getattr(w, k) is not None}
        flipped = float(np.mean(g.mask != w.mask))
        if not flipped <= MASK_FLIP_FRACTION:
            raise RuntimeError(f"{label}: the card's mask differs from the CPU's at {flipped:.2e} of the pixels")
        log(f"  {label}, one 1296x840 image, card vs CPU, of each output's max (limit {NET_RTOL:g}): "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f"; mask pixels apart {flipped:.2e} "
            f"(limit {MASK_FLIP_FRACTION:g}); depth range "
            f"{w.depth.min():.4f}..{w.depth.max():.4f}; both built and run in {time.perf_counter() - t0:.3f} s")


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


# ----------------------------------------------------------------- phase 6d


def sam_encoder_flops(img_size: int, dim: int, depth: int, global_attn_indexes, window_size: int = 14) -> int:
    """Multiply-adds x 2 of the encoder's blocks: qkv, proj and the 4x MLP
    (2 N 12 d^2 over the grid's N tokens) and the attention products, the
    relative-position terms included (4 n^2 d per window of n tokens, plus
    2 n d (h + w))."""
    g = img_size // 16
    n_tok = g * g
    total = 0
    for i in range(depth):
        total += 2 * n_tok * 12 * dim * dim
        if i in global_attn_indexes:
            wins, n, side = 1, n_tok, g
        else:
            gp = -(-g // window_size) * window_size
            wins, n, side = (gp // window_size) ** 2, window_size**2, window_size
        total += wins * (4 * n * n * dim + 2 * n * dim * 2 * side)
    return int(total)


def sam_narrow(seed=0):
    from gs_init_tpu_torch.models.common import build
    from gs_init_tpu_torch.models.sam import Sam, init_random_sam_

    return init_random_sam_(build(Sam, img_size=128, dim=64, depth=4, num_heads=4, global_attn_indexes=(1, 3),
                                  window_size=4), seed).eval()


def sam_card_vs_cpu(dev):
    """Phase 6d (1): a narrow SAM (width 64, 4 blocks, 2 of them global,
    window 4, 128 px; the decoder at its published width), the same random
    weights on the card and on the CPU: the image embedding, the prompt
    encoder's outputs and the decoder's masks and IoU predictions, each
    within SAM_RTOL of its max."""
    import torch
    from gs_init_tpu_torch.models.common import full_fp32

    g = torch.Generator().manual_seed(7)
    x = torch.randn(1, 3, 128, 128, generator=g)
    pts = torch.rand(16, 2, 2, generator=g) * 128
    labels = torch.tensor([[1, -1], [1, 0]] * 8)
    outs = {}
    for where in (dev, "cpu"):
        sam = sam_narrow().to(where)
        with torch.inference_mode(), full_fp32():
            embed = sam.image_encoder(x.to(where))
            sparse, no_mask = sam.prompt_encoder(pts.to(where), labels.to(where))
            pe = sam.prompt_encoder.dense_pe()
            masks, iou = sam.mask_decoder(embed, pe, sparse, no_mask)
        outs[where] = [t.cpu().numpy() for t in (embed, sparse, pe, masks, iou)]
    names = ("embedding", "sparse prompt", "dense pe", "masks", "iou")
    errs = {k: held(f"sam narrow {k}", a, b, SAM_RTOL) for k, a, b in zip(names, outs[dev], outs["cpu"])}
    log(f"  sam narrow (64 wide, 4 blocks, 128 px) card vs CPU, of each output's max (limit {SAM_RTOL:g}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))


def sam_full_width(dev, scene):
    """Phase 6d (2, 3): SAM ViT-H at 1024 with random weights: the
    encoder's device time, FLOP rate and peak memory at batch 1, a decoder
    call on 64 point prompts, the top kernels of each; then the automatic
    mask generator on one of the clustered scene's 1296x840 images at its
    default filters and with every mask passing them."""
    import torch
    from gs_init_tpu_torch.mdi.segmentation_sam import SamMaskGenerator
    from gs_init_tpu_torch.models.common import full_fp32

    t0 = time.perf_counter()
    gen = SamMaskGenerator("vit_h", allow_random_weights=True, device=dev)
    torch.cuda.synchronize()
    net = gen.net
    n_params = sum(p.numel() for p in net.parameters())
    log(f"  sam vit_h: {n_params} parameters, built with random weights in {time.perf_counter() - t0:.3f} s")
    size = gen.img_size
    x = torch.randn(1, 3, size, size, device=dev, generator=torch.Generator(dev).manual_seed(0))
    pts = torch.rand(64, 2, 2, device=dev, generator=torch.Generator(dev).manual_seed(1)) * size
    labels = torch.tensor([[1, -1]] * 64, device=dev)
    with torch.inference_mode(), full_fp32():
        embed = net.image_encoder(x)
        pe = net.prompt_encoder.dense_pe()
        sparse, no_mask = net.prompt_encoder(pts, labels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        enc_ms = cuda_ms(lambda: net.image_encoder(x), 3)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        dec_ms = cuda_ms(lambda: net.mask_decoder(embed, pe, sparse, no_mask), 5)
        top_enc = top_kernels(lambda: net.image_encoder(x))
        top_dec = top_kernels(lambda: net.mask_decoder(embed, pe, sparse, no_mask))
    fl = sam_encoder_flops(size, 1280, 32, (7, 15, 23, 31))
    log(f"  sam vit_h encoder, batch 1 at {size}: {enc_ms:.3f} ms (device, CUDA events), {fl / 1e12:.3f} TFLOP "
        f"at {fl / enc_ms / 1e9:.2f} TFLOP/s (FP32 bound {fl / PEAK_FP32_FLOPS * 1e3:.3f} ms), peak memory "
        f"{peak:.3f} GiB above the weights; top kernels: "
        + "; ".join(f"{ms:.3f} ms x{n} {name[:60]}" for ms, n, name in top_enc))
    log(f"  sam decoder, 64 point prompts: {dec_ms:.3f} ms; top kernels: "
        + "; ".join(f"{ms:.3f} ms x{n} {name[:60]}" for ms, n, name in top_dec))
    img = (np.clip(np.asarray(scene.images[0]), 0, 1) * 255).astype(np.uint8)
    for label, kw in (("default filters", {}), ("every mask passing the filters",
                                                 dict(pred_iou_thresh=-np.inf, stability_score_thresh=-np.inf))):
        g = gen if not kw else SamMaskGenerator("vit_h", allow_random_weights=True, device=dev, **kw)
        g.generate(img)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks = g.generate(img)
        sec = time.perf_counter() - t0
        log(f"  mask generator, {label}, one {img.shape[1]}x{img.shape[0]} image: {sec:.3f} s, "
            f"{len(masks)} masks kept (areas {[m['area'] for m in masks][:8]})")
        del g
    del gen, net
    torch.cuda.empty_cache()


# Phase 6d's SAM-segmented init runs on the scene's first SAM_CAMERAS
# cameras (5 training images; the generator takes ~1.7 s an image), so
# that the script with phase 13 keeps within its time.
SAM_CAMERAS = 6


def sam_runner_e2e(dev, scene, data_dir, steps=20):
    """Phase 6d (4): Runner(cfg) with the stub's surface depth aligned per
    SAM region (ViT-H, random weights, segmentation.method="sam") on the
    clustered scene's first SAM_CAMERAS cameras, then 20 train steps with
    one launch of each compositor kernel per step."""
    import torch
    from gs_init_tpu_torch import kernels
    from gs_init_tpu_torch.config import Config
    from gs_init_tpu_torch.datasets.parser import Parser
    from gs_init_tpu_torch.engine.runner import Runner
    from gs_init_tpu_torch.mdi import segmentation_sam

    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config(data_dir=data_dir, data_factor=1, test_every=8, init_type="monocular_depth",
                     result_dir=os.path.join(tmp, "res"), max_steps=steps, eval_steps=[], save_steps=[],
                     tb_every=10**6)
        cfg.mdi.predictor = "stub"
        cfg.mdi.use_cache = False
        seg = cfg.mdi.alignment.segmentation
        seg.method, seg.sam_allow_random_weights = "sam", True
        parser = first_cameras(Parser(data_dir, factor=1, test_every=8), SAM_CAMERAS)
        t0 = time.perf_counter()
        runner = Runner(cfg, parser=parser, mdi_model=surface_depth_stub(scene, parser), device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n0 = int(runner.gstate.alive.sum())
        kernels.reset_launch_counts()
        losses = np.array([float(runner.train_iteration(step)["loss"]) for step in range(steps)])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = {k: kernels.LAUNCHES[k] for k in ("composite_fwd", "composite_bwd")}
        n_img = len(runner.trainset)
        log(f"  Runner(cfg), stub depth with SAM vit_h regions: set-up and init {t1 - t0:.3f} s "
            f"({(t1 - t0) / n_img:.3f} s per image over {n_img}), {n0} gaussians; {steps} steps in "
            f"{t2 - t1:.3f} s, loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches {json.dumps(launches)}")
        segmentation_sam._cached_generator.cache_clear()
        if n0 <= len(parser.points) or not np.isfinite(losses).all():
            raise RuntimeError("the SAM-segmented init gave no depth points or a non-finite loss")
        if launches != dict(composite_fwd=steps, composite_bwd=steps):
            raise RuntimeError("the compositor did not launch once per train step after the SAM init")
        del runner
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 8


def write_lpips_weights(ckpt_dir, seed=0):
    """Random AlexNet convolutions and LPIPS calibration in the npz layout
    of scripts/convert_lpips.py."""
    rng = np.random.default_rng(seed)
    shapes = [(11, 11, 3, 64), (5, 5, 64, 192), (3, 3, 192, 384), (3, 3, 384, 256), (3, 3, 256, 256)]
    out = {}
    for i, sh in enumerate(shapes):
        out[f"conv{i}_w"] = (rng.normal(size=sh) / np.sqrt(np.prod(sh[:3]))).astype(np.float32)
        out[f"conv{i}_b"] = rng.normal(0, 0.05, sh[-1]).astype(np.float32)
        out[f"lin{i}"] = rng.uniform(0, 0.1, sh[-1]).astype(np.float32)
    np.savez(os.path.join(ckpt_dir, "lpips_alex.npz"), **out)


def lpips_card_vs_cpu(dev):
    """Phase 8 (1): LPIPS at 1296x840 on the card against the CPU, and its
    time per eval image, with and without cuDNN."""
    import torch
    from gs_init_tpu_torch.models.common import without_cudnn
    from gs_init_tpu_torch.ops.lpips import lpips

    g = torch.Generator().manual_seed(3)
    a = torch.rand(1, 840, 1296, 3, generator=g)
    b = (a + 0.1 * torch.randn(1, 840, 1296, 3, generator=g)).clamp(0, 1)
    want = float(lpips(a, b))
    ad, bd = a.to(dev), b.to(dev)
    got = float(lpips(ad, bd))
    err = abs(got - want) / abs(want)
    ms = {}
    for _ in range(2):
        ms.setdefault("cudnn", []).append(cuda_ms(lambda: lpips(ad, bd), 10))
        with without_cudnn():
            ms.setdefault("no cudnn", []).append(cuda_ms(lambda: lpips(ad, bd), 10))
    top = top_kernels(lambda: lpips(ad, bd))
    log(f"  lpips at 1296x840: card {got:.7f}, CPU {want:.7f}, |diff| {err:.3e} of the value (limit {LPIPS_RTOL:g}); "
        f"{min(ms['cudnn']):.3f} ms per eval image (device, CUDA events), {min(ms['no cudnn']):.3f} ms without "
        "cuDNN; top kernels: " + "; ".join(f"{t:.3f} ms x{n} {name[:60]}" for t, n, name in top))
    if not err <= LPIPS_RTOL:
        raise RuntimeError("LPIPS on the card disagrees with the CPU")


def sweep_e2e(root, steps=200):
    """Phase 8 (3): a two-run sweep (sh_degree 1 and 3) on phase 5's scene
    through the port's trainer as subprocesses, each run evaluated from its
    saved renders; then the results tables with the TensorBoard columns."""
    from gs_init_tpu_torch.evaluation.sweep import execute_sweep
    from gs_init_tpu_torch.evaluation.tables import collect_results, make_table

    data_root = os.path.join(root, "data")
    phase5_scene(data_root)
    out = os.path.join(root, "sweep")
    extra = ["--data_factor=1", f"--max_steps={steps}", f"--eval_steps=[{steps}]", "--test_every=4",
             "--max_gaussians=4096", "--pair_capacity=262144", "--sh_degree_interval=50", "--tb_every=50",
             "--strategy.refine_start_iter=50", "--strategy.refine_every=100", "--strategy.reset_every=10000"]
    t0 = time.perf_counter()
    runs = execute_sweep(data_root, ["scene"], ["default --sh_degree={1,3}"], out, extra_args=extra, evaluate=True)
    sec = time.perf_counter() - t0
    for r in runs:
        with open(os.path.join(r.out_dir, "stats", "train_final.json")) as f:
            final = json.load(f)
        with open(os.path.join(r.out_dir, f"results-{steps}.json")) as f:
            res = json.load(f)
        n_val = len(res["per_image"])
        launches = final.get("kernel_launches", {})
        log(f"  sweep run {os.path.basename(r.out_dir)}: done {r.done}, launches in its trainer "
            f"{json.dumps(launches)}, evaluate_run over {n_val} saved renders "
            + " ".join(f"{k}={v:.4f}" for k, v in res["metrics"].items()))
        want = dict(composite_fwd=steps + n_val, composite_bwd=steps)
        if not r.done or {k: launches.get(k) for k in want} != want:
            raise RuntimeError(f"sweep run {r.out_dir} failed or did not launch the compositor once per step")
    rows = collect_results(out)
    log(f"  sweep of {len(runs)} runs in {sec:.3f} s; tables:")
    for metric in ("psnr", "lpips", "tb_train/loss", "tb_train/num_GS"):
        for line in make_table(rows, metric).splitlines():
            log(f"    {line}")
    if len(rows) != 2 or any(k not in r for r in rows for k in ("psnr", "lpips", "tb_train/loss")):
        raise RuntimeError("the sweep's table rows miss a run or a column")


def method_e2e(data_dir, result_dir, steps=50):
    """Phase 8 (4): the Method's lifecycle with the appearance embedding:
    setup_train, steps, save, render, optimize_embedding (128 Adam steps
    through the compositor's backward), export_demo; compositor launches
    counted."""
    import torch
    from gs_init_tpu_torch import kernels
    from gs_init_tpu_torch.integration.method import GsInitTpuMethod
    from gs_init_tpu_torch.utils.ply import read_ply_splats

    t0 = time.perf_counter()
    m = GsInitTpuMethod(data_dir=data_dir, config_overrides=dict(
        data_factor=1, result_dir=result_dir, max_steps=steps, test_every=4, max_gaussians=4096,
        pair_capacity=262144, app_opt="true"))
    kernels.reset_launch_counts()
    m.setup_train()
    t1 = time.perf_counter()
    losses = [m.train_iteration(step)["loss"] for step in range(steps)]
    ckpt = m.save(os.path.join(result_dir, "method.npz"))
    item = m.runner.valset[0]
    h, w = item["image"].shape[:2]
    out = m.render(item["camtoworld"], item["K"], w, h)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    emb = m.optimize_embedding(item["image"], item["camtoworld"], item["K"])
    t3 = time.perf_counter()
    n_demo = len(read_ply_splats(m.export_demo(os.path.join(result_dir, "demo.ply"), options=dict(embedding=emb)))[0])
    launches = {k: kernels.LAUNCHES[k] for k in ("composite_fwd", "composite_bwd")}
    n_opt = m.cfg.app_test_opt_steps
    want = dict(composite_fwd=steps + 1 + n_opt, composite_bwd=steps + n_opt)
    log(f"  method: built in {t1 - t0:.3f} s; {steps} steps, save and a {w}x{h} render in {t2 - t1:.3f} s, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; optimize_embedding ({n_opt} Adam steps) {t3 - t2:.3f} s, |embedding| "
        f"{float(np.linalg.norm(emb)):.4f}; demo PLY {n_demo} splats; launches {json.dumps(launches)} "
        f"(want {json.dumps(want)})")
    if not (np.isfinite(losses).all() and np.isfinite(emb).all() and np.isfinite(out["color"]).all()
            and os.path.exists(ckpt) and n_demo == int(m.runner.gstate.alive.sum())):
        raise RuntimeError("the Method's lifecycle gave a non-finite value or lost its outputs")
    if launches != want:
        raise RuntimeError("the Method's paths did not launch the compositor as counted")


def viewer_e2e(data_dir, result_dir, steps=300):
    """Phase 8 (5): the live viewer on an ephemeral port while the Runner
    trains on a thread: /status and 640x480 /render requests during
    training, then a /render equal to Runner.render at the same camera."""
    import threading
    import urllib.request

    from gs_init_tpu_torch import kernels
    from gs_init_tpu_torch.config import Config
    from gs_init_tpu_torch.datasets.png import decode_png
    from gs_init_tpu_torch.engine.runner import Runner

    cfg = Config(data_dir=data_dir, data_factor=1, result_dir=result_dir, max_steps=steps, eval_steps=[],
                 save_steps=[], test_every=4, max_gaussians=4096, pair_capacity=1 << 18, tb_every=100,
                 disable_viewer=False, port=0)
    runner = Runner(cfg)
    port = runner.start_viewer()
    get = lambda path: urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60).read()
    failure = []

    def train():
        try:
            runner.train()
        except Exception as e:  # reported by the main thread
            failure.append(e)

    kernels.reset_launch_counts()
    th = threading.Thread(target=train)
    th.start()
    steps_seen, render_s, n_render = [], [], 0
    try:
        while th.is_alive():
            steps_seen.append(json.loads(get("/status"))["step"])
            t0 = time.perf_counter()
            img = decode_png(get(f"/render?yaw={0.1 * n_render:.2f}&pitch=0.2&w=640&h=480"))
            render_s.append(time.perf_counter() - t0)
            n_render += 1
            if img.shape != (480, 640, 3):
                raise RuntimeError(f"viewer render of shape {img.shape}")
        th.join()
        if failure:
            raise failure[0]
        body = get("/render?yaw=0.3&pitch=0.2&radius=1.1&w=640&h=480")
        c2w, K = runner.viewer.camera(0.3, 0.2, 1.1, 640, 480)
        color, _, _ = runner.render(c2w, K, 640, 480, render_mode="RGB")
        same = np.array_equal(decode_png(body), (np.clip(color, 0, 1) * 255).astype(np.uint8))
        status = json.loads(get("/status"))
    finally:
        th.join()
        runner.viewer.stop()
    launches = {k: kernels.LAUNCHES[k] for k in ("composite_fwd", "composite_bwd")}
    want = dict(composite_fwd=steps + len(runner.valset) + n_render + 2, composite_bwd=steps)
    log(f"  viewer: {n_render} /render (640x480 PNG, median {np.median(render_s) * 1e3:.1f} ms round trip) and "
        f"/status answered during {steps} train steps (steps seen {steps_seen[:1]}..{steps_seen[-1:]}); final "
        f"/render equal to Runner.render: {same}; /status after training {json.dumps(status)}; launches "
        f"{json.dumps(launches)} (want {json.dumps(want)})")
    if not same or status["step"] != steps - 1 or n_render == 0:
        raise RuntimeError("the viewer's render or status disagrees with the Runner")
    if launches != want:
        raise RuntimeError("the viewer's and the training's launches do not add up")


# ------------------------------------------------------------------ phase 9
# Multi-GPU. The card's machine has one H100: (a) runs a one-rank NCCL group
# on it; (b) and (c) run several ranks that share cuda:0 over gloo (NCCL
# refuses two ranks of one communicator on one device). Their times are
# shared-card figures: they show the sharded paths running on the card at
# full width, not scaling.

# (a) One rank's sharded and band steps against make_train_step from the
# same state: K2's float atomics order each gaussian's sums, so gradients
# agree to rounding and Adam turns a sign flip of a near-zero gradient into
# up to 2 lr. Loss, first moments and grad2d within MESH1_RTOL of each
# leaf's max |value|; each parameter within MESH1_RTOL of its leaf's max
# plus lr x min(2, 2 MESH1_RTOL max|g| / |g|), g the reference gradient
# (the bound of tests/test_torch_train_step.py).
MESH1_RTOL = 1e-6
# (b) Ranks sharing cuda:0, at the JAX mesh tests' 1e-5 (tests/test_
# parallel.py:125, restated relative to each leaf's max). Where cameras or
# bands split, each gaussian's gradient is summed in another order (one
# sum per camera or band, then the sum over "data"), and gradients that
# are sums of large cancelling terms move by more than 1e-5 of their
# leaf's max. So each mesh is held to its witness, the same split computed
# by one-rank steps in one process (``witnesses``): first moments and
# grad2d within MESHN_RTOL of each leaf's max. Against the one-rank step:
# the loss within MESHN_RTOL relative, and the parameters by the Adam
# bound at MESHN_RTOL plus the witness's own gap to that step. The 1x2
# mesh splits no sum: its witness is the one-rank step itself.
MESHN_RTOL = 1e-5
# (c) The trainer's loss at every step before the first refine (step 100)
# against the one-rank run: over the first CURVE_STEPS steps within
# CURVE_RTOL (tests/test_band_shard.py:172-174 holds 12); to step 99
# within PRE_REFINE_RTOL. Adam turns the split's rounding into whole steps
# of near-zero gradients, and the gap grows with the steps: at every 4th
# step to 96 it reached 8.4e-4 and 3.2e-4 in two runs of this phase
# (NVIDIA H100 80GB HBM3, 700 W); PRE_REFINE_RTOL is 2.4x the larger.
CURVE_RTOL = 1e-4
CURVE_STEPS = 12
PRE_REFINE_RTOL = 2e-3
# (d) Descriptors and image filters on the card against the CPU, within
# LEFTOVER_RTOL of each output's max |value| (f32 sums in other orders).
LEFTOVER_RTOL = 1e-5
MESHES_9B = (  # (name, n_data, n_gauss, bands, batch, witness)
    ("2x1 cameras", 2, 1, False, 2, "cameras"), ("1x2 gaussians", 1, 2, False, 1, None),
    ("2x2", 2, 2, False, 2, "cameras"), ("2x1 bands", 2, 1, True, 1, "bands"),
    ("2x2 bands", 2, 2, True, 1, "bands"),
)


def free_port():
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def mesh_scenario(dev, path, n=300_000, cap=393_216, width=1296, height=840, step=5):
    """Phase 9's scenario: phase 3's flagship cloud and kNN init with
    anisotropic scales (as phase 2's step: every quaternion gets a real
    gradient), two cameras with random targets, step 5. Writes the initial
    state, the batch, the configuration and the one-rank step's results at
    batch 2 and 1 (make_train_step on the card) to `path` (npz)."""
    import torch
    from gs_init_tpu_torch.datasets.synthetic import look_at
    from gs_init_tpu_torch.device import generator
    from gs_init_tpu_torch.engine.params import PARAM_NAMES, init_from_points
    from gs_init_tpu_torch.engine.runner import snug_pair_capacity

    rng = np.random.default_rng(0)
    pts = np.stack(
        [rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(-1, 6, n)], -1
    ).astype(np.float32)
    rgbs = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    g = init_from_points(torch.as_tensor(pts, device=dev), torch.as_tensor(rgbs, device=dev), cap, 3,
                         generator=generator(0, dev))
    data = {f"params/{k}": getattr(g.params, k).cpu().numpy() for k in PARAM_NAMES}
    data["params/scales"] = data["params/scales"] + rng.normal(0, 0.3, (cap, 3)).astype(np.float32)
    data["alive"] = g.alive.cpu().numpy()
    f = 0.85 * width
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32)
    data["camtoworlds"] = np.stack([look_at(np.array(e), np.zeros(3)) for e in
                                    ([0.0, 0.0, -8.0], [1.5, 0.5, -7.5])]).astype(np.float32)
    data["Ks"] = np.stack([K, K])
    data["pixels"] = rng.uniform(0, 1, (2, height, width, 3)).astype(np.float32)
    data["image_ids"] = np.arange(2)
    data["meta"] = np.array([width, height, step, cap])
    data["pair_capacity"] = np.array(1 << 22)
    m = mesh_reference(data, dev, batch=2, quiet=True)
    data["pair_capacity"] = np.array(snug_pair_capacity(int(m["pairs"]) + int(m["overflow"])))
    for b in (2, 1):
        for k, v in mesh_reference(data, dev, batch=b).items():
            data[f"ref{b}/{k}"] = v
    np.savez(path, **data)
    return data


def mesh_config(data):
    from gs_init_tpu_torch.trainer import build_presets

    cfg = build_presets()["default"]
    cfg.max_steps, cfg.max_gaussians = 30_000, int(data["meta"][3])
    cfg.pair_capacity = int(data["pair_capacity"])
    return cfg


def mesh_inputs(data, dev, batch):
    """State, Adam, statistics and the first `batch` cameras on `dev`."""
    import torch
    from gs_init_tpu_torch.engine import optim
    from gs_init_tpu_torch.engine.params import PARAM_NAMES, state_from_numpy
    from gs_init_tpu_torch.engine.strategy import default as dstrat
    from gs_init_tpu_torch.engine.train_step import Batch

    g = state_from_numpy({k: data[f"params/{k}"] for k in PARAM_NAMES}, data["alive"], dev)
    T = lambda k: torch.as_tensor(data[k][:batch], device=dev)
    b = Batch(camtoworlds=T("camtoworlds"), Ks=T("Ks"), pixels=T("pixels"), image_ids=T("image_ids").long())
    return g, optim.init_adam_state(g.params), dstrat.init_state(g.alive.shape[0], dev), b


def step_outputs(g, a, s, m):
    from gs_init_tpu_torch.engine.params import PARAM_NAMES

    n = lambda x: x.detach().cpu().numpy()
    out = {f"params/{k}": n(getattr(g.params, k)) for k in PARAM_NAMES}
    out.update({f"mu/{k}": n(getattr(a.mu, k)) for k in PARAM_NAMES})
    out.update(grad2d=n(s.grad2d), loss=n(m["loss"]), pairs=n(m["pairs"]), overflow=n(m["overflow"]))
    return out


def mesh_reference(data, dev, batch, quiet=False, rows=None):
    """make_train_step once on the card from the scenario's state (its
    first `batch` cameras). With `rows`, a slice of image rows, the
    sampling mask lets only those pixels pass a gradient, and the result
    also holds the screen-space gradients that the step hands the
    statistics ("stats") and the radii, as tensors."""
    import torch
    from gs_init_tpu_torch.engine import optim
    from gs_init_tpu_torch.engine.params import AuxParams
    from gs_init_tpu_torch.engine.strategy import default as dstrat
    from gs_init_tpu_torch.engine.train_step import init_aux_opt, make_train_step

    width, height, step, _ = (int(x) for x in data["meta"])
    cfg = mesh_config(data)
    g, a, s, b = mesh_inputs(data, dev, batch)
    seen, update = {}, dstrat.update_state
    if rows is not None:
        b.sampling_mask = torch.zeros(b.pixels.shape[:3] + (1,), device=dev)
        b.sampling_mask[:, rows] = 1.0

        def tap(st, grads, radii, w, h):
            seen.update(stats=grads.detach().clone(), radii=radii.clone())
            return update(st, grads, radii, w, h)

        dstrat.update_state = tap
    try:
        g, a, s, _, _, m = make_train_step(cfg, optim.make_adam_config(cfg, 4.0), width, height)(
            g, a, s, AuxParams(), init_aux_opt(AuxParams()), b, step
        )
    finally:
        dstrat.update_state = update
    if not quiet and int(m["overflow"]):
        raise RuntimeError("phase 9: the reference step overflowed its pair table")
    return {**step_outputs(g, a, s, m), **seen}


def leaf_rel(a, b):
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def moment_errors(got, want):
    """Max error / leaf max of the first moments (worst leaf) and grad2d."""
    from gs_init_tpu_torch.engine.params import PARAM_NAMES

    return dict(mu=max(leaf_rel(got[f"mu/{k}"], want[f"mu/{k}"]) for k in PARAM_NAMES),
                grad2d=leaf_rel(got["grad2d"], want["grad2d"]))


def mesh_errors(got, ref, rtol):
    """Max error / leaf max of the loss, first moments, grad2d and the
    parameters (raw), and the parameters' worst excess over the Adam
    bound at `rtol` (<= 0 holds)."""
    from gs_init_tpu_torch.engine import optim
    from gs_init_tpu_torch.engine.params import PARAM_NAMES

    cfg = mesh_config({k: ref[k] for k in ("meta", "pair_capacity")})
    acfg = optim.make_adam_config(cfg, 4.0)
    step = int(ref["meta"][2])
    err = dict(loss=leaf_rel(got["loss"], ref["loss"]), **moment_errors(got, ref),
               params=max(leaf_rel(got[f"params/{k}"], ref[f"params/{k}"]) for k in PARAM_NAMES))
    excess = 0.0
    for k in PARAM_NAMES:
        lr = acfg.lrs[k] * (acfg.means_decay_gamma ** step if k == "means" else 1.0)
        p = ref[f"params/{k}"]
        gabs = np.abs(ref[f"mu/{k}"]) / (1 - acfg.b1)
        allowed = rtol * np.abs(p).max() + lr * np.minimum(2.0, 2 * rtol * gabs.max() / np.maximum(gabs, 1e-30))
        excess = max(excess, float((np.abs(got[f"params/{k}"] - p) - allowed).max()))
    err["adam_excess"] = excess
    return err


def mesh_ok(err, rtol):
    return max(err["loss"], err["mu"], err["grad2d"]) <= rtol and err["adam_excess"] <= 0.0


def witnesses(dev, data, path, two_bands):
    """Each split of phase 9 (b) computed by one-rank steps on the card in
    one process, added to the scenario's npz at `path`. "cameras": the
    two cameras' batch-1 steps, first moments averaged and grad2d summed
    (the batch-2 step's sums split by camera, as the data axis splits
    them). "bands": `two_bands`, the band step on a one-rank mesh with two
    bands a rank (the 2x1 band mesh's arithmetic: its band frames and its
    split sums). Logs each witness's gap to the one-rank step (first
    moments and grad2d, of each leaf's max), and the band split's alone:
    two batch-1 steps whose sampling masks each pass the gradient of one
    band's rows, first moments summed, grad2d from the sum of their
    screen-space gradients."""
    from gs_init_tpu_torch.engine.params import PARAM_NAMES
    from gs_init_tpu_torch.engine.strategy import default as dstrat
    from gs_init_tpu_torch.parallel.shard import band_height

    width, height, _, cap = (int(x) for x in data["meta"])
    cam1 = dict(data)
    for k in ("camtoworlds", "Ks", "pixels", "image_ids"):
        cam1[k] = data[k][1:]
    one = mesh_reference(cam1, dev, 1)
    wit = {"cameras": {f"mu/{k}": (data[f"ref1/mu/{k}"] + one[f"mu/{k}"]) / 2 for k in PARAM_NAMES}}
    wit["cameras"]["grad2d"] = data["ref1/grad2d"] + one["grad2d"]
    wit["bands"] = {k: v for k, v in two_bands.items() if k.startswith("mu/") or k == "grad2d"}
    band_h = band_height(height, mesh_config(data).tile_size, 2)
    halves = [mesh_reference(data, dev, 1, rows=slice(i * band_h, (i + 1) * band_h)) for i in range(2)]
    split = {f"mu/{k}": halves[0][f"mu/{k}"] + halves[1][f"mu/{k}"] for k in PARAM_NAMES}
    st = dstrat.update_state(dstrat.init_state(cap, dev), halves[0]["stats"] + halves[1]["stats"],
                             halves[0]["radii"], width, height)
    split["grad2d"] = st.grad2d.cpu().numpy()
    gap = moment_errors(split, {k[5:]: v for k, v in data.items() if k.startswith("ref1/")})
    log(f"  the band split alone (masked halves) against the one-rank batch-1 step: first moments "
        f"{gap['mu']:.3e}, grad2d {gap['grad2d']:.3e} of each leaf's max")
    for kind, batch in (("cameras", 2), ("bands", 1)):
        ref = {k[5:]: v for k, v in data.items() if k.startswith(f"ref{batch}/")}
        gap = moment_errors(wit[kind], ref)
        log(f"  witness {kind} against the one-rank batch-{batch} step: first moments {gap['mu']:.3e}, grad2d "
            f"{gap['grad2d']:.3e} of each leaf's max")
        data.update({f"wit_{kind}/{k}": v for k, v in wit[kind].items()})
        data[f"wit_{kind}/gap"] = np.array(max(gap.values()))
    np.savez(path, **data)


def one_rank_nccl(dev, data, timed=10):
    """Phase 9 (a): a one-rank NCCL group on the card; the sharded and band
    steps on mesh 1x1 against make_train_step, then each timed. Returns
    the outputs of one band step with two bands on the one rank (the band
    witness of (b))."""
    import torch
    import torch.distributed as dist
    from gs_init_tpu_torch import kernels
    from gs_init_tpu_torch.engine import optim
    from gs_init_tpu_torch.engine.params import AuxParams
    from gs_init_tpu_torch.engine.train_step import init_aux_opt, make_train_step
    from gs_init_tpu_torch.parallel import shard

    width, height, step, _ = (int(x) for x in data["meta"])
    cfg = mesh_config(data)
    acfg = optim.make_adam_config(cfg, 4.0)
    ref = {k[5:]: v for k, v in data.items() if k.startswith("ref1/")}
    ref.update(meta=data["meta"], pair_capacity=data["pair_capacity"])
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0,
                            device_id=dev)
    try:
        mesh = shard.make_mesh(1, 1)
        makers = dict(plain=lambda: make_train_step(cfg, acfg, width, height),
                      sharded=lambda: shard.make_sharded_train_step(cfg, acfg, width, height, mesh),
                      band=lambda: shard.make_band_sharded_train_step(cfg, acfg, width, height, mesh))
        times = {}
        for name, make in makers.items():
            fn = make()
            g, a, s, b = mesh_inputs(data, dev, 1)
            kernels.reset_launch_counts()
            g, a, s, aux, aux_opt, m = fn(g, a, s, AuxParams(), init_aux_opt(AuxParams()), b, step)
            torch.cuda.synchronize()
            launches = {k: kernels.LAUNCHES[k] for k in ("composite_fwd", "composite_bwd")}
            if name != "plain":
                err = mesh_errors(step_outputs(g, a, s, m), ref, MESH1_RTOL)
                log(f"  (a) {name} step on a one-rank NCCL group (mesh 1x1) vs make_train_step: loss "
                    f"{err['loss']:.3e}, first moments {err['mu']:.3e}, grad2d {err['grad2d']:.3e} of each leaf's "
                    f"max (tol {MESH1_RTOL:g}); parameters {err['params']:.3e} raw, Adam-bound excess "
                    f"{err['adam_excess']:.3e} (<= 0); launches {json.dumps(launches)}")
                if not mesh_ok(err, MESH1_RTOL):
                    raise RuntimeError(f"phase 9 (a): the one-rank {name} step disagrees with make_train_step")
            if launches != dict(composite_fwd=1, composite_bwd=1):
                raise RuntimeError(f"phase 9 (a): {name} step launched {launches}, not one K1 and one K2")
            ms = []
            for i in range(timed + 2):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                g, a, s, aux, aux_opt, m = fn(g, a, s, aux, aux_opt, b, step + 1 + i)
                ev[1].record()
                ms.append(ev)
            torch.cuda.synchronize()
            times[name] = float(np.median([e[0].elapsed_time(e[1]) for e in ms[2:]]))
        log(f"  (a) step ms (CUDA events, median of {timed} after 2): plain {times['plain']:.3f}, one-rank "
            f"sharded {times['sharded']:.3f}, one-rank band {times['band']:.3f}")
        g, a, s, b = mesh_inputs(data, dev, 1)  # the band witness: two bands on this one rank
        fn = shard.make_band_sharded_train_step(cfg, acfg, width, height, mesh, bands_per_rank=2)
        g, a, s, _, _, m = fn(g, a, s, AuxParams(), init_aux_opt(AuxParams()), b, step)
        two_bands = step_outputs(g, a, s, m)
    finally:
        dist.destroy_process_group()
    return two_bands


def shared_card_rank(rank, world, port, path, q):
    """Phase 9 (b) worker: one rank of `world` sharing cuda:0 over gloo;
    each mesh of MESHES_9B from the scenario's state (its ranks are 0..d*g-1),
    one step compared (rank 0: against the one-rank step and the witness)
    and one more timed."""
    import torch
    import torch.distributed as dist
    from gs_init_tpu_torch import kernels
    from gs_init_tpu_torch.engine import optim
    from gs_init_tpu_torch.engine.params import AuxParams
    from gs_init_tpu_torch.engine.train_step import init_aux_opt
    from gs_init_tpu_torch.ops import rasterize as prast
    from gs_init_tpu_torch.parallel import shard

    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
        data = dict(np.load(path))
        width, height, step, _ = (int(x) for x in data["meta"])
        cfg = mesh_config(data)
        acfg = optim.make_adam_config(cfg, 4.0)
        out = []
        for name, d, gg, bands, batch, kind in MESHES_9B:
            mesh = shard.make_mesh(d, gg)
            dist.barrier()
            if not mesh.member:
                out.append(None)
                continue
            make = shard.make_band_sharded_train_step if bands else shard.make_sharded_train_step
            fn = make(cfg, acfg, width, height, mesh)
            g, a, s, b = mesh_inputs(data, dev, batch)
            g, a, s = shard.local_state(g, a, s, mesh)
            if not bands:
                b = shard.local_batch(b, mesh)
            torch.cuda.reset_peak_memory_stats(dev)
            kernels.reset_launch_counts()
            g, a, s, aux, aux_opt, m = fn(g, a, s, AuxParams(), init_aux_opt(AuxParams()), b, step)
            launches = {k: kernels.LAUNCHES[k] for k in ("composite_fwd", "composite_bwd")}
            res = dict(launches=launches, pairs=int(m["pairs"]), overflow=int(m["overflow"]))
            whole = shard.global_state(g, a, s, mesh)
            if rank == 0:
                got = step_outputs(*whole, m)
                ref = {k[5:]: v for k, v in data.items() if k.startswith(f"ref{batch}/")}
                ref.update(meta=data["meta"], pair_capacity=data["pair_capacity"])
                wkey = f"wit_{kind}/" if kind else f"ref{batch}/"
                wit = {k[len(wkey):]: v for k, v in data.items() if k.startswith(wkey)}
                gap = float(wit.get("gap", 0.0))
                res.update(err=mesh_errors(got, ref, MESHN_RTOL + gap), wit=moment_errors(got, wit), gap=gap)
            del whole
            # One more step, timed at its marks, its compositor inputs kept.
            ev = {}
            seen = {}
            fwd = prast.composite_fwd

            def rec_fwd(*args):
                seen["args"] = tuple(x.detach() if hasattr(x, "detach") else x for x in args[:8])
                seen["out"] = fwd(*args)
                return seen["out"]

            def mark(k):
                ev[k] = torch.cuda.Event(enable_timing=True)
                ev[k].record()

            prast.composite_fwd = rec_fwd
            torch.cuda.synchronize()
            dist.barrier(group=mesh.world)  # rank 0's comparison is not in the timed step
            try:
                mark("start")
                g, a, s, aux, aux_opt, m = fn(g, a, s, aux, aux_opt, b, step + 1, mark=mark)
                mark("end")
            finally:
                prast.composite_fwd = fwd
            res["launches2"] = {k: kernels.LAUNCHES[k] - res["launches"][k] for k in res["launches"]}
            torch.cuda.synchronize()
            names = list(ev)
            phase = {k2: ev[k1].elapsed_time(ev[k2]) for k1, k2 in zip(names, names[1:])}
            res.update(step_ms=ev["start"].elapsed_time(ev["end"]), gather_ms=phase["gather"],
                       band_gather_ms=phase["render"] if bands else 0.0, reduce_ms=phase["reduce"],
                       peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
            res["outside"] = work(seen["args"], seen["out"])["outside"] if bands else None
            out.append(res)
            del g, a, s, b, seen
            torch.cuda.empty_cache()
        dist.barrier()
        dist.destroy_process_group()
        q.put((rank, "ok", out))
    except BaseException:
        import traceback

        q.put((rank, "error", traceback.format_exc()))


def spawn_ranks(target, world, *args, timeout=900):
    """Run target(rank, world, port, *args, queue) in `world` spawned
    processes; returns their results by rank, raising a rank's error."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=target, args=(r, world, port) + args + (q,)) for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:
            rank, status, out = q.get(timeout=timeout)
            if status != "ok":
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    return [results[r] for r in range(world)]


def shared_card(path):
    """Phase 9 (b): four ranks sharing cuda:0 over gloo, each mesh of
    MESHES_9B at the flagship against the one-rank step and its witness."""
    t0 = time.perf_counter()
    ranks = spawn_ranks(shared_card_rank, 4, path)
    log(f"  (b) four ranks on cuda:0 over gloo, {time.perf_counter() - t0:.1f} s with start-up; per-rank "
        f"times are shared-card figures (every rank on one H100), not scaling")
    failures = []
    one = dict(composite_fwd=1, composite_bwd=1)
    for i, (name, d, g, bands, batch, kind) in enumerate(MESHES_9B):
        per = [r[i] for r in ranks[: d * g]]
        err, wit, gap = per[0]["err"], per[0]["wit"], per[0]["gap"]
        log(f"  (b) {name} (batch {batch}): against the witness ({kind or 'the one-rank step'}): first moments "
            f"{wit['mu']:.3e}, grad2d {wit['grad2d']:.3e} of each leaf's max (tol {MESHN_RTOL:g}); against the "
            f"one-rank step: loss {err['loss']:.3e} (tol {MESHN_RTOL:g}), first moments {err['mu']:.3e}, grad2d "
            f"{err['grad2d']:.3e} (the witness's own gap {gap:.3e}), parameters {err['params']:.3e} raw, Adam-bound "
            f"excess at {MESHN_RTOL + gap:.3e} {err['adam_excess']:.3e} (<= 0); worst shard {per[0]['pairs']} pairs")
        if max(wit.values()) > MESHN_RTOL or err["loss"] > MESHN_RTOL or err["adam_excess"] > 0.0:
            failures.append(f"{name}: the sharded step disagrees with the one-rank step or its witness")
        for r, res in enumerate(per):
            times = (f"step {res['step_ms']:.3f} ms, all-gather {res['gather_ms']:.3f} ms"
                     + (f", band gather {res['band_gather_ms']:.3f} ms" if bands else "")
                     + f", gradient all-reduce {res['reduce_ms']:.3f} ms, peak {res['peak_gib']:.3f} GiB; ")
            log(f"      rank {r}: {times}launches {json.dumps(res['launches'])} and {json.dumps(res['launches2'])}"
                + (f"; pair-pixels outside the pair bounds {res['outside']} (must be 0)" if bands else ""))
            if res["launches"] != one or res["launches2"] != one:
                failures.append(f"{name}: rank {r} launched {res['launches']}, {res['launches2']} per step")
            if bands and res["outside"]:
                failures.append(f"{name}: {res['outside']} pair-pixels outside the pair bounds on rank {r}")
            if res["overflow"]:
                failures.append(f"{name}: rank {r}'s pair table overflowed")
    if failures:
        raise RuntimeError("phase 9 (b): " + "; ".join(failures))
    return ranks


def trainer_rank(rank, world, port, argvs, q):
    """Phase 9 (c) worker: trainer.main on cuda:0 for each argv, in a
    two-process launch under the JAX trainer's environment over gloo (the
    ranks share the card; the process group forms at the first run), each
    run followed by a sharded checkpoint of its final state."""
    try:
        import torch
        import torch.distributed as dist
        from gs_init_tpu_torch import kernels, trainer
        from gs_init_tpu_torch.engine import ckpt

        os.environ.update(COORDINATOR_ADDRESS=f"localhost:{port}", JAX_NUM_PROCESSES=str(world),
                          JAX_PROCESS_ID=str(rank), LOCAL_RANK="0")
        out = []
        for argv in argvs:
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):  # the step lines
                runner = trainer.main(argv, device="cuda:0", backend="gloo")
            secs = time.perf_counter() - t0
            launches = {k: kernels.LAUNCHES[k] for k in ("composite_fwd", "composite_bwd")}
            sharded = ckpt.save_sharded(runner, runner.cfg.max_steps)
            peak = torch.cuda.max_memory_allocated() / 2**30
            out.append(dict(secs=secs, launches=launches, mesh=runner.mesh.shape, n_val=len(runner.valset),
                            peak_gib=peak, sharded=sharded))
            del runner
        dist.destroy_process_group()
        q.put((rank, "ok", out))
    except BaseException:
        import traceback

        q.put((rank, "error", traceback.format_exc()))


def trainer_on_mesh(steps=150, width=648, height=420):
    """Phase 9 (c): trainer.main in two ranks on phase 5's scene, 2x1
    cameras (batch 2) and 2x1 bands (batch 1), each beside the one-rank
    run; rank 0's npz restarts eval-only on one device; the sharded
    checkpoint restores onto one rank."""
    import torch
    from gs_init_tpu_torch import trainer
    from gs_init_tpu_torch.config import parse_cli
    from gs_init_tpu_torch.engine import ckpt
    from gs_init_tpu_torch.engine.runner import Runner
    from gs_init_tpu_torch.utils.tb import read_scalars

    failures = []
    device = "cuda:0"
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = phase5_scene(tmp, width, height)
        common = ["default", f"--data_dir={data_dir}", "--data_factor=1", f"--max_steps={steps}",
                  f"--eval_steps=[{steps}]", f"--save_steps=[{steps}]", "--test_every=4",
                  "--max_gaussians=4096", "--pair_capacity=262144", "--sh_degree_interval=100",
                  "--tb_every=1", "--strategy.refine_start_iter=50", "--strategy.refine_every=100",
                  "--strategy.reset_every=10000"]
        runs = (("cameras", ["--batch_size=2"]), ("bands", ["--batch_size=1", "--shard_pixels"]))
        t0 = time.perf_counter()
        ranks = spawn_ranks(trainer_rank, 2, [common + extra + [f"--result_dir={os.path.join(tmp, tag)}",
                                                                 "--mesh=2x1"] for tag, extra in runs])
        log(f"  (c) the two-process launch (both runs) took {time.perf_counter() - t0:.1f} s with start-up")
        for i, (tag, extra) in enumerate(runs):
            res = os.path.join(tmp, tag)
            per = [r[i] for r in ranks]
            one_argv = common + [a for a in extra if a != "--shard_pixels"] + [f"--result_dir={res}_one",
                                                                                "--mesh=off"]
            psnr0 = Runner(parse_cli(one_argv, trainer.build_presets()), device=device).eval(0)["psnr"]
            t1 = time.perf_counter()
            with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
                one = trainer.main(one_argv, device=device)
            t2 = time.perf_counter()
            stats = lambda d: json.load(open(os.path.join(d, "stats", f"val_step{steps}.json")))
            psnr_mesh, psnr_one = stats(res)["psnr"], stats(f"{res}_one")["psnr"]
            curve = dict(read_scalars(os.path.join(res, "tb"))["train/loss"])
            curve_one = dict(read_scalars(os.path.join(f"{res}_one", "tb"))["train/loss"])
            rel_gap = lambda steps_: max(abs(curve[s] - curve_one[s]) / abs(curve_one[s]) for s in steps_)
            gap = rel_gap(range(CURVE_STEPS))
            gap_before = rel_gap(range(100))  # the first refine is at step 100
            with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
                restart = trainer.main(["default", f"--data_dir={data_dir}", "--data_factor=1",
                                        f"--result_dir={res}_restart", "--test_every=4", "--max_gaussians=4096",
                                        "--pair_capacity=262144", "--mesh=off",
                                        f"--ckpt=[{os.path.join(res, 'ckpts', f'ckpt_{steps}.npz')}]"],
                                       device=device)
            psnr_re = stats(f"{res}_restart")["psnr"]
            r1 = Runner(parse_cli(one_argv[:-2] + [f"--result_dir={res}_sharded", "--mesh=off"],
                                  trainer.build_presets()), device=device)
            at = ckpt.load_sharded(r1, per[0]["sharded"])
            r2 = Runner(parse_cli(one_argv[:-2] + [f"--result_dir={res}_npz", "--mesh=off"],
                                  trainer.build_presets()), device=device)
            r2.load(os.path.join(res, "ckpts", f"ckpt_{steps}.npz"))
            mism = [k for k, (x, y) in runner_arrays(r1, r2).items() if not torch.equal(x, y)]
            n_val = per[0]["n_val"]
            log(f"  (c) trainer.main, 2x1 {tag} (two ranks on one card over gloo; shared-card figures): {steps} "
                f"steps in {per[0]['secs']:.3f} s on rank 0 vs one rank {t2 - t1:.3f} s; eval PSNR {psnr0:.4f} -> "
                f"{psnr_mesh:.4f} (one rank {psnr_one:.4f}); loss max rel gap to the one-rank run over steps 0-"
                f"{CURVE_STEPS - 1} {gap:.3e} (tol {CURVE_RTOL:g}), over steps 0-99 (the first refine is at 100) "
                f"{gap_before:.3e} (tol {PRE_REFINE_RTOL:g}); launches per rank {[r['launches'] for r in per]}; peak per rank "
                f"{[round(r['peak_gib'], 3) for r in per]} GiB; eval-only restart of rank 0's npz on one "
                f"device PSNR {psnr_re:.6f} (|diff| {abs(psnr_re - psnr_mesh):.2e}); sharded checkpoint "
                f"(step {at}) onto one rank: {len(mism)} arrays differ from the npz")
            # K1 once per step and per eval render; a band's pair capacity
            # is sized for a band, so a full-image eval render may grow its
            # table once and render again (Runner.render).
            fwd = [r["launches"]["composite_fwd"] - steps - n_val for r in per]
            launch_ok = all(r["launches"]["composite_bwd"] == steps for r in per) and all(
                0 <= k <= (n_val if tag == "bands" else 0) for k in fwd)
            failures += [f"{tag}: {what}" for bad, what in (
                (not psnr_mesh > psnr0, "eval PSNR did not rise"),
                (gap > CURVE_RTOL or gap_before > PRE_REFINE_RTOL, "the loss curve left the one-rank run's"),
                (abs(psnr_re - psnr_mesh) > 1e-6, "the eval-only restart did not reproduce the PSNR"),
                (bool(mism) or at != steps, f"the sharded checkpoint restored {mism} unequal"),
                (not launch_ok, f"launches per rank {[r['launches'] for r in per]}"),
            ) if bad]
            del one, restart, r1, r2
    if failures:
        raise RuntimeError("phase 9 (c): " + "; ".join(failures))


def runner_arrays(r1, r2):
    """{name: (r1's tensor, r2's)} over two Runners' whole state."""
    from gs_init_tpu_torch.engine.params import PARAM_NAMES, aux_leaves

    out = {"alive": (r1.gstate.alive, r2.gstate.alive)}
    for k in PARAM_NAMES:
        out[f"params/{k}"] = (getattr(r1.gstate.params, k), getattr(r2.gstate.params, k))
        out[f"mu/{k}"] = (getattr(r1.adam.mu, k), getattr(r2.adam.mu, k))
        out[f"nu/{k}"] = (getattr(r1.adam.nu, k), getattr(r2.adam.nu, k))
    for k in ("grad2d", "count", "radii_max"):
        out[f"strategy/{k}"] = (getattr(r1.sstate, k), getattr(r2.sstate, k))
    for i, (x, y) in enumerate(zip(aux_leaves(r1.aux), aux_leaves(r2.aux))):
        out[f"aux/{i}"] = (x, y)
    return out


def leftovers_card_vs_cpu(dev, image):
    """Phase 9 (d): SIFT descriptors (every 20th pixel) and the image
    filters on a 1296x840 image, card against CPU."""
    import torch
    from gs_init_tpu_torch.mdi.descriptors import prepare_descriptors
    from gs_init_tpu_torch.utils import image_filtering as F

    h, w = image.shape[:2]
    mask = np.zeros((h, w), bool)
    mask[::20, ::20] = True
    rel = lambda a, b: float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))
    t0 = time.perf_counter()
    d_gpu, g_gpu = prepare_descriptors(torch.as_tensor(image, device=dev), mask)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    d_cpu, g_cpu = prepare_descriptors(image, mask)
    t2 = time.perf_counter()
    errs = {"descriptors": rel(d_gpu, d_cpu)}
    gray = torch.as_tensor(image.mean(-1))
    for name, fn in (("gaussian 1.0", lambda x: F.gaussian_filter2d(x, 1.0)),
                     ("gaussian 2.5", lambda x: F.gaussian_filter2d(x, 2.5)),
                     ("box 7", lambda x: F.box_blur2d(x, 7)),
                     ("gradient dy", lambda x: F.spatial_gradient_first_order(x, 1.0)[0]),
                     ("gradient dx", lambda x: F.spatial_gradient_first_order(x, 1.0)[1])):
        errs[name] = rel(fn(gray.to(dev)).cpu().numpy(), fn(gray).numpy())
    log(f"  (d) {len(d_gpu)} SIFT descriptors at {w}x{h} on the card in {t1 - t0:.3f} s (CPU {t2 - t1:.3f} s); "
        f"max err / max, card vs CPU: {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} "
        f"(tol {LEFTOVER_RTOL:g})")
    if not np.array_equal(g_gpu, g_cpu) or len(d_gpu) == 0 or max(errs.values()) > LEFTOVER_RTOL:
        raise RuntimeError("phase 9 (d): descriptors or filters on the card disagree with the CPU")


def multi_gpu(dev, image):
    """Phase 9: the multi-GPU paths, (a) to (d)."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = os.path.join(tmp, "scenario.npz")
        data = mesh_scenario(dev, path)
        log(f"  scenario: {int(data['meta'][3])} slots, {int(data['alive'].sum())} alive, two cameras at "
            f"{int(data['meta'][0])}x{int(data['meta'][1])}; one-rank steps: {int(data['ref2/pairs'])} pairs at "
            f"batch 2, {int(data['ref1/pairs'])} at batch 1 -> pair capacity {int(data['pair_capacity'])}; "
            f"{time.perf_counter() - t0:.1f} s")
        witnesses(dev, data, path, one_rank_nccl(dev, data))
        del data
        torch.cuda.empty_cache()
        shared_card(path)
    torch.cuda.empty_cache()
    trainer_on_mesh()
    leftovers_card_vs_cpu(dev, image)


# ----------------------------------------------------------------- phase 10
# The whole training path at garden scale: Mip-NeRF 360 garden at
# data_factor 4 has 185 images at 1297x840 (test_every 8: 162 train, 23
# test) and an SfM cloud of about 10^5 points. The real scene is not on the
# card's machine, so a scene with its widths is built from a seed.
# Cut to 96 of garden's 185 cameras (cameras are cut first, widths never), so
# that the phase with its witness, kNN comparison and growth run stays
# within 300 s (185 cameras took 519 s with the plain kNN searches over
# every query), and to 800 steps (refines at 600 and 700, an opacity reset
# at 600), so that the script with phase 12 keeps within its time. Not
# earlier: at 400 steps with refines at 200 and 300 after a reset at 200,
# the second refine pruned more than it grew, where the phase holds the
# alive count rising from the first refine to the last.
GARDEN = dict(n_cams=96, width=1296, height=840, n_fg=150_000, n_bg=850_000, n_sfm=100_000,
              steps=800, capacity=3_000_000, reset_every=600)
# The growth run: the default preset from a sparser mdi init (static
# stride 40: the depth points of a view 16x fewer), so that densification
# grows the cloud; its own step count, no reset within it. The Runner
# regrows an overflowed pair table at its next logged step (every 100 steps)
# or, where a refine's growth overflows the very next step, at that step.
# The default preset's refines from step 600 took 1,300 steps to bring an
# overflow (after the refine at 1,100; 152,391 -> 414,387 alive). A lower
# growth threshold and refines from step 200 do it in 700: 152,391 ->
# 552,149 alive over the refines at 200-600, the table grown at 401, 500
# and 601 (NVIDIA H100 80GB HBM3, 700 W; chip_measure.py growth-variants,
# which also runs grow_grad2d 1e-4 over 800 steps).
GROWTH_STEPS = 700
GROWTH_OVERRIDES = ["--init_type=monocular_depth", "--mdi.predictor=stub", "--mdi.use_cache=false",
                    "--mdi.subsample_factor=40", "--strategy.refine_start_iter=100",
                    "--strategy.grow_grad2d=0.00005"]
# The oracle depth is the expected depth of the ground-truth render where
# alpha >= ORACLE_MIN_ALPHA (NaN elsewhere): at lower alpha it blends the
# surface with what lies behind it, and the dense surface depth is out of
# reach at 10^6 gaussians (an 8 GB block per 2,048 pixels).
ORACLE_MIN_ALPHA = 0.95
# The foreground cluster: FG_BLOBS spheres of FG_RADIUS within a metre of
# the origin, so that the SfM points' depths span 1.5-4 m from every camera.
FG_BLOBS, FG_RADIUS = 8, 0.25
# SfM registers what it sees: an image observes an SfM point only where
# the point's depth lies within SFM_VISIBLE_RTOL of the rendered depth at
# its pixel. write_colmap_scene's own test allows 5%, 12 cm at 2.5 m, half
# a sphere's radius: it lets in points on a sphere's far side near its
# rim, hidden behind the visible surface, and a fit over 40 observations
# with such points comes out ~2% high whichever depth the stub reads
# (rim_bias_witness holds the exact surface depth to this).
SFM_VISIBLE_RTOL = 0.002
# Phase 6a's limit on the recovered scale's median over images. The worst
# image is printed, not held: on correspondences this close the default
# RANSAC threshold (squared residual 0.01) takes every point as an inlier,
# so the first hypothesis is kept, a fit through 4 points, and its scale
# moves with their depth spread (8% off on one image of 161 with 185
# cameras, NVIDIA H100 80GB HBM3, 700 W; test_torch_mdi_init.py says the
# same of exact data).
SCALE_RTOL = 0.01
# The eval-only restart must reproduce the run's eval PSNR (PERF.md §2).
RESTART_PSNR_ATOL = 1e-6
# The default preset's test_every: 8 (96 views: 84 train, 12 test).
GARDEN_TEST_EVERY = 8
# rim_bias_witness evaluates the dense oracle at a view's first this many
# in-frame SfM points, of which the first 40 that pass the visibility test
# are its observations, in every WITNESS_STRIDE-th training view.
WITNESS_CANDIDATES = 512
WITNESS_STRIDE = 5
# The kNN scale init against its plain searches: |d^2 - d'^2| within this
# many float32 ulp of |p|^2 + d^2, the rounding of |x|^2 + |y|^2 - 2 x.y.
KNN_ULP = 8
KNN_QUERY_STRIDE = 32


def garden_scene(dev, n_cams, width, height, n_fg, n_bg, seed=10):
    """make_clustered_scene's layout at ~10^6 gaussians: a textured
    foreground cluster (FG_BLOBS spheres, whose first points become the
    SfM points: SfM registers surfaces) inside a wall and a ground that
    every camera sees and no SfM point covers. Each part's gaussians are
    sized to its mean spacing on its surface, so the views keep texture at
    pixel scale (1 to 7 px at 1296x840). The ground truth is rendered
    through the tile compositor (K1, tile 32); its expected depth where
    alpha >= ORACLE_MIN_ALPHA (NaN elsewhere) is the surface depth.
    Returns (the scene, its gaussians: means, quats, scales, opacities)."""
    from gs_init_tpu_torch.datasets.synthetic import SyntheticScene, look_at, render_views

    rng = np.random.default_rng(seed)
    centres = rng.uniform(-1.0, 1.0, (FG_BLOBS, 3)) * [1.0, 0.5, 1.0]
    d = rng.normal(size=(n_fg, 3))
    fg = (d / np.linalg.norm(d, axis=1, keepdims=True) * (FG_RADIUS + rng.normal(0, 0.005, (n_fg, 1)))
          + centres[rng.integers(0, FG_BLOBS, n_fg)])
    n_wall = int(n_bg * 0.7)
    ang = rng.uniform(0, 2 * np.pi, n_wall)
    r_wall = rng.uniform(5.5, 7.0, n_wall)
    wall = np.stack([r_wall * np.cos(ang), rng.uniform(-2.2, 2.2, n_wall), r_wall * np.sin(ang)], -1)
    n_gnd = n_bg - n_wall
    gr = np.sqrt(rng.uniform(0.15, 1.0, n_gnd)) * 6.5
    ga = rng.uniform(0, 2 * np.pi, n_gnd)
    ground = np.stack([gr * np.cos(ga), np.full(n_gnd, 2.3) + rng.normal(0, 0.05, n_gnd), gr * np.sin(ga)], -1)
    # Mean spacing on the sphere, on the wall's mid surface and on the ground's annulus.
    spacing = np.repeat(
        [np.sqrt(FG_BLOBS * 4 * np.pi * FG_RADIUS**2 / n_fg), np.sqrt(2 * np.pi * 6.25 * 4.4 / n_wall),
         np.sqrt(np.pi * 6.5**2 * 0.85 / n_gnd)], [n_fg, n_wall, n_gnd])
    pts = np.concatenate([fg, wall, ground])
    n = len(pts)
    scales = spacing[:, None] * rng.uniform(0.6, 1.4, (n, 3))
    rgbs = rng.uniform(0.05, 0.95, (n, 3))
    quats = rng.normal(size=(n, 4))
    opac = rng.uniform(0.55, 0.95, n)
    c2ws = []
    for i in range(n_cams):
        a = 2 * np.pi * i / n_cams
        c2ws.append(look_at(np.array([3 * np.cos(a), -0.4 + 0.5 * np.sin(2 * a), 3 * np.sin(a)]), np.zeros(3)))
    c2ws = np.stack(c2ws)
    f = 0.85 * width
    Ks = np.tile(np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]]), (n_cams, 1, 1))
    images, alphas, depths = render_views(pts, quats, scales, opac, rgbs, c2ws, Ks, width, height,
                                          device=dev, tile_size=32)
    scene = SyntheticScene(
        points=pts.astype(np.float32), rgbs=rgbs.astype(np.float32), images=images,
        camtoworlds=c2ws.astype(np.float32), Ks=Ks.astype(np.float32), width=width, height=height,
        scene_scale=3.0, depths=depths, alphas=alphas,
        surface_depths=np.where(alphas >= ORACLE_MIN_ALPHA, depths, np.nan).astype(np.float32),
    )
    return scene, (pts, quats, scales, opac)


def sfm_visible_depth(scene, n_sfm):
    """The surface depth that write_colmap_scene tests the first n_sfm
    points against (it reads it only at their pixels), NaN at each pixel
    where one of them lies more than SFM_VISIBLE_RTOL off it."""
    sfm = scene.points[:n_sfm].astype(np.float64)
    k0 = scene.Ks[0]
    visible = scene.surface_depths.copy()
    for i, c2w in enumerate(scene.camtoworlds):  # write_colmap_scene's projection
        w2c = np.linalg.inv(c2w.astype(np.float64))
        cam = sfm @ w2c[:3, :3].T + w2c[:3, 3]
        pix = (cam[:, :2] / cam[:, 2:3]) @ k0[:2, :2].T + k0[:2, 2]
        ok = ((cam[:, 2] > 0) & (pix[:, 0] >= 0) & (pix[:, 0] < scene.width) & (pix[:, 1] >= 0)
              & (pix[:, 1] < scene.height))
        xi, yi = pix[ok, 0].astype(np.int64), pix[ok, 1].astype(np.int64)
        surf = scene.surface_depths[i][yi, xi]
        off = ~(np.abs(cam[ok, 2] - surf) <= SFM_VISIBLE_RTOL * surf)
        visible[i][yi[off], xi[off]] = np.nan
    return visible


def surface_depth_at(gaussians, c2w, K, width, height, pix, dev, chunk=512):
    """render_surface_depth's depth, of the gaussian with the largest
    compositing weight, at the pixels pix [P, 2] (integer x, y) of one
    view: the dense oracle at those pixels only."""
    import torch
    from gs_init_tpu_torch.ops.projection import project_gaussians
    from gs_init_tpu_torch.ops.rasterize_ref import alpha_at, depth_order

    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    with torch.no_grad():
        proj = project_gaussians(*(t(x) for x in gaussians), torch.linalg.inv(t(c2w))[None], t(K)[None],
                                 width, height)
        valid = proj.radii[0] > 0
        order = depth_order(proj.depths[0], valid)[: int(valid.sum())]
        m2d, con, op, dep = (x[0][order] for x in (proj.means2d, proj.conics, proj.opacities, proj.depths))
        live = torch.ones(len(order), dtype=torch.bool, device=dev)
        centres = t(np.asarray(pix) + 0.5)
        out = []
        for s in range(0, len(centres), chunk):
            alpha = alpha_at(m2d, con, op, live, centres[s : s + chunk])
            log1m = torch.log1p(-alpha)
            w = alpha * torch.exp(torch.cumsum(log1m, dim=0) - log1m)
            out.append(dep[torch.argmax(w, dim=0)])
        return torch.cat(out).cpu().numpy()


def rim_bias_witness(scene, gaussians, n_sfm, k, dev):
    """SFM_VISIBLE_RTOL's cause, shown against the exact surface. Each
    view's observations are its first 40 in-frame SfM points whose depth
    lies within a tolerance of a surface depth at their pixel (the test of
    write_colmap_scene), and the package's points_from_depth fits the
    stub's prediction (0.37 depth + 1.3) of that surface depth over them,
    by RANSAC with the package defaults and by least squares. Three arms:
    the expected depth at alpha >= ORACLE_MIN_ALPHA with the 5% test (the
    scene as write_colmap_scene alone would write it); the exact surface
    depth (the dense oracle at the first WITNESS_CANDIDATES in-frame
    points' pixels only) with the 5% test; the exact surface depth with
    SFM_VISIBLE_RTOL. In the parser's world (depths times its similarity
    scale k), as the init runs. Returns {(arm, method): the median of the
    recovered scale over the stub's}, the median of (z - surface) / surface
    over the 5% test's observations of the exact surface, and the views."""
    import torch
    from gs_init_tpu_torch.mdi.points_from_depth import points_from_depth

    width, height = scene.width, scene.height
    sfm = scene.points[:n_sfm].astype(np.float64)
    T = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    arms = (("expected depth, 5%", 0.05), ("exact depth, 5%", 0.05), ("exact depth, visible", SFM_VISIBLE_RTOL))
    ratios = {(arm, m): [] for arm, _ in arms for m in ("ransac", "lstsqrs")}
    behind = []
    views = [i for i in range(len(scene.camtoworlds)) if i % GARDEN_TEST_EVERY][::WITNESS_STRIDE]
    for i in views:
        c2w = scene.camtoworlds[i].astype(np.float64)
        w2c = np.linalg.inv(c2w)
        cam = sfm @ w2c[:3, :3].T + w2c[:3, 3]
        pix = (cam[:, :2] / cam[:, 2:3]) @ scene.Ks[i][:2, :2].T + scene.Ks[i][:2, 2]
        cand = np.where((cam[:, 2] > 0) & (pix[:, 0] >= 0) & (pix[:, 0] < width) & (pix[:, 1] >= 0)
                        & (pix[:, 1] < height))[0][:WITNESS_CANDIDATES]
        xy = pix[cand].astype(np.int64)
        exact = np.full((height, width), np.nan, np.float32)
        exact[xy[:, 1], xy[:, 0]] = surface_depth_at(gaussians, c2w, scene.Ks[i], width, height, xy, dev)
        c2w_k = c2w.copy()
        c2w_k[:3, 3] *= k
        for arm, rtol in arms:
            depth = scene.surface_depths[i] if arm.startswith("expected") else exact
            surf = depth[xy[:, 1], xy[:, 0]]
            near = np.abs(cam[cand, 2] - surf) < rtol * np.maximum(surf, 1e-6)
            sel = cand[near][:40]
            if arm == "exact depth, 5%":
                behind.extend(((cam[cand, 2] - surf) / surf)[near][:40])
            if len(sel) < 4:
                continue
            pred = 0.37 * k * depth + 1.3
            mask = np.isfinite(pred)
            for method in ("ransac", "lstsqrs"):
                out = points_from_depth(
                    T(np.where(mask, pred, 0.0)), torch.as_tensor(mask, device=dev), T(c2w_k), T(scene.Ks[i]),
                    T(sfm[sel] * k), torch.ones(len(sel), dtype=torch.bool, device=dev), generator=gen,
                    width=width, height=height, align_method=method)
                ratios[(arm, method)].append(float(out.scale) * 0.37)
    return {key: float(np.median(v)) for key, v in ratios.items()}, float(np.median(behind)), len(views)


def knn_comparison(points, k=3, chunk=2048):
    """The kNN scale init (the package's mean_knn_dist) beside two plain
    searches over the same cloud: the earlier brute force ([chunk, N] blocks of
    |x|^2 + |y|^2 - 2 x.y, one top-k over N each) and the blocked running
    top-k knn(points, points, k + 1). Each plain search scans every point
    for every block of chunk queries, the same work for each block, so it
    runs on every KNN_QUERY_STRIDE-th block of queries against the whole
    cloud and its time is scaled to all blocks. Returns {name: (seconds for
    the cloud, seconds measured, peak GiB above what was held, the result
    on the sampled queries)}."""
    import torch
    from gs_init_tpu_torch.ops import knn as pknn

    dev = points.device
    n_blocks = -(-len(points) // chunk)
    every = torch.arange(len(points), device=dev)
    sample = torch.cat([every[b * chunk : (b + 1) * chunk] for b in range(0, n_blocks, KNN_QUERY_STRIDE)])
    share = len(range(0, n_blocks, KNN_QUERY_STRIDE)) / n_blocks

    def brute(q, p):
        p_sq = (p * p).sum(-1)
        out = []
        for s in range(0, q.shape[0], chunk):
            qb = q[s : s + chunk]
            d2 = (qb * qb).sum(-1, keepdim=True) - 2.0 * qb @ p.T + p_sq[None, :]
            out.append(torch.topk(d2, k + 1, dim=1, largest=False).values.clamp(min=0.0))
        return torch.sqrt(torch.cat(out, 0)[:, 1:].mean(-1))

    def blocked(q, p):
        d, _ = pknn.knn(q, p, k + 1, chunk=chunk)
        return torch.sqrt((d[:, 1:] ** 2).mean(-1))

    res = {}
    for name, fn, part in (("mean_knn_dist", lambda q, p: pknn.mean_knn_dist(p, k=k)[sample], 1.0),
                           ("brute force", brute, share), ("knn", blocked, share)):
        q = points if part == 1.0 else points[sample]
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        out = fn(q, points)
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        res[name] = (secs / part, secs, (torch.cuda.max_memory_allocated(dev) - base) / 2**30, out)
    return res, sample


def growth_run(data_dir, res, card, dev, capacity, mdi_model):
    """Phase 10's growth run: the garden scene through the default preset
    at the same capacity from a sparser mdi init (GROWTH_OVERRIDES, with
    `mdi_model` over the same oracle), for GROWTH_STEPS steps, so that
    densification must grow the cloud and the pair table must follow it.
    Prints the alive count after each refine, the retunes and the
    overflowed steps; returns a failure unless the alive count more than
    doubles across the refines within the capacity and a retune grows the
    pair table after a refine."""
    import torch
    from gs_init_tpu_torch import trainer
    from gs_init_tpu_torch.config import parse_cli
    from gs_init_tpu_torch.engine import runner as prunner
    from gs_init_tpu_torch.engine.strategy import default as dstrat

    say = lambda s: log(f"  [{card}] growth run: {s}")
    steps = GROWTH_STEPS
    cfg = parse_cli(["default", f"--data_dir={data_dir}", "--data_factor=1", f"--result_dir={res}",
                     f"--max_gaussians={capacity}", f"--max_steps={steps}", f"--eval_steps=[{steps}]",
                     f"--save_steps=[{steps}]", *GROWTH_OVERRIDES], trainer.build_presets())
    cfg.adjust_steps()
    refines, retunes, overflow = [], [], []
    real_refine = dstrat.refine

    def timed_refine(*a, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = real_refine(*a, **kw)
        torch.cuda.synchronize(dev)
        refines.append(dict(step=a[-1], ms=(time.perf_counter() - t0) * 1e3, alive=int(out[0].alive.sum())))
        return out

    dstrat.refine = timed_refine
    try:
        t0 = time.perf_counter()
        runner = prunner.Runner(cfg, device=dev, mdi_model=mdi_model)
        n0 = int(runner.gstate.alive.sum())
        real_iter, real_retune = runner.train_iteration, runner._maybe_retune_capacity

        def counted_iter(step):
            m = real_iter(step)
            overflow.append(m["overflow"])
            return m

        def counted_retune(metrics, step, **kw):
            cap = cfg.pair_capacity
            real_retune(metrics, step, **kw)
            if cfg.pair_capacity != cap:
                retunes.append((step, cap, cfg.pair_capacity))

        runner.train_iteration, runner._maybe_retune_capacity = counted_iter, counted_retune
        t1 = time.perf_counter()
        stats = runner.train()
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
    finally:
        dstrat.refine = real_refine
    n_over = int((torch.stack(overflow) > 0).sum())
    alive = [r["alive"] for r in refines]
    say(f"{' '.join(GROWTH_OVERRIDES)}: {n0} gaussians at the init (set-up {t1 - t0:.3f} s); {steps} steps "
        f"in {t2 - t1:.3f} s ({steps / (t2 - t1):.3f} steps/s, refines, final eval and checkpoint inside); loss "
        f"{stats['loss']:.5f} at the end; peak memory {stats['mem_peak_gb']:.3f} GiB")
    say("refines (step: ms, alive after): " + ", ".join(f"{r['step']}: {r['ms']:.3f}, {r['alive']}" for r in refines))
    say(f"pair capacity: {len(retunes)} retunes {retunes}; {n_over} steps overflowed their table")
    grown = [r for r in retunes if r[2] > r[1] and refines and r[0] > refines[0]["step"]]
    del runner
    torch.cuda.empty_cache()
    if not (alive and alive[-1] > 2 * n0 and max(alive) <= capacity and grown):
        return [f"growth run: alive {n0} -> {alive} within {capacity}, retunes {retunes}: the cloud did not "
                "double, or no retune grew the pair table after a refine"]
    return []


def garden_path(dev, card, n_cams, width, height, n_fg, n_bg, n_sfm, steps, capacity, reset_every):
    """Phase 10: the whole path at garden scale through the entry points a
    user calls. The config from parse_cli with the default preset and
    override strings; Runner(cfg, parser, mdi_model=...).train(), built as
    trainer.run_with_config builds it (trainer.main takes no predictor
    object), with the stub over the oracle depth; the eval-only restart
    through trainer.main(["--ckpt", ...]). The timers wrap the package's
    functions for this phase only. Every printed number carries `card`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gs_init_tpu_torch import kernels, trainer
    from gs_init_tpu_torch.config import parse_cli
    from gs_init_tpu_torch.datasets.parser import Parser
    from gs_init_tpu_torch.datasets.synthetic import write_colmap_scene
    from gs_init_tpu_torch.engine import params as pparams
    from gs_init_tpu_torch.engine import runner as prunner
    from gs_init_tpu_torch.engine.strategy import default as dstrat

    now = time.perf_counter
    sync = lambda: torch.cuda.synchronize(dev)
    peaks = []  # GiB, one per stretch between resets of the peak statistics

    def new_peak():
        sync()
        peaks.append(torch.cuda.max_memory_allocated(dev) / 2**30)
        torch.cuda.reset_peak_memory_stats(dev)

    say = lambda s: log(f"  [{card}] {s}")
    patches = []

    def patch(obj, name, fn):
        patches.append((obj, name, getattr(obj, name)))
        setattr(obj, name, fn)

    t_phase = now()
    new_peak()
    failures = []
    env_before = os.environ.get("GS_TPU_CHECKPOINT_DIR")
    with tempfile.TemporaryDirectory() as tmp:
        try:
            # The scene.
            t0 = now()
            scene, gaussians = garden_scene(dev, n_cams, width, height, n_fg, n_bg)
            t1 = now()
            data_dir = write_colmap_scene(
                tmp, scene._replace(surface_depths=sfm_visible_depth(scene, n_sfm)), n_points=n_sfm)
            t2 = now()
            say(f"scene: {n_cams} cameras at {width}x{height}, {len(scene.points)} gaussians, {n_sfm} SfM "
                f"points (the foreground only); rendered through K1 in {t1 - t0:.3f} s, {n_cams} PNGs and "
                f"the COLMAP model written in {t2 - t1:.3f} s; pixels with alpha >= {ORACLE_MIN_ALPHA}: "
                f"{float(np.mean(scene.alphas >= ORACLE_MIN_ALPHA)):.4f}")
            ckpt_dir = os.path.join(tmp, "lpips")
            os.makedirs(ckpt_dir)
            write_lpips_weights(ckpt_dir)
            os.environ["GS_TPU_CHECKPOINT_DIR"] = ckpt_dir

            res = os.path.join(tmp, "run")
            argv = ["default", f"--data_dir={data_dir}", "--data_factor=1", f"--result_dir={res}",
                    "--init_type=monocular_depth", "--mdi.predictor=stub", "--mdi.use_cache=false",
                    f"--max_gaussians={capacity}", f"--max_steps={steps}", f"--eval_steps=[{steps}]",
                    f"--save_steps=[{steps}]", f"--strategy.reset_every={reset_every}"]
            cfg = parse_cli(argv, trainer.build_presets())
            cfg.adjust_steps()
            s = cfg.strategy
            refine_steps = [k for k in range(steps) if s.refine_start_iter < k < s.refine_stop_iter
                            and k % s.refine_every == 0 and k % s.reset_every >= s.pause_refine_after_reset]
            reset_steps = [k for k in range(1, min(steps, s.refine_stop_iter)) if k % s.reset_every == 0]

            # The init, timed: the stub's predictions, each image's alignment
            # and unprojection (synchronised), the rest on the host; the kNN
            # scale init with its own peak memory.
            t0 = now()
            parser = Parser(data_dir, factor=1, test_every=cfg.test_every)
            want_scale = float(np.cbrt(np.linalg.det(parser.transform[:3, :3]))) / 0.37
            stub = TimedPredictor(surface_depth_stub(scene, parser))
            init, knns = {}, []
            real_mdi, real_knn = prunner.pts_and_rgb_from_monocular_depth, pparams.mean_knn_dist

            def timed_mdi(*a, **kw):
                per = []
                ta = now()
                out = real_mdi(*a, per_image=per, **kw)
                sync()
                init.update(seconds=now() - ta, per_image=per, points=len(out[0]))
                return out

            def timed_knn(points, *a, **kw):
                new_peak()
                base = torch.cuda.memory_allocated(dev) / 2**30
                ta = now()
                out = real_knn(points, *a, **kw)
                sync()
                knns.append(dict(points=points, seconds=now() - ta, base=base,
                                 peak=torch.cuda.max_memory_allocated(dev) / 2**30))
                return out

            patch(prunner, "pts_and_rgb_from_monocular_depth", timed_mdi)
            patch(pparams, "mean_knn_dist", timed_knn)
            runner = prunner.Runner(cfg, parser=parser, mdi_model=stub, device=dev)
            sync()
            t_setup = now() - t0
            n0 = int(runner.gstate.alive.sum())
            per = init["per_image"]
            n_img = len(per)
            align = sum(r["seconds"] for r in per)
            ratio = np.array([r["scale"] for r in per]) / want_scale
            worst = float(ratio[np.argmax(np.abs(ratio - 1))])
            kn = knns[0]
            say(f"init: {n_img} of {len(parser.split_indices('train'))} training images aligned in "
                f"{init['seconds']:.3f} s, per image {init['seconds'] / n_img:.4f} s: "
                f"predict {stub.seconds / n_img:.4f}, align and unproject {align / n_img:.4f}, host (decode, "
                f"masks, post-processing) {(init['seconds'] - stub.seconds - align) / n_img:.4f}; "
                f"{init['points']} points out; scale / (similarity scale / 0.37): median "
                f"{float(np.median(ratio)):.5f}, worst {worst:.5f}")
            say(f"kNN scale init: {len(kn['points'])} points in {kn['seconds']:.3f} s, peak {kn['peak']:.3f} GiB "
                f"({kn['base']:.3f} GiB held before it); Runner set-up {t_setup:.3f} s in all, "
                f"{n0} gaussians alive of {capacity}")
            if abs(float(np.median(ratio)) - 1) > SCALE_RTOL:
                failures.append(f"the median recovered scale is {float(np.median(ratio)):.5f} of the stub's")
            t0 = now()
            k_sim = float(np.cbrt(np.linalg.det(parser.transform[:3, :3])))
            wit, behind, n_views = rim_bias_witness(scene, gaussians, n_sfm, k_sim, dev)
            arms = dict.fromkeys(a for a, _ in wit)
            say(f"rim-bias witness ({n_views} training views, 40 observations each, {now() - t0:.3f} s): median "
                f"scale / the stub's, RANSAC / least squares: " + ", ".join(
                    f"{a} {wit[(a, 'ransac')]:.5f} / {wit[(a, 'lstsqrs')]:.5f}" for a in arms)
                + f" (visible: within {SFM_VISIBLE_RTOL}); the 5% test's observations lie a median {behind:.5f} "
                "of the exact surface depth behind it")
            growth_stub = surface_depth_stub(scene, parser)
            del scene, gaussians
            if any(abs(wit[("exact depth, visible", m)] - 1) > SCALE_RTOL for m in ("ransac", "lstsqrs")):
                failures.append("the exact surface depth over the visible observations does not recover the "
                                "stub's scale")
            cmp, sample = knn_comparison(kn["points"])
            want_d = cmp["mean_knn_dist"][3].double()
            p_sq = (kn["points"][sample].double() ** 2).sum(-1)
            ulp = float(np.finfo(np.float32).eps) * (p_sq + want_d**2)
            gap = {name: float(((out.double() ** 2 - want_d**2).abs() / ulp).max())
                   for name, (_, _, _, out) in cmp.items() if name != "mean_knn_dist"}
            say(f"kNN over the init cloud ({len(kn['points'])} points; the plain searches on {len(sample)} of the "
                f"queries, every {KNN_QUERY_STRIDE}th block, scaled to all): " + ", ".join(
                    f"{name} {full:.3f} s ({secs:.3f} s measured), peak {peak:.3f} GiB above"
                    for name, (full, secs, peak, _) in cmp.items())
                + "; |d^2 - mean_knn_dist's| in float32 ulp of |p|^2 + d^2, max: "
                + ", ".join(f"{name} {g:.2f}" for name, g in gap.items()))
            del cmp, kn
            if any(g > KNN_ULP for g in gap.values()):
                failures.append(f"mean_knn_dist disagrees with its plain searches ({gap} ulp)")

            # Eval: render, the metrics and LPIPS timed; renders and the
            # overflow re-renders counted.
            ev = dict(render=[], metrics=[], lpips=[], calls=0)
            real_rast = prunner.rasterize

            def counted_rast(*a, **kw):
                ev["calls"] += 1
                return real_rast(*a, **kw)

            def timer(fn, key):
                def f(*a, **kw):
                    sync()
                    ta = now()
                    out = fn(*a, **kw)
                    sync()
                    ev[key].append(now() - ta)
                    return out
                return f

            runner._render_on_device = timer(runner._render_on_device, "render")
            patch(prunner, "rasterize", counted_rast)
            patch(prunner, "psnr", timer(prunner.psnr, "metrics"))
            patch(prunner, "ssim", timer(prunner.ssim, "metrics"))
            patch(prunner, "lpips", timer(prunner.lpips, "lpips"))
            psnr0 = runner.eval(0)["psnr"]
            for k in ev:
                ev[k] = [] if isinstance(ev[k], list) else 0

            # Training, with every step's loss and overflow kept on the card,
            # the segments between refines timed, a profiler window of 3
            # steps after the last refine, each refine, reset and retune.
            rec = dict(loss=[], overflow=[], mark={}, refine=[], reset=[], retune=[], prof=None)
            marks = set([0] + refine_steps)
            at = max(refine_steps[-1] + 1 if refine_steps else 0, steps - 20)
            real_iter, real_retune, real_save = runner.train_iteration, runner._maybe_retune_capacity, runner.save

            def hooked(step):
                if step in marks:
                    sync()
                    rec["mark"][step] = now()
                if step == at:
                    sync()
                    rec["prof_t"] = now()  # its start-up counted in the window
                    rec["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    rec["prof"].__enter__()
                m = real_iter(step)
                rec["loss"].append(m["loss"].detach())
                rec["overflow"].append(m["overflow"])
                if step == at + 2:
                    sync()
                    rec["prof"].__exit__(None, None, None)
                    rec["prof_wall"] = now() - rec["prof_t"]  # its teardown too
                if step == steps - 1:
                    sync()
                    rec["mark"][steps] = now()
                return m

            def timed_refine(*a, **kw):
                sync()
                ta = now()
                out = real_refine(*a, **kw)
                sync()
                rec["refine"].append(dict(step=a[-1], ms=(now() - ta) * 1e3, alive=int(out[0].alive.sum()),
                                          **out[3]))
                return out

            def timed_reset(*a, **kw):
                sync()
                ta = now()
                out = real_reset(*a, **kw)
                sync()
                rec["reset"].append((now() - ta) * 1e3)
                return out

            def counted_retune(metrics, step, **kw):
                cap = cfg.pair_capacity
                real_retune(metrics, step, **kw)
                if cfg.pair_capacity != cap:
                    rec["retune"].append((step, cap, cfg.pair_capacity))

            def timed_save(step):
                ta = now()
                path = real_save(step)
                rec["save_s"] = now() - ta
                return path

            real_refine, real_reset = dstrat.refine, dstrat.reset_opacities
            patch(dstrat, "refine", timed_refine)
            patch(dstrat, "reset_opacities", timed_reset)
            runner.train_iteration, runner._maybe_retune_capacity, runner.save = hooked, counted_retune, timed_save
            n_val = len(runner.valset)
            new_peak()
            kernels.reset_launch_counts()
            t0 = now()
            stats = runner.train()
            sync()
            t_train = now() - t0
            launches = dict(stats["kernel_launches"])
            losses = torch.stack(rec["loss"]).float().cpu().numpy()
            overflowed = int((torch.stack(rec["overflow"]) > 0).sum())
            with open(os.path.join(res, "stats", f"val_step{steps}.json")) as f:
                val = json.load(f)
            alive = [r["alive"] for r in rec["refine"]]

            # Steps per second of each segment, its refines and the profiler
            # window taken out.
            bounds = sorted(rec["mark"])
            seg = []
            for a, b in zip(bounds, bounds[1:]):
                secs = rec["mark"][b] - rec["mark"][a]
                secs -= sum(r["ms"] for r in rec["refine"] if a <= r["step"] < b) / 1e3
                secs -= sum(ms for k, ms in zip(reset_steps, rec["reset"]) if a <= k < b) / 1e3
                n_steps = b - a
                if a <= at < b:
                    secs -= rec["prof_wall"]
                    n_steps -= 3
                seg.append((a, b, n_steps / secs, secs * 1e3 / n_steps))
            say(f"train: {steps} steps in {t_train:.3f} s (final eval and checkpoint inside); loss "
                f"{losses[0]:.5f} -> {losses[-1]:.5f}, finite at every step: {bool(np.isfinite(losses).all())}")
            say("steps/s (ms/step) by segment, refines and the profiler window taken out: " + ", ".join(
                f"[{a}, {b}) {r:.3f} ({ms:.3f})" for a, b, r, ms in seg))
            say("refines (step: ms, alive after, duplicated / split / pruned): " + ", ".join(
                f"{r['step']}: {r['ms']:.3f}, {r['alive']}, {r['n_dup']}/{r['n_split']}/{r['n_pruned']}"
                for r in rec["refine"]) + f"; opacity resets at {reset_steps}: "
                + ", ".join(f"{ms:.3f} ms" for ms in rec["reset"]))
            say(f"pair capacity: {len(rec['retune'])} retunes {rec['retune']}, {cfg.pair_capacity} at the end; "
                f"{overflowed} steps overflowed their table (their pairs past it dropped, as the JAX Runner "
                f"does); 0 steps redone (the Runner redoes none)")
            rows = cuda_rows(rec["prof"], 3)
            if not rows:
                raise RuntimeError("phase 10: the profiler saw no device time")
            busy_ms = sum(r[0] for r in rows)
            last_ms = seg[-1][3]
            idle = max(0.0, 1 - busy_ms / last_ms)
            say(f"profiler (steps {at}-{at + 2}, {alive[-1] if alive else n0} alive): device busy "
                f"{busy_ms:.3f} ms/step, idle share {idle:.3f} of the unprofiled {last_ms:.3f} ms step; "
                f"top kernels by device time:")
            for ms, cnt, key in rows[:8]:
                log(f"    {ms:9.3f} ms/step  x{cnt:<4d} {key[:110]}")
            rr = ev["calls"] - n_val
            say(f"eval at {steps} ({n_val} images): PSNR {psnr0:.4f} (initial gaussians) -> {val['psnr']:.4f}, "
                f"SSIM {val['ssim']:.4f}, LPIPS {val.get('lpips', float('nan')):.4f} (random weights, for its "
                f"time), {val['num_GS']} gaussians; ms per image: render {1e3 * np.mean(ev['render']):.3f}, "
                f"PSNR and SSIM {1e3 * np.sum(ev['metrics']) / n_val:.3f}, LPIPS "
                f"{1e3 * np.sum(ev['lpips']) / n_val:.3f}; {rr} overflow re-renders")
            ckpt = os.path.join(res, "ckpts", f"ckpt_{steps}.npz")
            nbytes = os.path.getsize(ckpt)
            want = dict(composite_fwd=steps + ev["calls"], composite_bwd=steps, scan_probe=1)
            say(f"launches in train() {json.dumps(launches)} (want {json.dumps(want)}: one K1 and K2 per step, "
                f"K1 once per eval render and re-render, the scan probe once for the step function); "
                f"peak memory in train() {stats.get('mem_peak_gb', float('nan')):.3f} GiB")
            del runner, stub
            torch.cuda.empty_cache()
            new_peak()

            # The eval-only restart through the trainer's entry point.
            loads = []
            real_load = prunner.Runner.load

            def timed_load(self, path):
                ta = now()
                out = real_load(self, path)
                sync()
                loads.append(now() - ta)
                return out

            patch(prunner.Runner, "load", timed_load)
            restart_argv = ["default", f"--data_dir={data_dir}", "--data_factor=1", f"--result_dir={res}_restart",
                            f"--max_gaussians={capacity}", f"--pair_capacity={cfg.pair_capacity}",
                            f"--ckpt=[{ckpt}]"]
            t0 = now()
            trainer.main(restart_argv, device=dev)
            sync()
            t_restart = now() - t0
            with open(os.path.join(f"{res}_restart", "stats", f"val_step{steps}.json")) as f:
                psnr_re = json.load(f)["psnr"]
            new_peak()
            say(f"checkpoint: {nbytes} bytes, saved in {rec['save_s']:.3f} s, loaded in {loads[0]:.3f} s; "
                f"eval-only restart (trainer.main --ckpt: set-up, load, eval, trajectory) {t_restart:.3f} s, "
                f"PSNR {psnr_re:.6f} (|diff| {abs(psnr_re - val['psnr']):.2e})")
            if len(losses) != steps or not np.isfinite(losses).all():
                failures.append("a non-finite loss")
            if not (len(alive) == len(refine_steps) > 1 and max(alive + [n0]) <= capacity and alive[-1] > alive[0]):
                failures.append(f"alive {n0} -> {alive} did not rise across the refines within the capacity "
                                f"{capacity}")
            if not val["psnr"] > psnr0:
                failures.append(f"eval PSNR {val['psnr']:.4f} does not beat the initial {psnr0:.4f}")
            if any(launches[k] != v for k, v in want.items()):
                failures.append(f"launches {launches}, not {want}")
            if abs(psnr_re - val["psnr"]) > RESTART_PSNR_ATOL:
                failures.append("the eval-only restart did not reproduce the run's PSNR")
            failures += growth_run(data_dir, os.path.join(tmp, "growth"), card, dev, capacity, growth_stub)
            new_peak()
            say(f"peak memory {max(peaks):.3f} GiB; phase 10 took {now() - t_phase:.1f} s")
            if failures:
                raise RuntimeError("phase 10: " + "; ".join(failures))
            return dict(busy_ms=busy_ms, idle=idle)
        finally:
            for obj, name, fn in reversed(patches):
                setattr(obj, name, fn)
            if env_before is None:
                os.environ.pop("GS_TPU_CHECKPOINT_DIR", None)
            else:
                os.environ["GS_TPU_CHECKPOINT_DIR"] = env_before


# ----------------------------------------------------------------- phase 11
# Both presets at their own defaults on garden's 185 cameras (test_every 8:
# 161 train, 24 test). The mdi init over the 161 training images gives
# ~1.68M points (1,675,479 on an NVIDIA H100 80GB HBM3, 700 W), above the
# presets' max_gaussians of 1,000,000, so each run starts from the uniform
# random subset with a full buffer: the default preset's refines find no
# free slot until pruning frees some; the mcmc preset (cap_max = capacity) grows by nothing and relocates
# onto the full buffer. The argv names no capacity, cap_max, pair table or
# refine schedule. Widths are garden's; the depth is cut to 800 steps
# (refines or relocations at 600 and 700; the phase holds that one of them
# grants a slot that pruning freed, or moves a dead gaussian: a
# 1,200-step run granted 37,822 freed slots at 700 and moved 1 and 9 dead
# gaussians at 600 and 700, NVIDIA H100 80GB HBM3, 700 W).
GARDEN_FULL = dict(n_cams=185, width=1296, height=840, n_fg=150_000, n_bg=850_000, n_sfm=100_000)
DEFAULT_STEPS = 800
# The least rise of eval PSNR over the initial gaussians' in each run (dB).
PSNR_GAIN_DB = 3.0
# The card's eval metrics against the same formulas on CPU copies of the
# same render and ground truth: float32 sums in another order.
EVAL_PSNR_ATOL = 1e-4
EVAL_SSIM_ATOL = 1e-5


class Tee:
    """A stdout that also keeps what it was given."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def preset_run(preset, data_dir, parser, stub, res, steps, card, dev):
    """One run of phase 11: parse_cli(preset) -> Runner(cfg, parser,
    mdi_model=stub) -> eval of the initial gaussians -> train(). Timers and
    counters wrap the package's functions for this run only. Returns the
    failures."""
    import torch
    from gs_init_tpu_torch import kernels, trainer
    from gs_init_tpu_torch.config import parse_cli
    from gs_init_tpu_torch.engine import params as pparams
    from gs_init_tpu_torch.engine import runner as prunner
    from gs_init_tpu_torch.engine.strategy import default as dstrat
    from gs_init_tpu_torch.engine.strategy import mcmc as mstrat

    now = time.perf_counter
    sync = lambda: torch.cuda.synchronize(dev)
    say = lambda s: log(f"  [{card}] {preset}: {s}")
    patches = []

    def patch(obj, name, fn):
        patches.append((obj, name, getattr(obj, name)))
        setattr(obj, name, fn)

    def timer(fn, out):
        def f(*a, **kw):
            sync()
            ta = now()
            r = fn(*a, **kw)
            sync()
            out.append(now() - ta)
            return r
        return f

    argv = [preset, f"--data_dir={data_dir}", "--data_factor=1", f"--result_dir={res}",
            "--init_type=monocular_depth", "--mdi.predictor=stub", "--mdi.use_cache=false",
            f"--max_steps={steps}", f"--eval_steps=[{steps}]"]
    cfg = parse_cli(argv, trainer.build_presets())
    cfg.adjust_steps()
    s = cfg.strategy
    cap = cfg.max_gaussians
    limit = min(s.cap_max, cap) if preset == "mcmc" else cap
    failures = []
    try:
        # The init: the mdi cloud, the subset and the kNN over it, timed.
        init, knns, inits = {}, [], []
        real_mdi, real_knn, real_init = (prunner.pts_and_rgb_from_monocular_depth, pparams.mean_knn_dist,
                                         prunner.init_from_points)

        def timed_mdi(*a, **kw):
            per = []
            ta = now()
            out = real_mdi(*a, per_image=per, **kw)
            sync()
            init.update(seconds=now() - ta, per_image=per, points=out[0])
            return out

        patch(prunner, "pts_and_rgb_from_monocular_depth", timed_mdi)
        patch(pparams, "mean_knn_dist", timer(real_knn, knns))
        patch(prunner, "init_from_points", timer(real_init, inits))
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev) / 2**30
        tee = Tee(sys.stdout)
        t0 = now()
        with contextlib.redirect_stdout(tee):
            runner = prunner.Runner(cfg, parser=parser, mdi_model=stub, device=dev)
        sync()
        t_setup = now() - t0
        init_peak = torch.cuda.max_memory_allocated(dev) / 2**30
        g = runner.gstate
        n0 = int(g.alive.sum())
        means = g.params.means[g.alive]
        n_distinct = len(torch.unique(means, dim=0))
        cloud = torch.as_tensor(init["points"], device=dev)
        cloud_distinct = len(torch.unique(cloud, dim=0))
        finite = bool(torch.isfinite(g.params.scales[g.alive]).all())
        med0 = float(torch.exp(g.params.scales[g.alive]).amax(-1).median())
        del means, cloud
        subset_line = f"init points {len(init['points'])} exceed capacity {cap}; keeping a uniform random subset"
        printed = subset_line in "".join(tee.text)
        per = init["per_image"]
        say(f"capacity {cap}, cap_max {s.cap_max if preset == 'mcmc' else '-'} (the preset's own); init: "
            f"{len(per)} images in {init['seconds']:.3f} s ({init['seconds'] / len(per):.4f} s per image), "
            f"{len(init['points'])} points out ({cloud_distinct} distinct); subset line printed: {printed}; "
            f"init_from_points {inits[0]:.3f} s: the subset {inits[0] - knns[0]:.3f} s, the kNN over the "
            f"{n0} kept {knns[0]:.3f} s; alive {n0}, {n_distinct} distinct means, kNN scales finite: {finite}, "
            f"median scale {med0:.5f}; Runner set-up {t_setup:.3f} s, peak {init_peak:.3f} GiB ({held:.3f} GiB held "
            "before it)")
        if not printed:
            failures.append(f"{preset}: the Runner did not print the subset line")
        if n0 != cap or cap != 1_000_000:
            failures.append(f"{preset}: alive {n0} after init at capacity {cap}, not 1,000,000")
        if n_distinct != n0:
            failures.append(f"{preset}: {n0 - n_distinct} repeated means in the subset (the cloud has "
                            f"{len(init['points']) - cloud_distinct} repeated points)")
        if not finite:
            failures.append(f"{preset}: non-finite kNN scales")

        # Eval: render, metrics and LPIPS timed; rasterize calls counted;
        # at the final eval each image's PSNR and SSIM also on CPU copies.
        ev = dict(render=[], metrics=[], lpips=[], calls=0, err_psnr=[], err_ssim=[], check=False)
        real_psnr, real_ssim, real_rast = prunner.psnr, prunner.ssim, prunner.rasterize

        def counted_rast(*a, **kw):
            ev["calls"] += 1
            return real_rast(*a, **kw)

        def held(fn, key):
            timed = timer(fn, ev["metrics"])

            def f(a, b):
                out = timed(a, b)
                if ev["check"]:
                    ev[key].append(abs(float(out) - float(fn(a.cpu(), b.cpu()))))
                return out
            return f

        runner._render_on_device = timer(runner._render_on_device, ev["render"])
        patch(prunner, "rasterize", counted_rast)
        patch(prunner, "psnr", held(real_psnr, "err_psnr"))
        patch(prunner, "ssim", held(real_ssim, "err_ssim"))
        patch(prunner, "lpips", timer(prunner.lpips, ev["lpips"]))
        psnr0 = runner.eval(0)["psnr"]
        n_val = len(runner.valset)
        ev0 = {k: float(np.sum(ev[k])) * 1e3 / n_val for k in ("render", "metrics", "lpips")}
        for k in ("render", "metrics", "lpips"):
            ev[k].clear()
        ev["calls"], ev["check"] = 0, True

        # Training: each step's loss and overflow kept on the card, every
        # 100 steps marked; each refine or relocation timed, with what it
        # granted or moved; the noise timed by CUDA events (no sync).
        rec = dict(loss=[], overflow=[], mark={}, refine=[], retune=[], noise=[])
        real_iter, real_retune, real_eval = runner.train_iteration, runner._maybe_retune_capacity, runner.eval

        def hooked(step):
            if step % 100 == 0:
                sync()
                rec["mark"][step] = now()
            m = real_iter(step)
            rec["loss"].append(m["loss"].detach())
            rec["overflow"].append(m["overflow"])
            if step == steps - 1:
                sync()
                rec["mark"][steps] = now()
            return m

        def counted_retune(metrics, step, **kw):
            before = cfg.pair_capacity
            real_retune(metrics, step, **kw)
            if cfg.pair_capacity != before:
                rec["retune"].append((step, before, cfg.pair_capacity))

        def eval_peak(step, *a, **kw):
            sync()
            rec["train_peak"] = torch.cuda.max_memory_allocated(dev) / 2**30
            torch.cuda.reset_peak_memory_stats(dev)
            out = real_eval(step, *a, **kw)
            rec["eval_peak"] = torch.cuda.max_memory_allocated(dev) / 2**30
            return out

        def median_scale(gs):
            return float(torch.exp(gs.params.scales[gs.alive]).amax(-1).median())

        if preset == "default":
            real_refine, real_alloc = dstrat.refine, dstrat._alloc_slots
            grants = []

            def spy_alloc(alive, cand):
                dst, ok = real_alloc(alive, cand)
                grants.append((int(cand.sum()), int((~alive).sum()), int(ok.sum())))
                return dst, ok

            def timed_refine(*a, **kw):
                sync()
                ta = now()
                out = real_refine(*a, **kw)
                sync()
                ms = (now() - ta) * 1e3
                cand, free, granted = grants[-1]
                rec["refine"].append(dict(step=a[-1], ms=ms, alive=int(out[0].alive.sum()), cand=cand, free=free,
                                          granted=granted, median=median_scale(out[0]), **out[3]))
                return out

            patch(dstrat, "_alloc_slots", spy_alloc)
            patch(dstrat, "refine", timed_refine)
        else:
            real_relocate, real_noise = mstrat.relocate, mstrat.add_noise

            def timed_relocate(gs, adam, st, gen, scfg):
                n_dead = int(mstrat.live_mask(gs, scfg)[1].sum())
                n_before = int(gs.alive.sum())
                sync()
                ta = now()
                out = real_relocate(gs, adam, st, gen, scfg)
                sync()
                ms = (now() - ta) * 1e3
                rec["refine"].append(dict(step=runner.train_step, ms=ms, alive=int(out[0].alive.sum()), dead=n_dead,
                                          added=int(out[0].alive.sum()) - n_before, median=median_scale(out[0])))
                return out

            def timed_noise(*a, **kw):
                ea, eb = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                ea.record()
                out = real_noise(*a, **kw)
                eb.record()
                rec["noise"].append((ea, eb))
                return out

            patch(mstrat, "relocate", timed_relocate)
            patch(mstrat, "add_noise", timed_noise)
        runner.train_iteration, runner._maybe_retune_capacity, runner.eval = hooked, counted_retune, eval_peak
        kernels.reset_launch_counts()
        t0 = now()
        stats = runner.train()
        sync()
        t_train = now() - t0
        launches = dict(stats["kernel_launches"])
        losses = torch.stack(rec["loss"]).float().cpu().numpy()
        overflowed = int((torch.stack(rec["overflow"]) > 0).sum())
        g = runner.gstate
        bad = torch.zeros_like(g.alive)
        for _, v in g.params.items():
            bad |= ~torch.isfinite(v.reshape(v.shape[0], -1)).all(-1)
        n_bad = int((bad & g.alive).sum())
        with open(os.path.join(res, "stats", f"val_step{steps}.json")) as f:
            val = json.load(f)
        marks = sorted(rec["mark"])
        seg = [(a, b, (b - a) / (rec["mark"][b] - rec["mark"][a])) for a, b in zip(marks, marks[1:])]
        say(f"train: {steps} steps in {t_train:.3f} s (final eval and checkpoint inside); loss {losses[0]:.5f} -> "
            f"{losses[-1]:.5f}, finite at every step: {bool(np.isfinite(losses).all())}; alive gaussians with a "
            f"non-finite parameter at the end: {n_bad}; peak {rec['train_peak']:.3f} "
            f"GiB before the final eval, {rec['eval_peak']:.3f} GiB in it")
        say("steps/s by 100-step segment (refines or relocations inside): "
            + ", ".join(f"[{a}, {b}) {r:.3f}" for a, b, r in seg))
        if preset == "default":
            say("refines (step: ms; candidates, free slots, granted, dropped; duplicated / split / pruned; alive "
                "after; median scale after): " + "; ".join(
                    f"{r['step']}: {r['ms']:.3f}; {r['cand']}, {r['free']}, {r['granted']}, "
                    f"{r['cand'] - r['granted']}; {r['n_dup']}/{r['n_split']}/{r['n_pruned']}; {r['alive']}; "
                    f"{r['median']:.5f}" for r in rec["refine"]))
            if any(r["granted"] > r["free"] for r in rec["refine"]):
                failures.append(f"{preset}: a refine granted more slots than were free")
            if not any(r["granted"] > 0 for r in rec["refine"]):
                failures.append(f"{preset}: no refine granted a slot on the full buffer")
        else:
            noise_ms = [a.elapsed_time(b) for a, b in rec["noise"]]
            say(f"relocations (step: ms; dead relocated, added; alive after; median scale after): " + "; ".join(
                f"{r['step']}: {r['ms']:.3f}; {r['dead']}, {r['added']}; {r['alive']}; {r['median']:.5f}"
                for r in rec["refine"]) + f"; noise {np.mean(noise_ms):.4f} ms per step (median "
                f"{np.median(noise_ms):.4f}, {len(noise_ms)} steps, CUDA events)")
            if not any(r["dead"] > 0 for r in rec["refine"]):
                failures.append(f"{preset}: no relocation moved a dead gaussian")
        say(f"pair capacity: {len(rec['retune'])} retunes {rec['retune']}, {cfg.pair_capacity} at the end; "
            f"{overflowed} steps overflowed their table")
        rr = ev["calls"] - n_val
        say(f"eval ({n_val} images): PSNR {psnr0:.4f} (initial gaussians) -> {val['psnr']:.4f}, SSIM "
            f"{val['ssim']:.4f}, LPIPS {val.get('lpips', float('nan')):.4f} (random weights), {val['num_GS']} "
            f"gaussians; ms per image: render {1e3 * np.mean(ev['render']):.3f}, PSNR and SSIM "
            f"{1e3 * np.sum(ev['metrics']) / n_val:.3f}, LPIPS {1e3 * np.sum(ev['lpips']) / n_val:.3f} (at step 0: "
            f"{ev0['render']:.3f}, {ev0['metrics']:.3f}, {ev0['lpips']:.3f}); {rr} overflow re-renders; card "
            f"against CPU, max |diff| per image: PSNR {max(ev['err_psnr']):.2e} dB, SSIM {max(ev['err_ssim']):.2e}")
        want = dict(composite_fwd=steps + ev["calls"], composite_bwd=steps, scan_probe=1)
        say(f"launches in train() {json.dumps(launches)} (want {json.dumps(want)})")
        alive = [r["alive"] for r in rec["refine"]]
        if len(losses) != steps or not np.isfinite(losses).all():
            failures.append(f"{preset}: a non-finite loss")
        if n_bad:
            failures.append(f"{preset}: {n_bad} alive gaussians with a non-finite parameter")
        expected = [k for k in range(steps) if s.refine_start_iter < k < s.refine_stop_iter and k % s.refine_every == 0]
        if [r["step"] for r in rec["refine"]] != expected:
            failures.append(f"{preset}: refines or relocations at {[r['step'] for r in rec['refine']]}, not {expected}")
        if not alive or max(alive) > limit or stats["num_GS"] > limit:
            failures.append(f"{preset}: alive {alive} (end {stats['num_GS']}) beyond {limit}")
        if not val["psnr"] - psnr0 >= PSNR_GAIN_DB:
            failures.append(f"{preset}: eval PSNR {val['psnr']:.4f} rose less than {PSNR_GAIN_DB} dB over the "
                            f"initial {psnr0:.4f}")
        if len(ev["err_psnr"]) != n_val or max(ev["err_psnr"]) > EVAL_PSNR_ATOL or max(ev["err_ssim"]) > EVAL_SSIM_ATOL:
            failures.append(f"{preset}: eval metrics on the card disagree with the CPU")
        if any(launches[k] != v for k, v in want.items()):
            failures.append(f"{preset}: launches {launches}, not {want}")
        return failures
    finally:
        for obj, name, fn in reversed(patches):
            setattr(obj, name, fn)


def garden_files(dev, card, tmp, n_cams, width, height, n_fg, n_bg, n_sfm):
    """Phase 10's seeded garden scene with n_cams cameras, written as a
    COLMAP scene under tmp, and a second COLMAP model of it whose images
    observe every SfM point they see (write_all_observations). Returns
    (data_dir, its parser, the stub's oracle depth per training image in
    trainset order: the surface depth, NaN where alpha <= 0.3, the second
    model's data_dir)."""
    from gs_init_tpu_torch.datasets.parser import Parser
    from gs_init_tpu_torch.datasets.synthetic import write_colmap_scene

    now = time.perf_counter
    t0 = now()
    scene, _ = garden_scene(dev, n_cams, width, height, n_fg, n_bg)
    t1 = now()
    visible = sfm_visible_depth(scene, n_sfm)
    data_dir = write_colmap_scene(tmp, scene._replace(surface_depths=visible), n_points=n_sfm)
    t2 = now()
    dense_dir = write_all_observations(data_dir, os.path.join(tmp, "dense"), visible)
    log(f"  [{card}] scene: {n_cams} cameras at {width}x{height}, {len(scene.points)} gaussians, {n_sfm} "
        f"SfM points; rendered in {t1 - t0:.3f} s, written in {t2 - t1:.3f} s, the model with every "
        f"observation in {now() - t2:.3f} s")
    parser = Parser(data_dir, factor=1, test_every=GARDEN_TEST_EVERY)
    depths = [np.where(scene.alphas[i] > 0.3, scene.surface_depths[i], np.nan).astype(np.float32)
              for i in parser.split_indices("train")]
    return data_dir, parser, depths, dense_dir


def write_all_observations(data_dir, out_dir, surface_depths):
    """The COLMAP scene at data_dir again under out_dir (its images linked,
    not copied), each image now observing every SfM point that passes
    write_colmap_scene's visibility test against surface_depths, where
    write_colmap_scene keeps the first 40: an image of a real garden
    capture observes 10^4 points or more. Returns the new data_dir."""
    from gs_init_tpu_torch.datasets import colmap_io as cio

    rec = cio.read_reconstruction(os.path.join(data_dir, "sparse/0"))
    cam = rec.cameras[1]
    fx, fy, cx, cy = cam.params
    pts = rec.points_xyz.astype(np.float64)
    images = {}
    for i, (iid, im) in enumerate(sorted(rec.images.items())):
        w2c = np.eye(4)
        w2c[:3, :3] = cio.qvec_to_rotmat(im.qvec)
        w2c[:3, 3] = im.tvec
        c = pts @ w2c[:3, :3].T + w2c[:3, 3]
        pix = (c[:, :2] / c[:, 2:3]) * [fx, fy] + [cx, cy]
        ok = (c[:, 2] > 0) & (pix[:, 0] >= 0) & (pix[:, 0] < cam.width) & (pix[:, 1] >= 0) & (pix[:, 1] < cam.height)
        xi = np.clip(pix[:, 0].astype(np.int64), 0, cam.width - 1)
        yi = np.clip(pix[:, 1].astype(np.int64), 0, cam.height - 1)
        surf = surface_depths[i][yi, xi]
        ok &= np.abs(c[:, 2] - surf) < 0.05 * np.maximum(surf, 1e-6)
        images[iid] = dataclasses.replace(im, xys=pix[ok], point3D_ids=rec.point_ids[ok])
    out = os.path.join(out_dir, "scene")
    os.makedirs(out)
    os.symlink(os.path.join(data_dir, "images"), os.path.join(out, "images"))
    cio.write_reconstruction_bin(os.path.join(out, "sparse/0"), dataclasses.replace(rec, images=images))
    return out


def release():
    """Collect garbage and return the card's cached blocks. The timers that
    wrap a Runner's methods make reference cycles through it: collect
    them, or an earlier Runner's buffers stay on the card and in the next
    run's peak."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def default_capacity(dev, card, garden, steps):
    """Phase 11: both presets at their default capacity on the 185-camera
    garden scene (garden_files), through parse_cli and Runner(cfg, parser,
    mdi_model=stub).train() (trainer.main takes no predictor object), with
    random LPIPS weights so that eval times LPIPS too."""
    now = time.perf_counter
    t_phase = now()
    env_before = os.environ.get("GS_TPU_CHECKPOINT_DIR")
    failures = []
    data_dir, parser, depths, _ = garden
    release()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            ckpt_dir = os.path.join(tmp, "lpips")
            os.makedirs(ckpt_dir)
            write_lpips_weights(ckpt_dir)
            os.environ["GS_TPU_CHECKPOINT_DIR"] = ckpt_dir
            for preset in ("default", "mcmc"):
                failures += preset_run(preset, data_dir, parser, TimedPredictor(depth_stub(depths)),
                                       os.path.join(tmp, preset), steps, card, dev)
                release()
        finally:
            if env_before is None:
                os.environ.pop("GS_TPU_CHECKPOINT_DIR", None)
            else:
                os.environ["GS_TPU_CHECKPOINT_DIR"] = env_before
    log(f"  [{card}] phase 11 took {now() - t_phase:.1f} s")
    if failures:
        raise RuntimeError("phase 11: " + "; ".join(failures))


# Phase 12: the mdi configurations at garden scale, on phase 11's scene.
# Each arm is the defaults plus its parse_cli overrides, run through
# pts_and_rgb_from_monocular_depth on the card; (b) is the init of the
# training run, which adds LOF and the native merge (its points before the
# postprocess are arm (b)'s cloud), and (g) times the voxel merge on arm
# (f)'s cloud after its LOF. The last entry of an arm is its cameras: the
# first that many of the scene's (None: all 185), cut so that the arm keeps
# within its share of the phase. Under SLIC an image takes ~1.3 s, ~1.1 s
# of it SLIC and the region merge on the host (NVIDIA H100 80GB HBM3,
# 700 W): 161 images would be 3.5 minutes. MSAC, the RBF scale map, the
# adaptive stride and the training run's Delaunay arm run on ARM_CAMERAS
# (71 training images), so that the script with phase 13 keeps within its
# time; LOF with the merges keeps every camera.
SLIC_CAMERAS = 12
ARM_CAMERAS = 81
LOF_NATIVE = ["--mdi.postprocess.lof_outlier_removal=true", "--mdi.postprocess.merge_subsample=true"]
INTERPOLATE = ["--mdi.alignment.method=interpolate"]
MDI_ARMS = (
    ("a", "msac", ["--mdi.alignment.method=msac"], ARM_CAMERAS),
    ("c", "interpolate rbf", INTERPOLATE + ["--mdi.alignment.interp.method=rbf"], ARM_CAMERAS),
    ("d", "slic", ["--mdi.alignment.segmentation.method=slic"], SLIC_CAMERAS),
    ("e", "adaptive", ["--mdi.subsampling.method=adaptive"], ARM_CAMERAS),
    ("f", "lof native", LOF_NATIVE, None),
)
TRAIN_ARM = ("b", "interpolate (the training run's init, with LOF and the native merge)", INTERPOLATE + LOF_NATIVE)
VOXEL = ["--mdi.postprocess.merge_impl=voxel"]
# The training run from arm (b): the default preset at its own capacity.
MDI_TRAIN_STEPS = 300
# Every arm's cloud: finite, at least this many points.
MDI_MIN_POINTS = 100_000
# LOF over the foreground's dense clusters must keep at least this share.
LOF_KEEP_MIN = 0.9
# An interpolate arm's host RSS may grow by at most this much (GiB): an
# [M, M] float32 block alone is 1.6 GiB at M = 20,000.
MDI_HOST_RSS_GIB = 2.0
# Card against CPU: the deterministic arms on the first 3 training images
# (image 0 is a test view), points within this share of the cloud's extent.
CARD_CPU_IMAGES = 3
CARD_CPU_ATOL = 1e-4
CARD_CPU_ARMS = (("b, lstsqrs prealign", INTERPOLATE + ["--mdi.alignment.interp.prealign=lstsqrs"]),
                 ("d, lstsqrs", ["--mdi.alignment.segmentation.method=slic", "--mdi.alignment.method=lstsqrs"]))


class HostRss:
    """The process's resident set, sampled every 2 ms on a thread while the
    block runs: its growth over the start (GiB, `growth`), beside
    getrusage's peak RSS growth (`maxrss_growth`)."""

    def __init__(self):
        self.page = os.sysconf("SC_PAGE_SIZE")

    def now(self):
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def __enter__(self):
        import resource
        import threading

        self.base = self.peak = self.now()
        self.maxrss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        self.stop = threading.Event()

        def sample():
            while not self.stop.wait(0.002):
                self.peak = max(self.peak, self.now())
        self.thread = threading.Thread(target=sample, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        import resource

        self.stop.set()
        self.thread.join()
        self.peak = max(self.peak, self.now())
        self.growth = (self.peak - self.base) / 2**30
        self.maxrss_growth = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - self.maxrss0) / 2**20
        return False


def first_cameras(parser, n):
    """The parser cut to its first n images (None: all), split as before."""
    import copy

    if n is None:
        return parser
    cut = copy.copy(parser)
    cut.images = parser.images[:n]
    return cut


def arm_config(data_dir, res, overrides, extra=()):
    from gs_init_tpu_torch import trainer
    from gs_init_tpu_torch.config import parse_cli

    argv = ["default", f"--data_dir={data_dir}", "--data_factor=1", f"--result_dir={res}",
            "--init_type=monocular_depth", "--mdi.predictor=stub", "--mdi.use_cache=false", *overrides, *extra]
    cfg = parse_cli(argv, trainer.build_presets())
    cfg.adjust_steps()
    return cfg


class ArmProbe:
    """Wraps the init's align_depth, postprocess_point_cloud and LOF for
    one arm, for what the checks need: each pipeline image's median over
    pixels of the aligned depth over the depth that undoes the stub exactly
    (the stub's prediction less its shift, times the similarity scale /
    0.37), the postprocess's cameras, and the cloud that LOF keeps. The
    times come from the init's own per_image stages and summary."""

    def __init__(self, want_scale):
        self.want, self.ratios, self.seconds, self.post_args, self.lof_out = want_scale, [], 0.0, None, None

    def __enter__(self):
        from gs_init_tpu_torch.mdi import init as pinit
        from gs_init_tpu_torch.mdi import postprocess as ppost

        self.real_align, self.real_post = pinit.align_depth, pinit.postprocess_point_cloud

        def align(pred_depth, pred_mask, *a, **kw):
            aligned, mask = self.real_align(pred_depth, pred_mask, *a, **kw)
            t0 = time.perf_counter()
            exact = self.want * (pred_depth.astype(np.float64) - 1.3)
            sel = mask & np.isfinite(exact) & (exact > 0)
            self.ratios.append(float(np.median(aligned[sel] / exact[sel])))
            self.seconds += time.perf_counter() - t0  # left out of the align stage
            return aligned, mask

        def post(cfg, pts, rgbs, *a, **kw):
            self.post_args = a
            return self.real_post(cfg, pts, rgbs, *a, **kw)

        def lof(*a, **kw):
            self.lof_out = self.real_lof(*a, **kw)
            return self.lof_out

        self.real_lof = ppost.lof_outlier_removal
        pinit.align_depth, pinit.postprocess_point_cloud, ppost.lof_outlier_removal = align, post, lof
        return self

    def __exit__(self, *exc):
        from gs_init_tpu_torch.mdi import init as pinit
        from gs_init_tpu_torch.mdi import postprocess as ppost

        pinit.align_depth, pinit.postprocess_point_cloud = self.real_align, self.real_post
        ppost.lof_outlier_removal = self.real_lof
        return False


def arm_report(card, tag, name, parser, per, summary, probe, secs, rss, peak, want_scale, pts):
    """Print one arm's line; returns its failures."""
    say = lambda s: log(f"  [{card}] ({tag}) {name}: {s}")
    n_img = len(per)
    train = [parser.images[int(i)] for i in parser.split_indices("train")]
    m = np.array([len(parser.point_indices[im.name]) for im in train])
    stages, parts = {}, {}
    for r in per:
        for into, got in ((stages, r["stages"]), (parts, r["align_parts"])):
            for k, v in got.items():
                into[k] = into.get(k, 0.0) + v
    if "align" in stages:
        stages["align"] -= probe.seconds
    pipeline = bool(probe.ratios)
    ratio = np.array(probe.ratios if pipeline else [r["scale"] / want_scale for r in per])
    worst = float(ratio[np.argmax(np.abs(ratio - 1))])
    med = float(np.median(ratio))
    host = secs - sum(stages.values()) - summary["postprocess_seconds"]
    post = ", ".join(f"{k} {v[0]:.3f} s ({v[1]} points)" for k, v in summary["postprocess"].items())
    say(f"{n_img} images of {parser.num_images} cameras; M (SfM observations per image) largest {m.max()}, median "
        f"{int(np.median(m))}; {secs:.3f} s in all, {secs / n_img:.4f} s per image: "
        + ", ".join(f"{k} {v / n_img:.4f}" + (" (segment " + f"{parts['segment'] / n_img:.4f}, region merge "
                                                f"{parts['merge'] / n_img:.4f})" if k == "align" and parts else "")
                    for k, v in stages.items())
        + f", host rest {host / n_img:.4f}; postprocess {summary['postprocess_seconds']:.3f} s"
        + (f" ({post})" if post else "")
        + f"; points {summary['points_before']} before the postprocess, {summary['points_after']} after; "
        f"{'aligned / exact depth, median over pixels per image' if pipeline else 'scale / (similarity scale / 0.37)'}: "
        f"median {med:.5f}, worst {worst:.5f}; card peak {peak:.3f} GiB; host RSS growth {rss.growth:.3f} GiB "
        f"(getrusage peak {rss.maxrss_growth:.3f} GiB)")
    failures = []
    if not (len(pts) >= MDI_MIN_POINTS and np.isfinite(pts).all()):
        failures.append(f"({tag}) no finite cloud of {MDI_MIN_POINTS} points ({len(pts)})")
    if abs(med - 1) > SCALE_RTOL:
        failures.append(f"({tag}) the median recovered scale is {med:.5f}")
    return failures


def run_arm(dev, card, tag, name, overrides, cameras, data_dir, parser, depths, want_scale, res):
    """One arm through pts_and_rgb_from_monocular_depth on the card.
    Returns (failures, the probe, the cloud)."""
    import torch
    from gs_init_tpu_torch.mdi.init import pts_and_rgb_from_monocular_depth

    cut = first_cameras(parser, cameras)
    cfg = arm_config(data_dir, res, overrides)
    per, summary = [], {}
    release()
    torch.cuda.reset_peak_memory_stats(dev)
    with ArmProbe(want_scale) as probe, HostRss() as rss:
        t0 = time.perf_counter()
        pts, rgbs = pts_and_rgb_from_monocular_depth(cfg, cut, model=depth_stub(depths), device=dev,
                                                     per_image=per, summary=summary)
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    failures = arm_report(card, tag, name, cut, per, summary, probe, secs, rss, peak, want_scale, pts)
    if "interpolate" in name and rss.growth > MDI_HOST_RSS_GIB:
        failures.append(f"({tag}) host RSS grew {rss.growth:.3f} GiB")
    return failures, probe, (pts, rgbs), cfg


def query_sample(n, chunk=2048):
    """Every KNN_QUERY_STRIDE-th block of chunk queries of n: (indices,
    share of all blocks)."""
    n_blocks = -(-n // chunk)
    starts = range(0, n_blocks, KNN_QUERY_STRIDE)
    idx = np.concatenate([np.arange(b * chunk, min(n, (b + 1) * chunk)) for b in starts])
    return idx, len(starts) / n_blocks


class LofProbe:
    """Wraps the LOF's neighbour search (ops.lof.knn_self): times each call
    (synchronised) and keeps the points and the sampled queries' result of
    the largest."""

    def __init__(self, dev):
        self.dev, self.calls = dev, []

    def __enter__(self):
        import torch
        from gs_init_tpu_torch.ops import lof as plof

        self.real = plof.knn_self

        def f(points, k, chunk=2048):
            torch.cuda.synchronize(self.dev)
            t0 = time.perf_counter()
            d, i = self.real(points, k, chunk=chunk)
            torch.cuda.synchronize(self.dev)
            secs = time.perf_counter() - t0
            sample, share = query_sample(len(points), chunk)
            s = torch.as_tensor(sample, device=points.device)
            self.calls.append(dict(points=points, k=k, chunk=chunk, seconds=secs, sample=s, share=share,
                                   d=d[s], i=i[s]))
            return d, i

        plof.knn_self = f
        return self

    def __exit__(self, *exc):
        from gs_init_tpu_torch.ops import lof as plof

        plof.knn_self = self.real
        return False


def lof_against_brute_force(card, call, dev):
    """The LOF's bounded search over the arm's cloud (one LofProbe call)
    against the port's brute force knn over the same cloud, on every
    KNN_QUERY_STRIDE-th block of queries, its time scaled to all blocks:
    squared distances within KNN_ULP float32 ulp of |p|^2 + d^2, indices
    apart only where the two candidates' distances are that close (a tie
    to the arithmetic). Returns the failures."""
    import torch
    from gs_init_tpu_torch.ops import knn as pknn

    p, s, k = call["points"], call["sample"], call["k"]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev) / 2**30
    t0 = time.perf_counter()
    d_b, i_b = pknn.knn(p[s], p, k, chunk=call["chunk"])
    torch.cuda.synchronize(dev)
    brute = time.perf_counter() - t0
    brute_peak = torch.cuda.max_memory_allocated(dev) / 2**30 - held
    d, i, d_b = call["d"].double(), call["i"], d_b.double()
    q = p[s].double()
    ulp = float(np.finfo(np.float32).eps) * ((q**2).sum(-1, keepdim=True) + d_b**2)
    gap = float(((d**2 - d_b**2).abs() / ulp).max())
    # Where the indices differ, the point the bounded search put there must
    # lie at the brute force's distance to the arithmetic: a tie.
    apart = i != i_b
    d_there = ((q[:, None, :] - p[i].double()) ** 2).sum(-1)
    untied = apart & ((d_there - d_b**2).abs() > KNN_ULP * ulp)
    log(f"  [{card}] LOF's neighbour search over {len(p)} points, k = {k}: bounded (knn_self) {call['seconds']:.3f} s; "
        f"the brute force knn {brute / call['share']:.3f} s for the cloud ({brute:.3f} s over {len(s)} queries, "
        f"every {KNN_QUERY_STRIDE}th block, {brute_peak:.3f} GiB above what was held); on those queries "
        f"|d^2 - d'^2| at most {gap:.2f} float32 ulp of |p|^2 + d^2, {int(apart.sum())} of {apart.numel()} "
        f"indices apart, {int(untied.sum())} of them not at a tie")
    if gap > KNN_ULP or int(untied.sum()):
        return [f"LOF's bounded neighbour search disagrees with the brute force ({gap:.2f} ulp, "
                f"{int(untied.sum())} untied indices)"]
    return []


def card_against_cpu(dev, card, data_dir, parser, depths, res):
    """The deterministic arms on the first CARD_CPU_IMAGES training images,
    on the card and through the port's CPU path. Returns the failures."""
    import torch
    from gs_init_tpu_torch.mdi.init import pts_and_rgb_from_monocular_depth

    cut = first_cameras(parser, CARD_CPU_IMAGES + 1)
    failures = []
    for tag, overrides in CARD_CPU_ARMS:
        clouds, secs = [], []
        for d in (dev, torch.device("cpu")):
            cfg = arm_config(data_dir, res, overrides)
            t0 = time.perf_counter()
            clouds.append(pts_and_rgb_from_monocular_depth(cfg, cut, model=depth_stub(depths), device=d)[0])
            secs.append(time.perf_counter() - t0)
        (a, b), extent = clouds, float(np.abs(clouds[1]).max())
        err = float(np.abs(a - b).max()) / extent if a.shape == b.shape else float("inf")
        log(f"  [{card}] card against CPU ({tag}), {len(cut.split_indices('train'))} images: {len(a)} and {len(b)} "
            f"points, max |diff| {err:.3e} of the extent {extent:.3f}; {secs[0]:.3f} s on the card, {secs[1]:.3f} s "
            "on the CPU")
        if a.shape != b.shape or err > CARD_CPU_ATOL:
            failures.append(f"card against CPU ({tag}): {len(a)} vs {len(b)} points, {err:.3e} of the extent")
    return failures


def mdi_training(dev, card, data_dir, parser, depths, want_scale, res, steps):
    """parse_cli -> Runner(cfg, parser, mdi_model=stub).train() from arm
    (b) with LOF and the native merge, the default preset at its own
    capacity: eval of the initial gaussians, `steps` steps, eval. Its init
    is arm (b): printed as one. Returns the failures."""
    import torch
    from gs_init_tpu_torch import kernels
    from gs_init_tpu_torch.engine import runner as prunner

    tag, name, overrides = TRAIN_ARM
    cfg = arm_config(data_dir, res, overrides, [f"--max_steps={steps}", f"--eval_steps=[{steps}]"])
    real_mdi, real_rast = prunner.pts_and_rgb_from_monocular_depth, prunner.rasterize
    init, renders = {}, [0]

    def mdi(*a, **kw):
        per, summary = [], {}
        torch.cuda.reset_peak_memory_stats(dev)
        with ArmProbe(want_scale) as probe, HostRss() as rss:
            t0 = time.perf_counter()
            out = real_mdi(*a, per_image=per, summary=summary, **kw)
            torch.cuda.synchronize(dev)
            secs = time.perf_counter() - t0
        init.update(per=per, summary=summary, probe=probe, secs=secs, rss=rss, pts=out[0],
                    peak=torch.cuda.max_memory_allocated(dev) / 2**30)
        return out

    def counted(*a, **kw):
        renders[0] += 1
        return real_rast(*a, **kw)

    release()
    prunner.pts_and_rgb_from_monocular_depth, prunner.rasterize = mdi, counted
    try:
        runner = prunner.Runner(cfg, parser=parser, mdi_model=depth_stub(depths), device=dev)
        failures = arm_report(card, tag, name, parser, init["per"], init["summary"], init["probe"], init["secs"],
                              init["rss"], init["peak"], want_scale, init["pts"])
        if init["rss"].growth > MDI_HOST_RSS_GIB:
            failures.append(f"({tag}) host RSS grew {init['rss'].growth:.3f} GiB")
        n0 = int(runner.gstate.alive.sum())
        psnr0 = runner.eval(0)["psnr"]
        renders[0] = 0
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        stats = runner.train()
        torch.cuda.synchronize(dev)
        t_train = time.perf_counter() - t0
        launches = dict(stats["kernel_launches"])
    finally:
        prunner.pts_and_rgb_from_monocular_depth, prunner.rasterize = real_mdi, real_rast
    g = runner.gstate
    bad = torch.zeros_like(g.alive)
    for _, v in g.params.items():
        bad |= ~torch.isfinite(v.reshape(v.shape[0], -1)).all(-1)
    n_bad = int((bad & g.alive).sum())
    with open(os.path.join(res, "stats", f"val_step{steps}.json")) as f:
        val = json.load(f)
    want = dict(composite_fwd=steps + renders[0], composite_bwd=steps, scan_probe=1)
    log(f"  [{card}] training from arm (b): {n0} gaussians alive of {cfg.max_gaussians} after init; {steps} steps "
        f"and eval in {t_train:.3f} s, peak {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; eval PSNR "
        f"{psnr0:.4f} (initial) -> {val['psnr']:.4f} over {len(runner.valset)} views; alive gaussians with a "
        f"non-finite parameter: {n_bad}; launches in train() {json.dumps(launches)} (want {json.dumps(want)})")
    if not val["psnr"] - psnr0 >= PSNR_GAIN_DB:
        failures.append(f"training from arm (b): eval PSNR rose {val['psnr'] - psnr0:.4f} dB")
    if n_bad:
        failures.append(f"training from arm (b): {n_bad} alive gaussians with a non-finite parameter")
    if any(launches[k] != v for k, v in want.items()):
        failures.append(f"training from arm (b): launches {launches}, not {want}")
    return failures


def pixel_knn_against_sort(card, parser, dev, k=8):
    """The scale-outlier test's pixel neighbours as the port finds them
    (mdi/alignment/interp.py: knn_self in float64 about the centroid, on
    the card) against the JAX package's form (an [M, M] float32 distance
    matrix argsorted on the host), on the training image with the most SfM
    observations: the same k neighbours apart from ties in the float32
    matrix. Returns the failures."""
    import torch
    from gs_init_tpu_torch.mdi.points_from_depth import project_sfm_points
    from gs_init_tpu_torch.ops.knn import knn_self

    train = [parser.images[int(i)] for i in parser.split_indices("train")]
    im = max(train, key=lambda im: len(parser.point_indices[im.name]))
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    idx = parser.point_indices[im.name]
    pix, _, ok = project_sfm_points(t(parser.points[idx]), torch.ones(len(idx), dtype=torch.bool),
                                    torch.linalg.inv(t(im.camtoworld)), t(im.K), im.width, im.height)
    p = pix.numpy()[ok.numpy()]
    with HostRss() as rss:
        t0 = time.perf_counter()
        d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
        want = np.argsort(d2, axis=1)[:, 1 : k + 1]
        t_sort = time.perf_counter() - t0
    t0 = time.perf_counter()
    q64 = p.astype(np.float64)
    got = knn_self(torch.as_tensor(q64 - q64.mean(0), device=dev), k + 1)[1][:, 1:].cpu().numpy()
    t_knn = time.perf_counter() - t0
    rows = np.arange(len(p))[:, None]
    apart = got != want
    untied = apart & (d2[rows, got] != d2[rows, want])
    log(f"  [{card}] the scale-outlier test's {k} pixel neighbours on {im.name} (M = {len(p)}): knn_self on the card "
        f"{t_knn:.4f} s; the [M, M] sort on the host {t_sort:.4f} s, host RSS growth {rss.growth:.3f} GiB; "
        f"{int(apart.sum())} of {apart.size} apart, {int(untied.sum())} of them not at a tie")
    if int(untied.sum()):
        return [f"the pixel neighbours disagree with the sort at {int(untied.sum())} untied places"]
    return []


# The scale-outlier test at the M of a densely observed image: seeded
# pixels over the frame, scale factors on a smooth field with noise, a
# share of them multiplied by 1.5-3 (the outliers). The JAX form's [M, M]
# float32 distance matrix alone is 6.4 GB here, its argsort 12.8 GB.
OUTLIER_M = 40_000
OUTLIER_SHARE = 0.02
# The test must drop at least this share of the injected outliers and keep
# at least this share of the rest.
OUTLIER_FOUND_MIN = 0.9
INLIER_KEPT_MIN = 0.9


def scale_outliers_at_scale(card, dev, width=1296, height=840, seed=12):
    """interp._scale_outliers on the card at M = OUTLIER_M, with the
    interpolation's default thresholds: its host RSS growth held under
    MDI_HOST_RSS_GIB, the injected outliers found. Returns the failures."""
    import torch
    from gs_init_tpu_torch.config.config import InterpolatedAlignmentConfig
    from gs_init_tpu_torch.mdi.alignment.interp import _scale_outliers

    rng = np.random.default_rng(seed)
    m = OUTLIER_M
    pix = rng.uniform([0, 0], [width, height], (m, 2)).astype(np.float32)
    f = (1 + 1e-4 * (pix[:, 0] - width / 2) / width + rng.normal(0, 1e-3, m)).astype(np.float32)
    out = np.zeros(m, bool)
    out[rng.choice(m, int(OUTLIER_SHARE * m), replace=False)] = True
    f[out] *= rng.uniform(1.5, 3.0, int(out.sum())).astype(np.float32)
    icfg = InterpolatedAlignmentConfig()
    with HostRss() as rss:
        t0 = time.perf_counter()
        keep = _scale_outliers(pix, f, np.ones(m, bool), knn_k=icfg.knn_median_neighbors,
                               knn_threshold=icfg.knn_median_threshold, lof_k=icfg.lof_neighbors,
                               lof_threshold=icfg.lof_threshold, device=dev)
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
    found, kept = float((~keep[out]).mean()), float(keep[~out].mean())
    log(f"  [{card}] the scale-outlier test at M = {m} (seeded pixels over {width}x{height}, {int(out.sum())} "
        f"outliers): {secs:.3f} s on the card; host RSS growth {rss.growth:.3f} GiB (getrusage peak "
        f"{rss.maxrss_growth:.3f} GiB); outliers dropped {found:.4f}, the rest kept {kept:.4f}")
    failures = []
    if rss.growth > MDI_HOST_RSS_GIB:
        failures.append(f"the scale-outlier test at M = {m}: host RSS grew {rss.growth:.3f} GiB")
    if found < OUTLIER_FOUND_MIN or kept < INLIER_KEPT_MIN:
        failures.append(f"the scale-outlier test at M = {m}: dropped {found:.4f} of the outliers, kept {kept:.4f} "
                        "of the rest")
    return failures


def voxel_arm(dev, card, probe, data_dir, res, native_points):
    """Arm (g): the voxel merge in place of the native one, on arm (f)'s
    cloud after its LOF. Returns the failures."""
    import torch
    from gs_init_tpu_torch.mdi.postprocess import postprocess_point_cloud

    cfg = arm_config(data_dir, res, ["--mdi.postprocess.merge_subsample=true", *VOXEL])
    pts, rgbs = probe.lof_out
    timings = {}
    torch.cuda.reset_peak_memory_stats(dev)
    with HostRss() as rss:
        t0 = time.perf_counter()
        out, _ = postprocess_point_cloud(cfg, pts, rgbs, *probe.post_args, device=dev, timings=timings)
        secs = time.perf_counter() - t0
    log(f"  [{card}] (g) voxel merge on arm (f)'s {len(pts)} points after LOF: {len(out)} points out (the native "
        f"merge: {native_points}); {secs:.3f} s: extents {timings['extents'][0]:.3f} s, merge "
        f"{timings['merge'][0]:.3f} s; card peak {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; host RSS "
        f"growth {rss.growth:.3f} GiB")
    if not (len(out) >= MDI_MIN_POINTS and np.isfinite(out).all()):
        return [f"(g) no finite cloud of {MDI_MIN_POINTS} points ({len(out)})"]
    return []


def mdi_configurations(dev, card, garden):
    """Phase 12: the monocular-depth init's other configurations at garden
    scale on phase 11's scene with every observation (garden_files), each
    through parse_cli and
    pts_and_rgb_from_monocular_depth on the card; arm (b) as the init of a
    training run; the deterministic arms card against CPU."""
    from gs_init_tpu_torch.datasets.parser import Parser

    t_phase = time.perf_counter()
    _, _, depths, data_dir = garden
    parser = Parser(data_dir, factor=1, test_every=GARDEN_TEST_EVERY)
    want_scale = float(np.cbrt(np.linalg.det(parser.transform[:3, :3]))) / 0.37
    log(f"  [{card}] the model with every observation read in {time.perf_counter() - t_phase:.3f} s")
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        for tag, name, overrides, cameras in MDI_ARMS:
            with LofProbe(dev) as lof:
                f, probe, (pts, _), cfg = run_arm(dev, card, tag, name, overrides, cameras, data_dir, parser, depths,
                                                  want_scale, os.path.join(tmp, tag))
            failures += f
            if tag == "f":
                n_in, n_kept = len(lof.calls[-1]["points"]), len(probe.lof_out[0])
                log(f"  [{card}] (f) LOF kept {n_kept} of {n_in} points, dropped {1 - n_kept / n_in:.4f}")
                if n_kept < LOF_KEEP_MIN * n_in:
                    failures.append(f"(f) LOF kept {n_kept} of {n_in} points")
                failures += lof_against_brute_force(card, lof.calls[-1], dev)
                lof.calls.clear()
                failures += voxel_arm(dev, card, probe, data_dir, os.path.join(tmp, "g"), len(pts))
            del probe, pts
            release()
        failures += pixel_knn_against_sort(card, parser, dev)
        failures += scale_outliers_at_scale(card, dev)
        failures += mdi_training(dev, card, data_dir, first_cameras(parser, ARM_CAMERAS), depths, want_scale,
                                 os.path.join(tmp, "train"), MDI_TRAIN_STEPS)
        release()
        failures += card_against_cpu(dev, card, data_dir, parser, depths, os.path.join(tmp, "cpu"))
    log(f"  [{card}] phase 12 took {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise RuntimeError("phase 12: " + "; ".join(failures))


# ----------------------------------------------------------------- phase 13
# The depth cache and the Runner on a mesh at garden scale, on phase 11's
# scene (GARDEN_FULL: 161 training images at 1296x840, 100,000 SfM points).
# (a) The default predictor (Metric3D large, random weights) writes the
# cache in a cold init, and a warm init reads it back with a predictor that
# raises. (b) Two gloo ranks on cuda:0 run the default preset at its own
# capacity of 1,000,000 on a 1x2 gaussian-sharded mesh from a cache of the
# stub's predictions, beside a one-rank Runner from the same cache.
# (a) runs on the first CACHE_CAMERAS cameras (36 training images), so that
# the script keeps within its time: 161 images took 50.1 s cold and 13.8 s
# warm (NVIDIA H100 80GB HBM3, 700 W); (b) keeps all 161.
CACHE_CAMERAS = 41
# Every entry of the cache, per image: depth [H, W] float32, mask [H, W]
# bool, normal [H, W, 3] float32 (the JAX layout, mdi/init.py); the stub
# writes no normal.
CACHE_KEYS = {"depth": ("<f4", ()), "mask": ("|b1", ()), "normal": ("<f4", (3,))}
# (b): MESH_STEPS steps, refines at 100 and 200 (refine_start_iter 50).
MESH_STEPS = 300
MESH_OVERRIDES = ["--strategy.refine_start_iter=50"]
# (b)'s loss against the one-rank run: over the first CURVE_STEPS steps
# within MESH_CURVE_RTOL, to step 99 within MESH_PRE_REFINE_RTOL. Phase 9
# (c)'s CURVE_RTOL and PRE_REFINE_RTOL are too tight at 1M gaussians and
# 1296x840: K2 sums each gaussian's gradient with float atomics, so two
# one-rank runs of this config from the same state part by 1.281e-4 and
# 2.726e-4 over steps 0-11, 1.786e-3 and 3.413e-3 over 0-99, in two calls
# of chip_measure.py curve-witness (0 at steps 0 and 1, then Adam turns
# the rounding of near-zero gradients into whole steps). The 1x2 mesh
# against the one-rank run in three runs: 1.616e-4 and 9.180e-3, 5.544e-5
# and 1.116e-3, 1.240e-4 and 9.435e-3, with alive counts after the refines
# within 67 of a million and eval PSNR within 0.001 dB (NVIDIA H100 80GB
# HBM3, 700 W). Each tolerance is 2.4x the largest of these gaps, as
# PRE_REFINE_RTOL is.
MESH_CURVE_RTOL = 6.5e-4
MESH_PRE_REFINE_RTOL = 2.3e-2
# The mesh run's eval PSNR against the one-rank run's, in dB (fixed before
# the first run, PERF.md §6: phase 9 (c)'s runs came within 0.006 dB at 200
# steps; refines on two runs whose gradients differ by float atomics may
# grant other slots).
MESH_PSNR_ATOL = 0.1


class NoPredictor:
    """A depth predictor that must not be asked: every image is cached."""

    name = "stub"

    def predict_depth_batch(self, images, intrinsics):
        raise RuntimeError("phase 13: a depth prediction was asked for an image the cache holds")


def cache_files(cache_dir):
    """Every file under cache_dir, sorted."""
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(cache_dir) for f in fs)


def entry_layout(path):
    """{key: (dtype, shape)} of one cache entry, read from its members'
    headers (the arrays are not read)."""
    import zipfile

    out = {}
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            with z.open(name) as f:
                version = np.lib.format.read_magic(f)
                read = np.lib.format.read_array_header_1_0 if version == (1, 0) else np.lib.format.read_array_header_2_0
                shape, _, dtype = read(f)
            out[name[:-4] if name.endswith(".npy") else name] = (dtype.str, tuple(shape))
    return out


def check_cache(cache_dir, parser, failures, tag, keys):
    """The cache holds one .npz per training image in the JAX layout at the
    image's size with exactly `keys`, and nothing else (no *.tmp). Returns
    (entries, bytes)."""
    files = cache_files(cache_dir)
    train = [parser.images[int(i)] for i in parser.split_indices("train")]
    want = {im.name.replace("/", "_") + ".npz" for im in train}
    if {os.path.basename(p) for p in files} != want or len(files) != len(train):
        failures.append(f"{tag}: the cache holds {len(files)} files, not one .npz per training image ({len(train)})"
                        f"; left-overs {[p for p in files if not p.endswith('.npz')][:3]}")
    h, w = train[0].height, train[0].width
    good = {k: (CACHE_KEYS[k][0], (h, w) + CACHE_KEYS[k][1]) for k in keys}
    for p in files:
        layout = entry_layout(p)
        if layout != good:
            failures.append(f"{tag}: entry {os.path.basename(p)} holds {layout}, not {good}")
            break
    return len(files), sum(os.path.getsize(p) for p in files)


def init_report(card, tag, per, secs, rss, peak, pts, net_seconds=None):
    """One line of (a): seconds per image by stage, the init's seconds."""
    n = len(per)
    stage = lambda k: sum(r["stages"].get(k, 0.0) for r in per) / max(n, 1)
    rest = sum(r["seconds"] - sum(v for k, v in r["stages"].items() if k != "predict") for r in per) / max(n, 1)
    read = (f"predict {stage('predict'):.4f} (the network {net_seconds / n:.4f}, the cache write "
            f"{stage('predict') - net_seconds / n:.4f})" if net_seconds is not None
            else f"the cache read {stage('predict'):.4f}")
    log(f"  [{card}] (a) {tag}: {n} images in {secs:.3f} s ({secs / max(n, 1):.4f} s per image): {read}, "
        f"align_and_unproject {stage('align_and_unproject'):.4f}, host rest {rest:.4f}; {len(pts)} points; card "
        f"peak {peak:.3f} GiB; host RSS growth {rss.growth:.3f} GiB (getrusage peak {rss.maxrss_growth:.3f} GiB)")


def depth_cache_default_predictor(dev, card, garden, tmp):
    """Phase 13 (a): parse_cli with the default predictor and backbone
    (Metric3D large, random weights) and the cache in tmp; a cold init that
    predicts and writes every entry, a warm init that reads them all."""
    import shutil

    import torch
    from gs_init_tpu_torch import trainer
    from gs_init_tpu_torch.config import parse_cli
    from gs_init_tpu_torch.mdi.init import pts_and_rgb_from_monocular_depth
    from gs_init_tpu_torch.mdi.predictors.interface import pick_model

    now = time.perf_counter
    failures = []
    data_dir, parser, _, _ = garden
    parser = first_cameras(parser, CACHE_CAMERAS)
    cache = os.path.join(tmp, "depth_cache")
    cfg = parse_cli(["default", f"--data_dir={data_dir}", "--data_factor=1", f"--result_dir={os.path.join(tmp, 'a')}",
                     "--init_type=monocular_depth", "--mdi.allow_random_weights=true", f"--mdi.cache_dir={cache}"],
                    trainer.build_presets())
    cfg.adjust_steps()
    m = cfg.mdi
    if (m.predictor, m.backbone, m.use_cache) != ("metric3d", "vitl", True):
        failures.append(f"(a): parse_cli gave predictor {m.predictor}, backbone {m.backbone}, cache {m.use_cache}")
    free = shutil.disk_usage(tmp).free / 2**30
    t0 = now()
    model = TimedPredictor(pick_model(cfg, device=dev))
    t_build = now() - t0
    log(f"  [{card}] (a) {m.predictor} {m.backbone} (random weights) built in {t_build:.3f} s; batch "
        f"{m.predict_batch_size}; cache {cache} ({free:.1f} GiB free there)")
    def init(tag, predictor):
        release()
        torch.cuda.reset_peak_memory_stats(dev)
        per, summary = [], {}
        with HostRss() as rss:
            t0 = now()
            pts, rgb = pts_and_rgb_from_monocular_depth(cfg, parser, model=predictor, device=dev, per_image=per,
                                                        summary=summary)
            secs = now() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        init_report(card, tag, per, secs, rss, peak, pts, getattr(predictor, "seconds", None))
        if not (len(pts) > len(parser.points) and np.isfinite(pts).all() and np.isfinite(rgb).all()):
            failures.append(f"(a) {tag}: no usable cloud ({len(pts)} points)")
        return dict(pts=pts, rgb=rgb, fits=[(r["name"], r["scale"], r["shift"]) for r in per])

    cold = init("cold", model)
    del model  # the network's weights leave the card before the warm init
    n_files, n_bytes = check_cache(cache, parser, failures, "(a)", tuple(CACHE_KEYS))
    log(f"  [{card}] (a) the cache: {n_files} entries, {n_bytes} bytes ({n_bytes / max(n_files, 1) / 1e6:.2f} MB an "
        f"entry) in {cache}")
    warm = init("warm", NoPredictor())
    same = (np.array_equal(cold["pts"], warm["pts"]) and np.array_equal(cold["rgb"], warm["rgb"])
            and cold["fits"] == warm["fits"])
    log(f"  [{card}] (a) the warm cloud against the cold one: {'equal to the bit' if same else 'DIFFERENT'} "
        f"(points, colours, {len(cold['fits'])} per-image scales and shifts)")
    if not same:
        failures.append("(a): the warm init's cloud differs from the cold one")
    if check_cache(cache, parser, failures, "(a) after the warm init", tuple(CACHE_KEYS)) != (n_files, n_bytes):
        failures.append("(a): the warm init changed the cache")
    shutil.rmtree(cache)
    return failures


def write_stub_cache(cache_dir, data_dir, parser, depths):
    """Phase 11's stub predictions (depth_stub over the surface depths), one
    JAX-layout entry per training image under the stub predictor's key."""
    import types

    from gs_init_tpu_torch.mdi.init import _cache_path

    cfg = types.SimpleNamespace(data_dir=data_dir, mdi=types.SimpleNamespace(cache_dir=cache_dir, predictor="stub"))
    stub = depth_stub(depths)
    for i in parser.split_indices("train"):
        out = stub.predict_depth(np.empty((0, 0, 3)), None)
        with open(_cache_path(cfg, parser.images[int(i)].name), "wb") as f:
            np.savez(f, depth=out.depth, mask=out.mask)


class SetupTimers:
    """Times a Runner's set-up: the mdi init (its per-image entries), the
    cloud's broadcast (on a rank other than 0 it waits there for rank 0's
    init), the subset and the kNN scale init."""

    def __enter__(self):
        import torch
        import torch.distributed as dist
        from gs_init_tpu_torch.engine import params as pparams
        from gs_init_tpu_torch.engine import runner as prunner

        sync = torch.cuda.synchronize
        now = time.perf_counter
        self.per, self.init, self.bcast, self.knn, self.sub, self.points = [], 0.0, 0.0, 0.0, 0.0, 0
        real = dict(mdi=prunner.pts_and_rgb_from_monocular_depth, knn=pparams.mean_knn_dist,
                    init=prunner.init_from_points, bcast=dist.broadcast)
        self.undo = [(prunner, "pts_and_rgb_from_monocular_depth", real["mdi"]),
                     (pparams, "mean_knn_dist", real["knn"]), (prunner, "init_from_points", real["init"]),
                     (dist, "broadcast", real["bcast"])]

        def mdi(*a, **kw):
            t0 = now()
            out = real["mdi"](*a, per_image=self.per, **kw)
            self.init += now() - t0
            self.points = len(out[0])
            return out

        def timed(key, fn):
            def f(*a, **kw):
                sync()
                t0 = now()
                out = fn(*a, **kw)
                sync()
                setattr(self, key, getattr(self, key) + now() - t0)
                return out
            return f

        prunner.pts_and_rgb_from_monocular_depth = mdi
        pparams.mean_knn_dist = timed("knn", real["knn"])
        prunner.init_from_points = timed("sub", real["init"])
        dist.broadcast = timed("bcast", real["bcast"])
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self.undo:
            setattr(obj, name, fn)
        self.sub -= self.knn  # init_from_points holds the kNN
        return False


def whole_digest(runner):
    """sha1 of the whole state's alive mask and means (gathered under a
    mesh: a collective)."""
    import hashlib

    g = runner.full_gstate()
    h = hashlib.sha1(g.alive.cpu().numpy().tobytes())
    h.update(g.params.means.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def cached_run(argv, dev, sharded):
    """Phase 13 (b)'s run on a mesh rank or on one device: parse_cli ->
    Runner(cfg, mdi_model=NoPredictor()) from the stub's cache -> eval of
    the initial gaussians -> train(), then (sharded) ckpt.save_sharded.
    Hooks record each step's loss, the host clock every 100 steps, each
    step's CUDA-event marks (a sharded step has them), each refine with the
    gather and slice of _whole_state and its grants, each retune decision,
    the eval renders and the checkpoints. Returns the record and the
    Runner."""
    import torch
    from gs_init_tpu_torch import kernels, trainer
    from gs_init_tpu_torch.config import parse_cli
    from gs_init_tpu_torch.engine import ckpt
    from gs_init_tpu_torch.engine import runner as prunner
    from gs_init_tpu_torch.engine.strategy import default as dstrat
    from gs_init_tpu_torch.parallel import shard as pshard

    now = time.perf_counter
    sync = lambda: torch.cuda.synchronize(dev)
    cfg = parse_cli(argv, trainer.build_presets())
    cfg.adjust_steps()
    steps = cfg.max_steps
    torch.cuda.reset_peak_memory_stats(dev)
    with SetupTimers() as st:
        t0 = now()
        runner = prunner.Runner(cfg, mdi_model=NoPredictor(), device=dev)
        sync()
        t_setup = now() - t0
    setup_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    rec = dict(setup=dict(total=t_setup, init=st.init, broadcast=st.bcast, subset=st.sub, knn=st.knn, peak=setup_peak),
               read=len(st.per), read_s=sum(r["stages"]["predict"] for r in st.per), alive0=runner.num_gaussians(),
               digest=whole_digest(runner), n_val=len(runner.valset), mesh=None if runner.mesh is None else
               runner.mesh.shape, points=st.points, loss=[], mark={}, events=[], refine=[], retune=[], renders=0,
               eval={})
    patches = []

    def patch(obj, name, fn):
        patches.append((obj, name, getattr(obj, name)))
        setattr(obj, name, fn)

    real_rast, real_alloc, real_refine = prunner.rasterize, dstrat._alloc_slots, dstrat.refine
    real_gather, real_local = pshard.global_state, pshard.local_state
    real_iter, real_step, real_whole = runner.train_iteration, runner.step_fn, runner._whole_state
    real_retune, real_save, real_eval = runner._maybe_retune_capacity, runner.save, runner.eval
    grants, moves = [], []

    def counted_rast(*a, **kw):
        rec["renders"] += 1
        return real_rast(*a, **kw)

    def spy_alloc(alive, cand):
        dst, ok = real_alloc(alive, cand)
        grants.append((int(cand.sum()), int((~alive).sum()), int(ok.sum())))
        return dst, ok

    def timed_refine(*a, **kw):
        out = real_refine(*a, **kw)
        rec["refine"].append(dict(step=a[-1], alive=int(out[0].alive.sum()), **dict(zip(("cand", "free", "granted"),
                                                                                      grants[-1])), **out[3]))
        return out

    def timed_move(fn, key):
        def f(*a, **kw):
            sync()
            t0 = now()
            out = fn(*a, **kw)
            sync()
            moves.append((key, now() - t0))
            return out
        return f

    def whole(fn):
        moves.clear()
        pshard.global_state, pshard.local_state = timed_move(real_gather, "gather"), timed_move(real_local, "slice")
        try:
            sync()
            t0 = now()
            real_whole(fn)
            sync()
            ms = (now() - t0) * 1e3
        finally:
            pshard.global_state, pshard.local_state = real_gather, real_local
        parts = {k: sum(s for kk, s in moves if kk == k) * 1e3 for k in ("gather", "slice")}
        rec["refine"][-1].update(ms=ms, **{f"{k}_ms": v for k, v in parts.items()})

    def hooked(step):
        if step % 100 == 0:
            sync()
            rec["mark"][step] = now()
        m = real_iter(step)
        rec["loss"].append(m["loss"].detach())
        if step == steps - 1:
            sync()
            rec["mark"][steps] = now()
        return m

    def marked(*a, **kw):
        ev = {}

        def mark(k):
            ev[k] = torch.cuda.Event(enable_timing=True)
            ev[k].record()

        mark("start")
        out = real_step(*a, mark=mark, **kw)
        mark("end")
        rec["events"].append(ev)
        return out

    def counted_retune(metrics, step, **kw):
        before = cfg.pair_capacity
        real_retune(metrics, step, **kw)
        rec["retune"].append((step, before, cfg.pair_capacity))

    def timed_eval(step, *a, **kw):
        t0 = now()
        out = real_eval(step, *a, **kw)
        rec["eval"][step] = dict(out, secs=now() - t0)
        return out

    def timed_save(step):
        sync()
        t0 = now()
        path = real_save(step)
        rec["save"] = dict(path=path, secs=now() - t0, bytes=os.path.getsize(path) if runner.is_main else 0)
        return path

    # The Runner is dropped after this run: its hooks stay on it.
    runner.eval, runner.train_iteration, runner._whole_state = timed_eval, hooked, whole
    runner._maybe_retune_capacity, runner.save = counted_retune, timed_save
    if sharded:
        runner.step_fn = marked
    try:
        patch(prunner, "rasterize", counted_rast)
        runner.eval(0)
        rec["renders"] = 0
        patch(dstrat, "_alloc_slots", spy_alloc)
        patch(dstrat, "refine", timed_refine)
        kernels.reset_launch_counts()
        t0 = now()
        stats = runner.train()
        sync()
        rec["train_s"] = now() - t0
        rec["launches"] = {k: kernels.LAUNCHES[k] for k in ("composite_fwd", "composite_bwd", "scan_probe")}
    finally:
        for obj, name, fn in reversed(patches):
            setattr(obj, name, fn)
    rec.update(psnr0=rec["eval"][0]["psnr"], psnr=rec["eval"][steps]["psnr"], num_GS=stats["num_GS"],
               pair_capacity=cfg.pair_capacity, peak=torch.cuda.max_memory_allocated(dev) / 2**30,
               loss=[float(x) for x in torch.stack(rec["loss"]).cpu()])
    marks = sorted(rec["mark"])
    rec["segments"] = [(a, b, (b - a) / (rec["mark"][b] - rec["mark"][a])) for a, b in zip(marks, marks[1:])]
    if sharded:
        names = list(rec["events"][0])
        phase = lambda ev, k: ev[names[names.index(k) - 1]].elapsed_time(ev[k])
        rec["step_ms"] = [ev["start"].elapsed_time(ev["end"]) for ev in rec["events"]]
        rec["gather_ms"] = [phase(ev, "gather") for ev in rec["events"]]
        rec["backward_ms"] = [phase(ev, "backward") for ev in rec["events"]]
        rec["reduce_ms"] = [phase(ev, "reduce") for ev in rec["events"]]
        sync()
        t0 = now()
        rec["sharded"] = ckpt.save_sharded(runner, steps)
        rec["sharded_s"] = now() - t0
        rec["sharded_bytes"] = sum(os.path.getsize(p) for p in cache_files(rec["sharded"]))
    del rec["events"]
    return rec, runner


def curve_gaps(loss, ref):
    """|loss - ref| / |ref| at each step."""
    return [abs(a - b) / abs(b) for a, b in zip(loss, ref)]


def mesh_rank(rank, world, port, argv, device, q):
    """Phase 13 (b) worker: one rank of a gloo group on `device` (the ranks
    share cuda:0) running cached_run on the mesh that argv names."""
    try:
        import torch
        import torch.distributed as dist

        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
        with HostRss() as rss:
            rec, runner = cached_run(argv, dev, sharded=True)
            del runner
        rec.update(rss=rss.growth, rss_peak=rss.peak / 2**30)
        dist.destroy_process_group()
        q.put((rank, "ok", rec))
    except BaseException:
        import traceback

        q.put((rank, "error", traceback.format_exc()))


def rank_report(card, tag, r):
    """(b)'s lines for one run (a mesh rank or the one-rank run)."""
    s = r["setup"]
    med = lambda k: f"{np.median(r[k]):.3f} (mean {np.mean(r[k]):.3f})"
    log(f"  [{card}] (b) {tag}: set-up {s['total']:.3f} s: init {s['init']:.3f} s ({r['read']} cache entries read in "
        f"{r['read_s']:.3f} s, {r['points']} points), broadcast {s['broadcast']:.3f} s, subset {s['subset']:.3f} s, "
        f"kNN {s['knn']:.3f} s; peak {s['peak']:.3f} GiB; alive {r['alive0']}; eval of the initial gaussians "
        f"{r['eval'][0]['secs']:.3f} s")
    log(f"      steps/s by 100-step segment (refines inside): "
        + ", ".join(f"[{a}, {b}) {v:.3f}" for a, b, v in r["segments"]) + f"; {MESH_STEPS} steps and eval in "
        f"{r['train_s']:.3f} s")
    if "step_ms" in r:
        log(f"      ms per step (CUDA events, median over {len(r['step_ms'])} steps): step {med('step_ms')}, "
            f"all-gather {med('gather_ms')}, backward (its reduce-scatter inside) {med('backward_ms')}, gradient "
            f"all-reduce {med('reduce_ms')}")
    log("      refines (step: ms, gather and slice of the state ms; candidates, free, granted; dup/split/pruned; "
        "alive after): " + "; ".join(
            f"{x['step']}: {x['ms']:.3f}, {x.get('gather_ms', 0.0):.3f} + {x.get('slice_ms', 0.0):.3f}; {x['cand']}, "
            f"{x['free']}, {x['granted']}; {x['n_dup']}/{x['n_split']}/{x['n_pruned']}; {x['alive']}"
            for x in r["refine"]))
    log(f"      retunes (step, before, after): {r['retune']}; eval PSNR {r['psnr0']:.4f} -> {r['psnr']:.4f} "
        f"({r['eval'][MESH_STEPS]['secs']:.3f} s, {r['n_val']} images); launches {json.dumps(r['launches'])}, "
        f"renders {r['renders']}; npz {r['save']['bytes']} bytes in {r['save']['secs']:.3f} s"
        + (f"; shards {r['sharded_bytes']} bytes in {r['sharded_s']:.3f} s" if "sharded" in r else "")
        + f"; card peak {r['peak']:.3f} GiB" + (f"; host RSS growth {r['rss']:.3f} GiB (peak {r['rss_peak']:.3f} "
                                                  f"GiB)" if "rss" in r else ""))


def mesh_at_capacity(dev, card, data_dir, parser, depths, tmp):
    """Phase 13 (b): the stub's cache, two gloo ranks on a 1x2 mesh at the
    default capacity beside the one-rank Runner, the sharded restore and
    the eval-only restart of rank 0's npz."""
    import torch
    from gs_init_tpu_torch import trainer
    from gs_init_tpu_torch.engine import ckpt

    now = time.perf_counter
    failures = []
    cache = os.path.join(tmp, "stub_cache")
    t0 = now()
    write_stub_cache(cache, data_dir, parser, depths)
    n_files, n_bytes = check_cache(cache, parser, failures, "(b) the stub's cache", ("depth", "mask"))
    log(f"  [{card}] (b) the stub's cache: {n_files} entries, {n_bytes} bytes, written in {now() - t0:.3f} s")
    common = ["default", f"--data_dir={data_dir}", "--data_factor=1", f"--max_steps={MESH_STEPS}",
              f"--eval_steps=[{MESH_STEPS}]", f"--save_steps=[{MESH_STEPS}]", "--init_type=monocular_depth",
              "--mdi.predictor=stub", f"--mdi.cache_dir={cache}", *MESH_OVERRIDES]
    t0 = now()
    ranks = spawn_ranks(mesh_rank, 2, common + [f"--result_dir={os.path.join(tmp, 'mesh')}", "--mesh=1x2"], str(dev))
    log(f"  [{card}] (b) two ranks on cuda:0 over gloo, mesh 1x2 (shared-card figures, not scaling): "
        f"{now() - t0:.1f} s with start-up")
    release()
    one, r1 = cached_run(common + [f"--result_dir={os.path.join(tmp, 'one')}", "--mesh=off"], dev, sharded=False)
    for i, r in enumerate(ranks):
        rank_report(card, f"rank {i}", r)
    rank_report(card, "one rank", one)
    r0 = ranks[0]
    n_train = len(parser.split_indices("train"))
    gaps = curve_gaps(r0["loss"], one["loss"])
    gap, gap_before = max(gaps[:CURVE_STEPS]), max(gaps[:100])
    ranks_gap = max(abs(a - b) for a, b in zip(ranks[0]["loss"], ranks[1]["loss"]))
    key = lambda r: [(x["step"], x["alive"], x["cand"], x["free"], x["granted"]) for x in r["refine"]]
    log(f"  [{card}] (b) loss against the one-rank run: max rel gap over steps 0-{CURVE_STEPS - 1} {gap:.3e} (tol "
        f"{MESH_CURVE_RTOL:g}), over steps 0-99 {gap_before:.3e} (tol {MESH_PRE_REFINE_RTOL:g}), at steps 0, 1, 2, 5, 11, 25, "
        f"50, 99 {' '.join(f'{gaps[k]:.1e}' for k in (0, 1, 2, 5, 11, 25, 50, 99))}; the ranks' losses apart by at "
        f"most {ranks_gap:.3e}; initial state: {'the same' if r0['digest'] == one['digest'] else 'DIFFERENT'} on one "
        f"device; refines (step, alive, candidates, free, granted): ranks {key(ranks[0])} and {key(ranks[1])}, one "
        f"rank {key(one)}; eval PSNR {r0['psnr']:.4f}, one rank {one['psnr']:.4f} (|diff| "
        f"{abs(r0['psnr'] - one['psnr']):.4f}, tol {MESH_PSNR_ATOL:g})")
    retune_steps = sorted({s for s, _, _ in r0["retune"] if s % 100 == 0})
    failures += [f"(b): {what}" for bad, what in (
        (r0["read"] != n_train or ranks[1]["read"] != 0, f"cache entries read {[r['read'] for r in ranks]}, not "
                                                         f"[{n_train}, 0]"),
        (any(r["alive0"] != 1_000_000 for r in ranks), f"alive after init {[r['alive0'] for r in ranks]}"),
        (r0["points"] <= 1_000_000, f"a cloud of {r0['points']} points does not exceed the capacity"),
        (ranks[1]["digest"] != r0["digest"], "the ranks' initial states differ"),
        (r0["digest"] != one["digest"], "the mesh's initial state differs from the one-rank Runner's"),
        (gap > MESH_CURVE_RTOL or gap_before > MESH_PRE_REFINE_RTOL, "the loss curve left the one-rank run's"),
        (not all(np.isfinite(r["loss"]).all() for r in ranks), "a non-finite loss"),
        ([x["step"] for x in r0["refine"]] != [100, 200], f"refines at {[x['step'] for x in r0['refine']]}"),
        (key(ranks[0]) != key(ranks[1]), "the ranks' refines differ"),
        (retune_steps != [0, 100, 200] or ranks[1]["retune"] != r0["retune"]
         or ranks[1]["pair_capacity"] != r0["pair_capacity"], f"retunes {r0['retune']}, {ranks[1]['retune']}"),
        (not r0["psnr"] > r0["psnr0"], "eval PSNR did not rise"),
        (abs(r0["psnr"] - one["psnr"]) > MESH_PSNR_ATOL, "eval PSNR away from the one-rank run's"),
        (any(r["psnr"] != r0["psnr"] for r in ranks), "the ranks' eval PSNRs differ"),
    ) if bad]
    for i, r in enumerate(ranks):
        want = dict(composite_fwd=MESH_STEPS + r["renders"], composite_bwd=MESH_STEPS, scan_probe=1)
        if r["launches"] != want or r["renders"] < r["n_val"]:
            failures.append(f"(b): rank {i} launched {r['launches']}, not {want} ({r['renders']} eval renders)")
    release()

    # The sharded checkpoint onto one device (the one-rank run's Runner)
    # against rank 0's npz (the gathered state); then trainer.main --ckpt
    # on that npz.
    npz = r0["save"]["path"]
    t1 = now()
    at = ckpt.load_sharded(r1, r0["sharded"])
    t2 = now()
    sharded = {k: x.clone() for k, (x, _) in runner_arrays(r1, r1).items()}
    t3 = now()
    r1.load(npz)
    t4 = now()
    mism = [k for k, (x, _) in runner_arrays(r1, r1).items() if not torch.equal(x, sharded[k])]
    del r1, sharded
    release()
    t5 = now()
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        trainer.main(["default", f"--data_dir={data_dir}", "--data_factor=1", "--mesh=off",
                      f"--result_dir={os.path.join(tmp, 'restart')}", f"--ckpt=[{npz}]"], device=dev)
    t_restart = now() - t5
    with open(os.path.join(tmp, "restart", "stats", f"val_step{MESH_STEPS}.json")) as f:
        psnr_re = json.load(f)["psnr"]
    log(f"  [{card}] (b) the sharded checkpoint (step {at}) onto the one-rank run's Runner in {t2 - t1:.3f} s: "
        f"{len(mism)} arrays differ from rank 0's npz (loaded in {t4 - t3:.3f} s); eval-only restart "
        f"(trainer.main --ckpt: set-up, load, eval, trajectory) {t_restart:.3f} s, PSNR {psnr_re:.6f} (|diff| "
        f"{abs(psnr_re - r0['psnr']):.2e}, tol {RESTART_PSNR_ATOL:g})")
    if mism or at != MESH_STEPS:
        failures.append(f"(b): the sharded checkpoint restored {mism} unequal (step {at})")
    if abs(psnr_re - r0["psnr"]) > RESTART_PSNR_ATOL:
        failures.append("(b): the eval-only restart did not reproduce the mesh run's PSNR")
    return failures


def cache_and_mesh(dev, card, garden):
    """Phase 13: the depth cache with the default predictor, then the
    Runner on a two-rank mesh at the default capacity, on phase 11's scene."""
    t_phase = time.perf_counter()
    data_dir, parser, depths, _ = garden
    release()
    with tempfile.TemporaryDirectory() as tmp:
        failures = depth_cache_default_predictor(dev, card, garden, tmp)
        release()
        failures += mesh_at_capacity(dev, card, data_dir, parser, depths, tmp)
    log(f"  [{card}] phase 13 took {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise RuntimeError("phase 13: " + "; ".join(failures))


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

    log(f"phase 5: the Runner end to end ({time.perf_counter() - t_start:.1f} s)")
    runner_e2e()

    with tempfile.TemporaryDirectory() as tmp:
        scene, data_dir = clustered_colmap(tmp, 1296, 840, 12, dev)
        log(f"phase 6a: monocular-depth init at full width ({time.perf_counter() - t_start:.1f} s)")
        mdi_init_full_width(dev, scene, data_dir)
        log(f"phase 6b: the three arms, sfm, monocular_depth and sfm+mdi; sfm without prefetch "
            f"({time.perf_counter() - t_start:.1f} s)")
        three_arms(dev)
        log("phase 6c: the depth networks, card against CPU, at full width, and the Runner's metric3d init "
            f"({time.perf_counter() - t_start:.1f} s)")
        depth_card_vs_cpu(dev)
        depth_full_width(dev, scene)
        depth_runner_e2e(dev, data_dir)
        log(f"phase 6d: SAM, card against CPU, ViT-H at 1024, the mask generator and the SAM-segmented init "
            f"({time.perf_counter() - t_start:.1f} s)")
        sam_card_vs_cpu(dev)
        sam_full_width(dev, scene)
        sam_runner_e2e(dev, scene, data_dir)
        image9 = np.array(scene.images[0], np.float32)
    log(f"phase 7: the trainer entry point, both presets, checkpoints and the eval-only restart "
        f"({time.perf_counter() - t_start:.1f} s)")
    trainer_entry()

    log(f"phase 8: eval and integration: LPIPS, the Runner's LPIPS and TensorBoard scalars, a sweep, the Method, "
        f"the live viewer ({time.perf_counter() - t_start:.1f} s)")
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "ckpt"))
        write_lpips_weights(os.path.join(tmp, "ckpt"))
        os.environ["GS_TPU_CHECKPOINT_DIR"] = os.path.join(tmp, "ckpt")
        lpips_card_vs_cpu(dev)
        runner_e2e()
        sweep_e2e(tmp)
        method_e2e(os.path.join(tmp, "data", "scene"), os.path.join(tmp, "method"))
        viewer_e2e(os.path.join(tmp, "data", "scene"), os.path.join(tmp, "viewer"))

    log(f"phase 9: multi-GPU, a one-rank NCCL group, ranks sharing the card, the trainer on a mesh, "
        f"the leftovers ({time.perf_counter() - t_start:.1f} s)")
    t9 = time.perf_counter()
    multi_gpu(dev, image9)
    log(f"  phase 9 took {time.perf_counter() - t9:.1f} s")
    torch.cuda.empty_cache()

    log(f"phase 10: the whole path at garden scale ({time.perf_counter() - t_start:.1f} s)")
    garden_path(dev, card, **GARDEN)
    torch.cuda.empty_cache()

    log(f"phase 11: both presets at their default capacity at garden scale ({time.perf_counter() - t_start:.1f} s)")
    release()
    with tempfile.TemporaryDirectory() as tmp:
        garden = garden_files(dev, card, tmp, **GARDEN_FULL)
        default_capacity(dev, card, garden, DEFAULT_STEPS)
        log(f"phase 12: the mdi configurations at garden scale ({time.perf_counter() - t_start:.1f} s)")
        mdi_configurations(dev, card, garden)
        log(f"phase 13: the depth cache with the default predictor, and the Runner on a two-rank mesh at the "
            f"default capacity ({time.perf_counter() - t_start:.1f} s)")
        cache_and_mesh(dev, card, garden)
        del garden

    log(f"total {time.perf_counter() - t_start:.3f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
