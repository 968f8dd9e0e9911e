"""Training runner — port of ``gs_init_tpu/engine/runner.py`` for one device.

SfM, random or monocular-depth init (``mdi/init.py``: a depth network or
the stub predictor);
the default strategy's refine and opacity-reset cadence or the MCMC
strategy's relocation and noise; pose / appearance / bilateral-grid groups
(with the fixed ``pose_noise`` perturbation applied in the batch); random
patch crops; batches built ``data_prefetch`` ahead on a thread; pair-
capacity retuning (grow on overflow, shrink when far too large); ``save``
/ ``load`` of the whole training state in the JAX package's npz layout
(either package loads the other's checkpoints); ``eval`` with PSNR, SSIM,
LPIPS (when ``ops.lpips.lpips_available()`` finds weights) and, with the
bilateral grid, colour-corrected PSNR; TensorBoard scalars under
``<result_dir>/tb`` at the JAX Runner's tags and cadence (``train/<k>``,
``train/num_GS`` and ``train/mem_peak_gb`` every ``tb_every`` steps,
``<stage>/<k>`` after each eval); the live HTTP viewer (``viewer.py``,
started by ``train()`` unless ``disable_viewer``); trajectory renders as
PNG frames; PLY export; splat compression; a ``torch.profiler`` window.

Multi-GPU (``cfg.mesh`` "DxG", or "auto" over the processes of a
``torch.distributed`` launch; ``parallel/shard.py``): each rank holds its
slice of the gaussian buffers and trains its cameras (or, with
``cfg.shard_pixels``, its tile-row band of every image) through the
sharded step; the capacity is rounded up to a multiple of the gauss axis.
Refine and MCMC relocation gather the state, run the single-device
function identically on every rank (same generator, same draws) and keep
this rank's rows; the MCMC noise and random backgrounds are drawn whole on
every rank and sliced. Eval, save, exports and TensorBoard work from the
gathered state, every rank computing and only rank 0 writing files; the
npz keeps the layout both packages load. The monocular-depth init runs on
rank 0 alone (the depth network, its cache, the exports) and the other
ranks receive its cloud. Rank 0's viewer draws a copy of the state that
is gathered every ``tb_every`` steps; no copy is kept without a viewer.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import trace
from ..config import Config, DefaultStrategyConfig, MCMCStrategyConfig, to_dict
from ..datasets.nerfstudio import open_dataset
from ..datasets.parser import Dataset, Parser
from ..datasets.png import write_png
from ..device import generator, resolve_device
from ..mdi.init import pts_and_rgb_from_monocular_depth
from ..ops.lpips import lpips, lpips_available
from ..ops.render import rasterize
from ..ops.ssim import psnr, ssim
from ..parallel import shard as pshard
from ..utils.mem import device_memory_stats, format_memory_stats
from .appearance import (
    apply_pose_deltas,
    color_correct,
    init_appearance_params,
    init_bilateral_grids,
    init_pose_params,
)
from .optim import AdamState, init_adam_state, make_adam_config
from .params import (
    PARAM_NAMES,
    AuxParams,
    GaussianState,
    aux_from_leaves,
    aux_leaves,
    init_from_points,
    init_random,
    num_alive,
    params_from_numpy,
)
from .strategy import default as dstrat
from .strategy import mcmc
from .train_step import Batch, init_aux_opt, make_train_step


def snug_pair_capacity(demand: int) -> int:
    """The pair table for a demand of ``demand`` pairs: 1.2x headroom,
    rounded up to 64k (or to a power of 2 below it), at least 16k, so a
    multiple of any power-of-two chunk up to 16k."""
    gran = 1 << 16
    want = max(int(demand * 1.2), 1 << 14)
    return -(-want // gran) * gran if want > gran else 1 << (want - 1).bit_length()


def retuned_pair_capacity(peak: int, overflow: int, cap: int) -> int:
    """The capacity after seeing a peak demand of ``peak`` pairs (overflow
    included): grow to the snug size when pairs overflowed ``cap``, shrink
    to it when ``cap`` is over 1.33x of it, else keep ``cap``."""
    want = snug_pair_capacity(peak)
    if overflow > 0 and want > cap:
        return want
    if want < int(cap * 0.75):
        return want
    return cap


def resolve_mesh(cfg, world: Optional[int] = None):
    """The (data, gauss) mesh shape from ``cfg.mesh`` and the processes of
    the launch (``world``, default the process group's size); None means
    the single-device step. "auto" takes every process: bands over all of
    them with ``shard_pixels``, else gcd(batch, world) data shards and the
    rest gaussian shards."""
    if cfg.mesh == "off":
        return None
    if cfg.mesh == "auto":
        n = world if world is not None else (dist.get_world_size() if dist.is_initialized() else 1)
        if n <= 1:
            return None
        if cfg.shard_pixels:
            # Bands divide the binning and compositing; gaussians stay
            # whole unless a "DxG" mesh shards them.
            return n, 1
        n_data = math.gcd(cfg.batch_size, n)
        return n_data, n // n_data
    d, g = cfg.mesh.lower().split("x")
    return int(d), int(g)


class Runner:
    train_step: int = -1  # live progress, read by the viewer's /status
    viewer = None

    def __init__(
        self,
        cfg: Config,
        parser: Optional[Parser] = None,
        trainset: Optional[Dataset] = None,
        valset: Optional[Dataset] = None,
        device=None,
        mdi_model=None,  # a depth predictor for monocular-depth init (tests, e2e)
    ):
        if cfg.trace:  # from here on, so that the set-up's spans are in the report
            trace.enable(resolve_device(device))
            trace.reset()
        with trace.span("runner.setup"):
            self._setup(cfg, parser, trainset, valset, device, mdi_model)

    def _setup(self, cfg, parser, trainset, valset, device, mdi_model):
        self.cfg = cfg
        self._mdi_model = mdi_model
        self.device = resolve_device(device)
        self.parser = parser or open_dataset(
            cfg.data_dir, factor=cfg.data_factor, normalize=cfg.normalize_world_space,
            test_every=cfg.test_every,
        )
        cache_bytes = int(cfg.image_cache_gb * (1 << 30))
        self.trainset = trainset or Dataset(
            self.parser, "train", load_depths=cfg.depth_loss, patch_size=cfg.patch_size,
            cache_bytes=cache_bytes, rng=np.random.RandomState(cfg.seed),
        )
        self.valset = valset or Dataset(self.parser, "val", cache_bytes=cache_bytes)
        self.scene_scale = self.parser.scene_scale * 1.1 * cfg.global_scale
        for sub in ("ckpts", "stats", "renders", "tb"):
            os.makedirs(os.path.join(cfg.result_dir, sub), exist_ok=True)
        self.height, self.width = self.trainset[0]["image"].shape[:2]
        self.is_main = not dist.is_initialized() or dist.get_rank() == 0  # writes the files
        self._init_mesh()

        self.gen = generator(cfg.seed, self.device)  # init, splits, relocation, backgrounds
        self.host_gen = generator(cfg.seed)  # batch order without the prefetcher
        self._init_gaussians()
        self.acfg = make_adam_config(cfg, self.scene_scale, cfg.batch_size)
        self.adam = init_adam_state(self.gstate.params)
        if isinstance(cfg.strategy, DefaultStrategyConfig):
            self._strategy_kind = "default"
        elif isinstance(cfg.strategy, MCMCStrategyConfig):
            self._strategy_kind = "mcmc"
        else:
            raise ValueError(f"unknown strategy {cfg.strategy!r}")
        self.sstate = dstrat.init_state(cfg.max_gaussians, self.device)
        if self.mesh is not None:  # every rank built the whole state alike: keep this rank's rows
            self.gstate, self.adam, self.sstate = pshard.local_state(self.gstate, self.adam, self.sstate, self.mesh)
        self._view = None
        self.refresh_view()
        self._init_aux()
        if self.mesh is None:
            self.step_fn = make_train_step(cfg, self.acfg, self.width, self.height)
        elif cfg.shard_pixels:
            self.step_fn = pshard.make_band_sharded_train_step(cfg, self.acfg, self.width, self.height, self.mesh)
        else:
            self.step_fn = pshard.make_sharded_train_step(cfg, self.acfg, self.width, self.height, self.mesh)
        self.global_step = 0
        self._perm: List[int] = []
        self._pairs_max = 0
        self._prefetcher = None
        self._profiler = None
        self._phase_times = {"data": 0.0}
        self._writer = None
        # Held by each train iteration and by the viewer's renders: a step
        # updates the parameters in place, so a render must not overlap one.
        self.lock = threading.RLock()
        if self.is_main:
            with open(os.path.join(cfg.result_dir, "cfg.json"), "w") as f:
                json.dump(to_dict(cfg), f, indent=2, default=str)

    # ------------------------------------------------------------- set up

    def _init_mesh(self):
        """Build the (data x gauss) mesh before any state, so that the
        capacity can be rounded to the gauss axis; none for one device."""
        cfg = self.cfg
        self.mesh = None
        shape = resolve_mesh(cfg)
        if shape is None or shape == (1, 1):
            return
        n_data, n_gauss = shape
        if not cfg.shard_pixels and cfg.batch_size % n_data:
            raise ValueError(
                f"batch_size {cfg.batch_size} not divisible by the data mesh axis {n_data} "
                "(or set shard_pixels)"
            )
        if cfg.max_gaussians % n_gauss:
            new_cap = -(-cfg.max_gaussians // n_gauss) * n_gauss
            self.log(f"[runner] rounding max_gaussians {cfg.max_gaussians} -> {new_cap} "
                     f"(divisible by {n_gauss} gaussian shards)")
            cfg.max_gaussians = new_cap
        self.mesh = pshard.make_mesh(n_data, n_gauss)
        if not self.mesh.member:
            raise ValueError(f"rank {dist.get_rank()} is outside the {n_data}x{n_gauss} mesh")
        self.log(f"[runner] device mesh: {n_data} data x {n_gauss} gauss"
                 f"{' (pixel bands)' if cfg.shard_pixels else ''}")

    def log(self, *args):
        """print on the main process only."""
        if self.is_main:
            print(*args, flush=True)

    def full_gstate(self) -> GaussianState:
        """The gaussians over the whole capacity (under a mesh a gathered
        copy: a collective, every rank calls it)."""
        return self.gstate if self.mesh is None else pshard.global_gaussians(self.gstate, self.mesh)

    def refresh_view(self) -> None:
        """Under a mesh with the viewer on, gather the gaussians it draws
        (a collective: every rank calls it; rank 0, which serves the
        viewer, keeps the copy)."""
        if self.mesh is not None and not self.cfg.disable_viewer:
            view = self.full_gstate()
            self._view = view if self.is_main else None

    @property
    def view_gstate(self) -> GaussianState:
        """The gaussians the viewer draws: the live ones on one device,
        under a mesh the copy of the last ``refresh_view``."""
        return self.gstate if self.mesh is None else self._view

    def num_gaussians(self) -> int:
        """Alive gaussians over the whole capacity (a collective under a mesh)."""
        if self.mesh is None:
            return num_alive(self.gstate)
        return int(pshard.col.psum_raw(self.gstate.alive.sum(), self.mesh.gauss))

    def _whole_state(self, fn) -> None:
        """``(gstate, adam, sstate) = fn(gstate, adam, sstate)`` on the whole
        capacity. Under a mesh every rank gathers the state, runs ``fn``
        alike (same generator, same draws) and keeps its own rows."""
        if self.mesh is None:
            self.gstate, self.adam, self.sstate = fn(self.gstate, self.adam, self.sstate)
            return
        g, a, s = fn(*pshard.global_state(self.gstate, self.adam, self.sstate, self.mesh))
        self.gstate, self.adam, self.sstate = pshard.local_state(g, a, s, self.mesh)

    @trace.spanned("runner.init_gaussians")
    def _init_gaussians(self):
        cfg = self.cfg
        if cfg.init_type == "random":
            self.gstate = init_random(
                self.gen, cfg.init_num_pts, cfg.max_gaussians, extent=cfg.init_extent,
                scene_scale=self.scene_scale, sh_degree=cfg.sh_degree,
                init_opacity=cfg.init_opa, init_scale=cfg.init_scale, device=self.device,
            )
            return
        if cfg.init_type == "sfm":
            pts, rgb = self.parser.points, self.parser.points_rgb
        elif cfg.init_type == "monocular_depth":
            pts, rgb = self._monocular_depth_cloud()
        else:
            raise ValueError(f"unknown init_type {cfg.init_type!r}")
        pts = torch.as_tensor(pts, device=self.device)
        rgb = torch.as_tensor(rgb, device=self.device)
        if len(pts) > cfg.max_gaussians:
            print(
                f"[runner] init points {len(pts)} exceed capacity "
                f"{cfg.max_gaussians}; keeping a uniform random subset"
            )
        self.gstate = init_from_points(
            pts, rgb, cfg.max_gaussians, cfg.sh_degree, init_opacity=cfg.init_opa,
            init_scale=cfg.init_scale, generator=self.gen,
            scale_clamp_quantile=(
                cfg.mdi.scale_clamp_quantile if cfg.init_type == "monocular_depth" else 0.0
            ),
        )

    def _monocular_depth_cloud(self):
        """The monocular-depth init's points and colours. Under a mesh
        rank 0 alone runs the depth network and writes the depth cache and
        the exports, then broadcasts the cloud, or its failure (the exit of
        ``pts_only``, an alignment that skipped every image)."""
        run = lambda: pts_and_rgb_from_monocular_depth(
            self.cfg, self.parser, model=self._mdi_model, device=self.device
        )
        if self.mesh is None:
            return run()
        head = torch.zeros(2, dtype=torch.int64, device=self.device)  # (failure, points)
        cloud, err = None, None
        if self.is_main:
            try:
                pts, rgb = run()
                cloud = torch.as_tensor(np.concatenate([pts, rgb], 1), device=self.device)
                head[1] = len(cloud)
            except (Exception, SystemExit) as e:  # handed on after the broadcast
                err = e
                head[0] = 2 if isinstance(e, SystemExit) else 1
        dist.broadcast(head, src=0, group=self.mesh.world)
        if int(head[0]):
            if err is not None:
                raise err
            if int(head[0]) == 2:
                raise SystemExit(0)
            raise RuntimeError("the monocular-depth init failed on rank 0")
        if cloud is None:
            cloud = torch.empty((int(head[1]), 6), dtype=torch.float32, device=self.device)
        dist.broadcast(cloud, src=0, group=self.mesh.world)
        return cloud[:, :3], cloud[:, 3:]

    def _init_aux(self):
        cfg = self.cfg
        n_images = self.parser.num_images
        dev = self.device
        self.aux = AuxParams(
            pose=init_pose_params(n_images, device=dev) if cfg.pose_opt else None,
            app=init_appearance_params(
                generator(cfg.seed + 1, dev), n_images, cfg.max_gaussians,
                embed_dim=cfg.app_embed_dim, sh_degree=cfg.sh_degree, device=dev,
            ) if cfg.app_opt else None,
            grids=(
                init_bilateral_grids(n_images, cfg.bilateral_grid_shape, device=dev)
                if cfg.use_bilateral_grid else None
            ),
        )
        self.aux_opt = init_aux_opt(self.aux)
        # Pose-noise fault injection: fixed random SE3 perturbations of the
        # training poses, applied in every batch.
        self._pose_perturb = None
        if cfg.pose_noise > 0:
            self._pose_perturb = init_pose_params(
                n_images, std=cfg.pose_noise, generator=generator(cfg.seed + 2, dev), device=dev
            )

    @property
    def writer(self):
        """The TensorBoard writer, built at first use."""
        if self._writer is None:
            from ..utils.tb import SummaryWriter

            self._writer = SummaryWriter(os.path.join(self.cfg.result_dir, "tb"))
        return self._writer

    # -------------------------------------------------------------- train

    def setup_train(self):
        """Nothing to warm: the eager step builds no program ahead."""
        return self

    def _next_batch(self) -> Batch:
        ids = []
        for _ in range(self.cfg.batch_size):
            if not self._perm:
                self._perm = torch.randperm(len(self.trainset), generator=self.host_gen).tolist()
            ids.append(self._perm.pop())
        return self._build_batch(ids)

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _build_batch(self, ids) -> Batch:
        """A device-ready batch of trainset items. Reads only immutable
        state (the datasets, the fixed pose perturbation), so the prefetch
        thread may call it."""
        items = [self.trainset[i] for i in ids]
        if self.mesh is not None and not self.cfg.shard_pixels:
            # Every rank reads the whole batch (patch crops draw in order)
            # and keeps its cameras; bands keep the whole batch.
            items = items[pshard.data_rows(len(items), self.mesh)]
        t = lambda key: self._to_device(np.stack([it[key] for it in items]))
        iid = self._to_device(np.array([it["image_id"] for it in items], np.int64))
        c2ws = t("camtoworld")
        if self._pose_perturb is not None:
            c2ws = apply_pose_deltas(c2ws, self._pose_perturb, iid)
        batch = Batch(camtoworlds=c2ws, Ks=t("K"), pixels=t("image"), image_ids=iid)
        if all("sampling_mask" in it for it in items):
            sm = np.stack([np.asarray(it["sampling_mask"], np.float32) for it in items])
            batch.sampling_mask = self._to_device(sm[..., None] if sm.ndim == 3 else sm)
        if self.cfg.depth_loss:
            m = max(1, max(len(it["depth_points"]) for it in items))
            dp = np.zeros((len(items), m, 2), np.float32)
            dv = np.zeros((len(items), m), np.float32)
            for b, it in enumerate(items):
                k = len(it["depth_points"])
                dp[b, :k] = it["depth_points"][:m]
                dv[b, :k] = it["depth_values"][:m]
            batch.depth_points = self._to_device(dp)
            batch.depth_values = self._to_device(dv)
        return batch

    @trace.spanned("runner.retune", device=False)
    def _maybe_retune_capacity(self, metrics, step: int, overflowed: bool = False) -> None:
        """Right-size pair_capacity from the peak pair count seen since the
        last decision (host sync): grow when pairs overflowed it (this
        step's, or an earlier one's when ``overflowed``), shrink when it is
        over 1.33x the snug size. The eager step reads cfg.pair_capacity on
        every call, so either costs no rebuild."""
        cfg = self.cfg
        if not cfg.auto_pair_capacity or cfg.rasterizer_impl == "xla":
            return
        pairs = int(metrics.get("pairs", 0))
        overflow = int(metrics.get("overflow", 0))
        if pairs <= 0 and overflow <= 0:
            return
        # The peak since the last decision absorbs the spread across cameras.
        peak = max(self._pairs_max, pairs + overflow)
        self._pairs_max = 0
        cap = cfg.pair_capacity
        new_cap = retuned_pair_capacity(peak, max(overflow, int(overflowed)), cap)
        if new_cap == cap:
            return
        self.log(
            f"[runner] retuning pair_capacity {cap} -> {new_cap} "
            f"(observed {pairs} pairs, overflow {overflow}) at step {step}"
        )
        cfg.pair_capacity = new_cap
        trace.count("runner.retunes")

    def train_iteration(self, step: int) -> Dict[str, torch.Tensor]:
        with self.lock:
            trace.set_step(step)
            return self._train_iteration(step)

    @trace.spanned("runner.iteration", device=False)
    def _train_iteration(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        if cfg.profile_start >= 0 and step == cfg.profile_start:
            self._start_profiler()
        with trace.span("runner.data", device=False):
            t_data = time.time()
            batch = self._prefetcher.get() if self._prefetcher is not None else self._next_batch()
            self._phase_times["data"] += time.time() - t_data
        bkgd = None
        if cfg.random_bkgd:
            bkgd = torch.rand((cfg.batch_size, 3), generator=self.gen, device=self.device)
        self.gstate, self.adam, self.sstate, self.aux, self.aux_opt, metrics = self.step_fn(
            self.gstate, self.adam, self.sstate, self.aux, self.aux_opt, batch, step, bkgd=bkgd
        )
        trace.count_device("tiles.pairs", metrics["pairs"])
        trace.count_device("tiles.overflow", metrics["overflow"])
        s = cfg.strategy
        if step == 0 or (step % s.refine_every == 0 and step > 0):
            self._maybe_retune_capacity(metrics, step)
        if self._strategy_kind == "default":
            # Refine and opacity reset both stop at refine_stop_iter;
            # pause_refine_after_reset skips grow/prune just after a reset.
            if step < s.refine_stop_iter:
                if (
                    step > s.refine_start_iter
                    and step % s.refine_every == 0
                    and step % s.reset_every >= s.pause_refine_after_reset
                ):
                    eps1, eps2 = dstrat.split_noise(cfg.max_gaussians, self.gen, self.device)
                    self._whole_state(lambda g, a, st: dstrat.refine(
                        g, a, st, eps1, eps2, self.scene_scale, s, step,
                    )[:3])
                if step % s.reset_every == 0 and step > 0:  # per gaussian: on this rank's rows
                    self.gstate, self.adam = dstrat.reset_opacities(self.gstate, self.adam, s)
        else:  # mcmc
            if s.refine_start_iter < step < s.refine_stop_iter and step % s.refine_every == 0:
                self._whole_state(lambda g, a, st: mcmc.relocate(g, a, st, self.gen, s))
            lr_now = float(self.acfg.lrs["means"] * self.acfg.means_decay_gamma**step)
            eps = mcmc.noise_eps(cfg.max_gaussians, self.gen)
            if self.mesh is not None:
                eps = eps[pshard.gauss_rows(cfg.max_gaussians, self.mesh)]
            self.gstate = mcmc.add_noise(self.gstate, eps, lr_now, s)
        if cfg.profile_start >= 0 and step == cfg.profile_start + cfg.profile_steps - 1:
            self._stop_profiler()
        self.global_step = step
        return metrics

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self._profiler = profile(activities=acts)
        self._profiler.__enter__()

    def _stop_profiler(self):
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.__exit__(None, None, None)
        out = os.path.join(self.cfg.result_dir, "profile")
        os.makedirs(out, exist_ok=True)
        self._profiler.export_chrome_trace(os.path.join(out, "trace.json"))
        self._profiler = None
        print(f"[profiler] trace written to {out}")

    def start_viewer(self) -> int:
        """Serve the live HTTP viewer on a daemon thread (``viewer.py``);
        returns the bound port (None off the main process). Under a mesh
        it needs ``disable_viewer`` off: every rank gathers its copy of
        the state (``refresh_view``)."""
        if self.mesh is not None and self.cfg.disable_viewer:
            raise ValueError("under a mesh the viewer needs disable_viewer=False")
        if not self.is_main:
            return None
        from ..viewer import ViewerServer

        self.viewer = ViewerServer(self, port=self.cfg.port)
        return self.viewer.start()

    def train(self) -> dict:
        """The training loop to ``max_steps``; returns ``train_final.json``'s
        stats. With ``cfg.trace`` the tracer's report goes to
        ``<result_dir>/stats/trace.json`` at the end."""
        cfg = self.cfg
        if cfg.trace:
            trace.enable(self.device)
        if not cfg.disable_viewer and self.viewer is None:
            self.start_viewer()
        if cfg.data_prefetch > 0:
            from ..datasets.prefetch import BatchPrefetcher

            self._prefetcher = BatchPrefetcher(
                self._build_batch, len(self.trainset), cfg.batch_size,
                depth=cfg.data_prefetch, seed=cfg.seed,
            )
        try:
            return self._train_loop()
        finally:
            if self._prefetcher is not None:
                self._prefetcher.close()
                self._prefetcher = None
            self._stop_profiler()
            if cfg.trace:
                self._write_trace()

    def _write_trace(self) -> None:
        """The tracer's report to ``stats/trace.json`` (main process), with
        the last spans under ``recent`` (each with its parent and step, so
        the spans of one step can be grouped), and the tracer off."""
        rep = dict(trace.report(), recent=trace.records())
        trace.disable()
        if self.is_main:
            with open(os.path.join(self.cfg.result_dir, "stats", "trace.json"), "w") as f:
                json.dump(rep, f, indent=2)

    def _train_loop(self) -> dict:
        cfg = self.cfg
        s = cfg.strategy
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.time()
        last = {}
        # The largest demand (pairs + overflow) of a step that overflowed
        # since the last logged step, kept on the card: growth between
        # refines overflows some views at steps no sync reads.
        missed = torch.zeros((), dtype=torch.int64, device=self.device)
        for step in range(cfg.max_steps):
            self.train_step = step
            metrics = self.train_iteration(step)
            over = torch.as_tensor(metrics["overflow"], device=self.device)
            missed = torch.maximum(missed, torch.where(over > 0, over + metrics["pairs"], 0))
            # Growth after a refine or relocation shows as overflow on the
            # step after it: one host sync per refine cycle catches it.
            if step % s.refine_every == 1 and s.refine_start_iter < step < s.refine_stop_iter + 2:
                if int(metrics["overflow"]) > 0:
                    self._maybe_retune_capacity(metrics, step)
            if step % cfg.tb_every == 0:
                with trace.span("runner.log", device=False):
                    last = {k: float(v) for k, v in metrics.items()}
                    demand = int(missed)
                    missed.zero_()
                    self._pairs_max = max(self._pairs_max, int(last["pairs"]) + int(last["overflow"]), demand)
                    if demand > 0:
                        self._maybe_retune_capacity(metrics, step, overflowed=True)
                    n_gs = self.num_gaussians()
                    self.refresh_view()
                    mem_stats = device_memory_stats(self.device)
                    if self.is_main:
                        w = self.writer
                        for k, v in last.items():
                            w.add_scalar(f"train/{k}", v, step)
                        w.add_scalar("train/num_GS", n_gs, step)
                        if mem_stats:
                            w.add_scalar("train/mem_peak_gb", mem_stats["peak_bytes_in_use"] / 1024**3, step)
                    mem = format_memory_stats(self.device) if self.device.type == "cuda" else ""
                    self.log(f"step {step}: loss={last['loss']:.4f} num_GS={n_gs} {mem}".rstrip())
            if step + 1 in cfg.save_steps or step + 1 == cfg.max_steps:
                self.save(step + 1)
            if cfg.save_ply and step + 1 in cfg.ply_steps:
                self.export_ply(step + 1)
            if step + 1 in cfg.eval_steps or step + 1 == cfg.max_steps:
                self.eval(step + 1)
                if cfg.compression is not None:
                    self.run_compression(step + 1)
        stats = dict(
            elapsed=time.time() - t0,
            num_GS=self.num_gaussians(),
            data_time=self._phase_times["data"],
            **last,
        )
        if self.device.type == "cuda":
            from .. import kernels

            stats["mem_peak_gb"] = torch.cuda.max_memory_allocated(self.device) / 1024**3
            # The process's launches of each hand-written kernel so far.
            stats["kernel_launches"] = dict(kernels.LAUNCHES)
            self.log(f"[runner] peak device memory {stats['mem_peak_gb']:.3f} GB")
        if self.is_main:
            with open(os.path.join(cfg.result_dir, "stats", "train_final.json"), "w") as f:
                json.dump(stats, f, indent=2)
        return stats

    # ------------------------------------------------------------ render

    @torch.no_grad()
    def render(self, camtoworld, K, width: int, height: int, render_mode: str = "RGB+ED", gstate=None):
        """Render one view of ``gstate``, by default the whole state (under
        a mesh gathered: a collective, every rank calls ``render``);
        returns numpy (color [H,W,3], alpha [H,W], depth)."""
        color, alpha, depth = self._render_on_device(camtoworld, K, width, height, render_mode, gstate)
        return color.cpu().numpy(), alpha.cpu().numpy(), None if depth is None else depth.cpu().numpy()

    @torch.no_grad()
    def _render_on_device(self, camtoworld, K, width: int, height: int, render_mode: str = "RGB+ED",
                          gstate=None):
        """``render``'s view as tensors on the Runner's device: color [H, W, 3]
        clamped to [0, 1], alpha [H, W], depth [H, W] or None."""
        cfg = self.cfg
        gstate = gstate if gstate is not None else self.full_gstate()
        p = gstate.params
        scales, opac = p.activated()
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        bg = None
        if cfg.background_color is not None:
            bg = t([cfg.background_color])
        cap = cfg.pair_capacity
        while True:
            out, alpha, info = rasterize(
                p.means, p.quats, scales, opac, p.sh_coeffs(),
                torch.linalg.inv(t(camtoworld))[None], t(K)[None], width, height,
                sh_degree=cfg.sh_degree, alive=gstate.alive, backgrounds=bg,
                render_mode=render_mode, camera_model=cfg.camera_model,
                tile_size=cfg.tile_size, pair_capacity=cap, chunk_size=cfg.chunk_size,
                rasterize_mode="antialiased" if cfg.antialiased else "classic",
                impl=cfg.rasterizer_impl,
            )
            overflow = int(info.overflow)
            if overflow == 0:
                break
            cap = retuned_pair_capacity(int(info.binning.tile_starts[-1]) + overflow, overflow, cap)
        depth = out[0, ..., 3] if render_mode == "RGB+ED" else None
        return out[0, ..., :3].clamp(0.0, 1.0), alpha[0, ..., 0], depth

    def eval(self, step: int, stage: str = "val") -> Dict[str, float]:
        """PSNR, SSIM (LPIPS, colour-corrected PSNR) over the val split, on
        the Runner's device; only the saved canvases and the numbers reach
        the host. Under a mesh every rank gathers the state and computes the
        same numbers; the main process writes the renders, stats and
        scalars."""
        cfg = self.cfg
        psnrs, ssims, times, cc_psnrs, lpipss = [], [], [], [], []
        use_lpips = lpips_available()
        gstate = self.full_gstate()
        for i in range(len(self.valset)):
            item = self.valset[i]
            h, w = item["image"].shape[:2]
            t0 = time.time()
            color, _, _ = self._render_on_device(
                item["camtoworld"], item["K"], w, h, render_mode="RGB", gstate=gstate
            )
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            times.append(time.time() - t0)
            c = color[None]
            gt = torch.as_tensor(item["image"], device=self.device)[None]
            psnrs.append(float(psnr(c, gt)))
            ssims.append(float(ssim(c, gt)))
            if cfg.use_bilateral_grid:
                cc_psnrs.append(float(psnr(color_correct(c, gt), gt)))
            if use_lpips:
                lpipss.append(float(lpips(c, gt)))
            if self.is_main and (i < 4 or cfg.save_predictions):
                canvas = np.concatenate([item["image"], color.cpu().numpy()], axis=1)
                write_png(
                    os.path.join(cfg.result_dir, "renders", f"{stage}_{step}_{i:03d}.png"),
                    (canvas * 255).astype(np.uint8),
                )
        stats = dict(
            psnr=float(np.mean(psnrs)),
            ssim=float(np.mean(ssims)),
            ellipse_time=float(np.mean(times)) if times else 0.0,
            num_GS=num_alive(gstate),
        )
        if cc_psnrs:
            stats["cc_psnr"] = float(np.mean(cc_psnrs))
        if lpipss:
            stats["lpips"] = float(np.mean(lpipss))
        if self.is_main:
            with open(os.path.join(cfg.result_dir, "stats", f"{stage}_step{step}.json"), "w") as f:
                json.dump(stats, f, indent=2)
            w = self.writer
            for k, v in stats.items():
                w.add_scalar(f"{stage}/{k}", v, step)
        self.log(f"eval step {step}: PSNR={stats['psnr']:.3f} SSIM={stats['ssim']:.4f}")
        return stats

    def render_traj(self, step: int, n_frames: int = 60) -> List[str]:
        """Render a camera path (RGB and a normalised depth panel) as PNG
        frames ``renders/traj_<step>_<j>.png``; returns their paths (the
        main process writes them)."""
        from ..datasets.traj import get_path

        cfg = self.cfg
        c2ws = np.stack(
            [self.parser.images[int(i)].camtoworld for i in self.parser.split_indices("train")]
        )
        path = get_path(cfg.render_traj_path, c2ws, n_frames=n_frames)
        K = self.trainset[0]["K"]
        gstate = self.full_gstate()
        paths = []
        for j, c2w in enumerate(path[:n_frames]):
            color, _, depth = self.render(c2w, K, self.width, self.height, render_mode="RGB+ED", gstate=gstate)
            d = depth / max(float(depth.max()), 1e-6)
            canvas = np.concatenate([color, np.repeat(d[..., None], 3, axis=-1)], axis=1)
            paths.append(os.path.join(cfg.result_dir, "renders", f"traj_{step}_{j:04d}.png"))
            if self.is_main:
                write_png(paths[-1], (canvas * 255).astype(np.uint8))
        return paths

    # ---------------------------------------------------------------- ckpt

    def save(self, step: int) -> str:
        """The whole training state (params, Adam, strategy statistics, aux
        groups, step) in the JAX package's npz layout; under a mesh the
        gathered state, written by the main process. Sharded checkpoints
        (one file per rank): ``engine/ckpt.py``."""
        path = os.path.join(self.cfg.result_dir, "ckpts", f"ckpt_{step}.npz")
        gstate, adam, sstate = self.gstate, self.adam, self.sstate
        if self.mesh is not None:
            gstate, adam, sstate = pshard.global_state(gstate, adam, sstate, self.mesh)
        if not self.is_main:
            return path
        n = lambda x: x.detach().cpu().numpy()
        flat = {
            "step": np.asarray(step),
            "alive": n(gstate.alive),
            "transform": self.parser.transform,
        }
        for name in PARAM_NAMES:
            flat[f"params/{name}"] = n(getattr(gstate.params, name))
            flat[f"mu/{name}"] = n(getattr(adam.mu, name))
            flat[f"nu/{name}"] = n(getattr(adam.nu, name))
        flat["adam_count"] = np.asarray(adam.count, np.int32)
        for name in ("grad2d", "count", "radii_max"):
            flat[f"strategy/{name}"] = n(getattr(sstate, name))
        for i, leaf in enumerate(aux_leaves(self.aux)):
            flat[f"aux/{i}"] = n(leaf)
        np.savez(path, **flat)
        return path

    def load(self, path: str) -> int:
        """Load a checkpoint written by ``save`` (or by the JAX Runner);
        returns its step. The aux groups load when the checkpoint has as
        many aux arrays as this run's enabled groups have. Under a mesh
        every rank reads the file and keeps its rows."""
        data = np.load(path)
        dev = self.device
        leaves = lambda prefix: {k: data[f"{prefix}/{k}"] for k in PARAM_NAMES}
        gstate = GaussianState(
            params=params_from_numpy(leaves("params"), dev),
            alive=torch.as_tensor(data["alive"], device=dev).bool(),
        )
        adam = AdamState(
            mu=params_from_numpy(leaves("mu"), dev), nu=params_from_numpy(leaves("nu"), dev),
            count=int(data["adam_count"]),
        )
        sstate = dstrat.strategy_from_numpy(
            *(data[f"strategy/{k}"] for k in ("grad2d", "count", "radii_max")), dev
        )
        if self.mesh is not None:
            gstate, adam, sstate = pshard.local_state(gstate, adam, sstate, self.mesh)
        self.gstate, self.adam, self.sstate = gstate, adam, sstate
        like = aux_leaves(self.aux)
        if like and sum(k.startswith("aux/") for k in data.files) == len(like):
            self.aux = aux_from_leaves(
                self.aux,
                [torch.as_tensor(data[f"aux/{i}"], device=dev).float() for i in range(len(like))],
            )
        self.refresh_view()
        self.global_step = int(data["step"])
        return self.global_step

    def _alive_numpy(self):
        """The alive splats' buffers as numpy (gathered under a mesh)."""
        gstate = self.full_gstate()
        alive = gstate.alive.cpu().numpy()
        return [getattr(gstate.params, k).detach().cpu().numpy()[alive] for k in
                ("means", "scales", "quats", "opacities", "sh0", "shN")]

    def run_compression(self, step: int) -> str:
        """Compressed splat export (a Morton-ordered quantised npz)."""
        from ..utils.compression import compress_splats

        path = os.path.join(self.cfg.result_dir, f"compressed_{step}.npz")
        splats = self._alive_numpy()
        return compress_splats(path, *splats) if self.is_main else path

    def export_ply(self, step: int) -> str:
        from ..utils.ply import write_ply_splats

        path = os.path.join(self.cfg.result_dir, f"splats_{step}.ply")
        splats = self._alive_numpy()
        if self.is_main:
            write_ply_splats(path, *splats)
        return path
