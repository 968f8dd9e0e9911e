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

Still raising (``config.check_slice``, naming the later slice):
multi-device training.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config, DefaultStrategyConfig, MCMCStrategyConfig, check_slice, to_dict
from ..datasets.nerfstudio import open_dataset
from ..datasets.parser import Dataset, Parser
from ..datasets.png import write_png
from ..device import generator, resolve_device
from ..mdi.init import pts_and_rgb_from_monocular_depth
from ..ops.lpips import lpips, lpips_available
from ..ops.render import rasterize
from ..ops.ssim import psnr, ssim
from ..utils.mem import device_memory_stats, format_memory_stats
from .appearance import (
    apply_pose_deltas,
    color_correct,
    init_appearance_params,
    init_bilateral_grids,
    init_pose_params,
)
from .optim import init_adam_state, make_adam_config
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
        check_slice(cfg)
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
        self._init_aux()
        self.step_fn = make_train_step(cfg, self.acfg, self.width, self.height)
        self.global_step = 0
        self._perm: List[int] = []
        self._pairs_max = 0
        self._prefetcher = None
        self._profiler = None
        self._phase_times = {"data": 0.0, "step": 0.0}
        self._writer = None
        # Held by each train iteration and by the viewer's renders: a step
        # updates the parameters in place, so a render must not overlap one.
        self.lock = threading.RLock()
        with open(os.path.join(cfg.result_dir, "cfg.json"), "w") as f:
            json.dump(to_dict(cfg), f, indent=2, default=str)

    # ------------------------------------------------------------- set up

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
            pts, rgb = pts_and_rgb_from_monocular_depth(
                cfg, self.parser, model=self._mdi_model, device=self.device
            )
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

    def _maybe_retune_capacity(self, metrics, step: int) -> None:
        """Right-size pair_capacity from the peak pair count seen since the
        last decision (host sync): grow when pairs overflowed it, shrink
        when it is over 1.33x the snug size. The eager step reads
        cfg.pair_capacity on every call, so either costs no rebuild."""
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
        new_cap = retuned_pair_capacity(peak, overflow, cap)
        if new_cap == cap:
            return
        print(
            f"[runner] retuning pair_capacity {cap} -> {new_cap} "
            f"(observed {pairs} pairs, overflow {overflow}) at step {step}"
        )
        cfg.pair_capacity = new_cap

    def train_iteration(self, step: int) -> Dict[str, torch.Tensor]:
        with self.lock:
            return self._train_iteration(step)

    def _train_iteration(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        if cfg.profile_start >= 0 and step == cfg.profile_start:
            self._start_profiler()
        t_data = time.time()
        batch = self._prefetcher.get() if self._prefetcher is not None else self._next_batch()
        self._phase_times["data"] += time.time() - t_data
        bkgd = None
        if cfg.random_bkgd:
            bkgd = torch.rand((cfg.batch_size, 3), generator=self.gen, device=self.device)
        self.gstate, self.adam, self.sstate, self.aux, self.aux_opt, metrics = self.step_fn(
            self.gstate, self.adam, self.sstate, self.aux, self.aux_opt, batch, step, bkgd=bkgd
        )
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
                    self.gstate, self.adam, self.sstate, _ = dstrat.refine(
                        self.gstate, self.adam, self.sstate, eps1, eps2,
                        self.scene_scale, s, step,
                    )
                if step % s.reset_every == 0 and step > 0:
                    self.gstate, self.adam = dstrat.reset_opacities(self.gstate, self.adam, s)
        else:  # mcmc
            if s.refine_start_iter < step < s.refine_stop_iter and step % s.refine_every == 0:
                self.gstate, self.adam, self.sstate = mcmc.relocate(
                    self.gstate, self.adam, self.sstate, self.gen, s
                )
            lr_now = float(self.acfg.lrs["means"] * self.acfg.means_decay_gamma**step)
            self.gstate = mcmc.add_noise(
                self.gstate, mcmc.noise_eps(cfg.max_gaussians, self.gen), lr_now, s
            )
        if cfg.profile_start >= 0 and step == cfg.profile_start + cfg.profile_steps - 1:
            self._stop_profiler()
        self._phase_times["step"] += time.time() - t_data
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
        returns the bound port."""
        from ..viewer import ViewerServer

        self.viewer = ViewerServer(self, port=self.cfg.port)
        return self.viewer.start()

    def train(self) -> dict:
        cfg = self.cfg
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

    def _train_loop(self) -> dict:
        cfg = self.cfg
        s = cfg.strategy
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.time()
        last = {}
        for step in range(cfg.max_steps):
            self.train_step = step
            metrics = self.train_iteration(step)
            # Growth after a refine or relocation shows as overflow on the
            # step after it: one host sync per refine cycle catches it.
            if (
                step % s.refine_every == 1
                and s.refine_start_iter < step < s.refine_stop_iter + 2
                and int(metrics["overflow"]) > 0
            ):
                self._maybe_retune_capacity(metrics, step)
            if step % cfg.tb_every == 0:
                last = {k: float(v) for k, v in metrics.items()}
                self._pairs_max = max(self._pairs_max, int(last["pairs"]) + int(last["overflow"]))
                if last["overflow"] > 0:
                    self._maybe_retune_capacity(metrics, step)
                w = self.writer
                for k, v in last.items():
                    w.add_scalar(f"train/{k}", v, step)
                w.add_scalar("train/num_GS", num_alive(self.gstate), step)
                mem_stats = device_memory_stats(self.device)
                if mem_stats:
                    w.add_scalar("train/mem_peak_gb", mem_stats["peak_bytes_in_use"] / 1024**3, step)
                mem = format_memory_stats(self.device) if self.device.type == "cuda" else ""
                print(
                    f"step {step}: loss={last['loss']:.4f} "
                    f"num_GS={num_alive(self.gstate)} {mem}".rstrip()
                )
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
            num_GS=num_alive(self.gstate),
            data_time=self._phase_times["data"],
            step_time=self._phase_times["step"] - self._phase_times["data"],
            **last,
        )
        if self.device.type == "cuda":
            from .. import kernels

            stats["mem_peak_gb"] = torch.cuda.max_memory_allocated(self.device) / 1024**3
            # The process's launches of each hand-written kernel so far.
            stats["kernel_launches"] = dict(kernels.LAUNCHES)
            print(f"[runner] peak device memory {stats['mem_peak_gb']:.3f} GB")
        with open(os.path.join(cfg.result_dir, "stats", "train_final.json"), "w") as f:
            json.dump(stats, f, indent=2)
        return stats

    # ------------------------------------------------------------ render

    @torch.no_grad()
    def render(self, camtoworld, K, width: int, height: int, render_mode: str = "RGB+ED"):
        """Render one view; returns numpy (color [H,W,3], alpha [H,W], depth)."""
        cfg = self.cfg
        p = self.gstate.params
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
                sh_degree=cfg.sh_degree, alive=self.gstate.alive, backgrounds=bg,
                render_mode=render_mode, camera_model=cfg.camera_model,
                tile_size=cfg.tile_size, pair_capacity=cap, chunk_size=cfg.chunk_size,
                rasterize_mode="antialiased" if cfg.antialiased else "classic",
                impl=cfg.rasterizer_impl,
            )
            overflow = int(info.overflow)
            if overflow == 0:
                break
            cap = retuned_pair_capacity(int(info.binning.tile_starts[-1]) + overflow, overflow, cap)
        color = out[0, ..., :3].clamp(0.0, 1.0).cpu().numpy()
        depth = out[0, ..., 3].cpu().numpy() if render_mode == "RGB+ED" else None
        return color, alpha[0, ..., 0].cpu().numpy(), depth

    def eval(self, step: int, stage: str = "val") -> Dict[str, float]:
        cfg = self.cfg
        psnrs, ssims, times, cc_psnrs, lpipss = [], [], [], [], []
        use_lpips = lpips_available()
        for i in range(len(self.valset)):
            item = self.valset[i]
            h, w = item["image"].shape[:2]
            t0 = time.time()
            color, _, _ = self.render(item["camtoworld"], item["K"], w, h, render_mode="RGB")
            times.append(time.time() - t0)
            c = torch.as_tensor(color)[None]
            gt = torch.as_tensor(item["image"])[None]
            psnrs.append(float(psnr(c, gt)))
            ssims.append(float(ssim(c, gt)))
            if cfg.use_bilateral_grid:
                cc = color_correct(c.to(self.device), gt.to(self.device)).cpu()
                cc_psnrs.append(float(psnr(cc, gt)))
            if use_lpips:
                lpipss.append(float(lpips(c.to(self.device), gt.to(self.device))))
            if i < 4 or cfg.save_predictions:
                canvas = np.concatenate([item["image"], color], axis=1)
                write_png(
                    os.path.join(cfg.result_dir, "renders", f"{stage}_{step}_{i:03d}.png"),
                    (canvas * 255).astype(np.uint8),
                )
        stats = dict(
            psnr=float(np.mean(psnrs)),
            ssim=float(np.mean(ssims)),
            ellipse_time=float(np.mean(times)) if times else 0.0,
            num_GS=num_alive(self.gstate),
        )
        if cc_psnrs:
            stats["cc_psnr"] = float(np.mean(cc_psnrs))
        if lpipss:
            stats["lpips"] = float(np.mean(lpipss))
        with open(os.path.join(cfg.result_dir, "stats", f"{stage}_step{step}.json"), "w") as f:
            json.dump(stats, f, indent=2)
        w = self.writer
        for k, v in stats.items():
            w.add_scalar(f"{stage}/{k}", v, step)
        print(f"eval step {step}: PSNR={stats['psnr']:.3f} SSIM={stats['ssim']:.4f}")
        return stats

    def render_traj(self, step: int, n_frames: int = 60) -> List[str]:
        """Render a camera path (RGB and a normalised depth panel) as PNG
        frames ``renders/traj_<step>_<j>.png``; returns their paths."""
        from ..datasets.traj import get_path

        cfg = self.cfg
        c2ws = np.stack(
            [self.parser.images[int(i)].camtoworld for i in self.parser.split_indices("train")]
        )
        path = get_path(cfg.render_traj_path, c2ws, n_frames=n_frames)
        K = self.trainset[0]["K"]
        paths = []
        for j, c2w in enumerate(path[:n_frames]):
            color, _, depth = self.render(c2w, K, self.width, self.height, render_mode="RGB+ED")
            d = depth / max(float(depth.max()), 1e-6)
            canvas = np.concatenate([color, np.repeat(d[..., None], 3, axis=-1)], axis=1)
            paths.append(os.path.join(cfg.result_dir, "renders", f"traj_{step}_{j:04d}.png"))
            write_png(paths[-1], (canvas * 255).astype(np.uint8))
        return paths

    # ---------------------------------------------------------------- ckpt

    def save(self, step: int) -> str:
        """The whole training state (params, Adam, strategy statistics, aux
        groups, step) in the JAX package's npz layout."""
        path = os.path.join(self.cfg.result_dir, "ckpts", f"ckpt_{step}.npz")
        n = lambda x: x.detach().cpu().numpy()
        flat = {
            "step": np.asarray(step),
            "alive": n(self.gstate.alive),
            "transform": self.parser.transform,
        }
        for name in PARAM_NAMES:
            flat[f"params/{name}"] = n(getattr(self.gstate.params, name))
            flat[f"mu/{name}"] = n(getattr(self.adam.mu, name))
            flat[f"nu/{name}"] = n(getattr(self.adam.nu, name))
        flat["adam_count"] = np.asarray(self.adam.count, np.int32)
        for name in ("grad2d", "count", "radii_max"):
            flat[f"strategy/{name}"] = n(getattr(self.sstate, name))
        for i, leaf in enumerate(aux_leaves(self.aux)):
            flat[f"aux/{i}"] = n(leaf)
        np.savez(path, **flat)
        return path

    def load(self, path: str) -> int:
        """Load a checkpoint written by ``save`` (or by the JAX Runner);
        returns its step. The aux groups load when the checkpoint has as
        many aux arrays as this run's enabled groups have."""
        data = np.load(path)
        dev = self.device
        leaves = lambda prefix: {k: data[f"{prefix}/{k}"] for k in PARAM_NAMES}
        self.gstate = GaussianState(
            params=params_from_numpy(leaves("params"), dev),
            alive=torch.as_tensor(data["alive"], device=dev).bool(),
        )
        self.adam.mu = params_from_numpy(leaves("mu"), dev)
        self.adam.nu = params_from_numpy(leaves("nu"), dev)
        self.adam.count = int(data["adam_count"])
        self.sstate = dstrat.strategy_from_numpy(
            *(data[f"strategy/{k}"] for k in ("grad2d", "count", "radii_max")), dev
        )
        like = aux_leaves(self.aux)
        if like and sum(k.startswith("aux/") for k in data.files) == len(like):
            self.aux = aux_from_leaves(
                self.aux,
                [torch.as_tensor(data[f"aux/{i}"], device=dev).float() for i in range(len(like))],
            )
        self.global_step = int(data["step"])
        return self.global_step

    def _alive_numpy(self):
        alive = self.gstate.alive.cpu().numpy()
        return [getattr(self.gstate.params, k).detach().cpu().numpy()[alive] for k in
                ("means", "scales", "quats", "opacities", "sh0", "shN")]

    def run_compression(self, step: int) -> str:
        """Compressed splat export (a Morton-ordered quantised npz)."""
        from ..utils.compression import compress_splats

        path = os.path.join(self.cfg.result_dir, f"compressed_{step}.npz")
        return compress_splats(path, *self._alive_numpy())

    def export_ply(self, step: int) -> str:
        from ..utils.ply import write_ply_splats

        path = os.path.join(self.cfg.result_dir, f"splats_{step}.ply")
        write_ply_splats(path, *self._alive_numpy())
        return path
