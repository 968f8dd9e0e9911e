"""Training runner for the default path — port of
``gs_init_tpu/engine/runner.py``.

SfM, random or monocular-depth init (the stub predictor, ``mdi/init.py``),
the batch loop (batches built synchronously), the refine and
opacity-reset cadence of the default strategy, pair-capacity growth when
the compositor's pair table overflows, and ``eval`` with PSNR and SSIM.
MCMC, meshes, pose / appearance / bilateral modules, the depth networks,
checkpoints, trajectories, compression and PLY export raise
(``config.check_slice`` and the methods below name the later slice).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config, check_slice, to_dict
from ..datasets.parser import Dataset, Parser
from ..device import generator, resolve_device
from ..mdi.init import pts_and_rgb_from_monocular_depth
from ..ops.render import rasterize
from ..ops.ssim import psnr, ssim
from .optim import init_adam_state, make_adam_config
from .params import init_from_points, init_random, num_alive
from .strategy import default as dstrat
from .train_step import Batch, make_train_step


def grown_pair_capacity(pairs: int, overflow: int, chunk: int) -> int:
    """Snug capacity for an observed demand: 1.2x headroom, rounded up to
    64k pairs (and to the chunk)."""
    gran = 1 << 16
    want = max(int((pairs + overflow) * 1.2), 1 << 14)
    cap = -(-want // gran) * gran
    return -(-cap // chunk) * chunk


class Runner:
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
        self.parser = parser or Parser(
            cfg.data_dir, factor=cfg.data_factor, normalize=cfg.normalize_world_space,
            test_every=cfg.test_every,
        )
        self.trainset = trainset or Dataset(self.parser, "train", load_depths=cfg.depth_loss)
        self.valset = valset or Dataset(self.parser, "val")
        self.scene_scale = self.parser.scene_scale * 1.1 * cfg.global_scale
        os.makedirs(os.path.join(cfg.result_dir, "stats"), exist_ok=True)
        self.height, self.width = self.trainset[0]["image"].shape[:2]

        self.gen = generator(cfg.seed, self.device)  # init, splits, backgrounds
        self.host_gen = generator(cfg.seed)  # batch order
        self._init_gaussians()
        self.acfg = make_adam_config(cfg, self.scene_scale, cfg.batch_size)
        self.adam = init_adam_state(self.gstate.params)
        self.sstate = dstrat.init_state(cfg.max_gaussians, self.device)
        self.step_fn = make_train_step(cfg, self.acfg, self.width, self.height)
        self.global_step = 0
        self._perm: List[int] = []
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

    # -------------------------------------------------------------- train

    def _next_batch(self) -> Batch:
        ids = []
        for _ in range(self.cfg.batch_size):
            if not self._perm:
                self._perm = torch.randperm(len(self.trainset), generator=self.host_gen).tolist()
            ids.append(self._perm.pop())
        items = [self.trainset[i] for i in ids]
        t = lambda key: torch.as_tensor(np.stack([it[key] for it in items]), device=self.device)
        batch = Batch(
            camtoworlds=t("camtoworld"), Ks=t("K"), pixels=t("image"),
            image_ids=torch.as_tensor([it["image_id"] for it in items], device=self.device),
        )
        if self.cfg.depth_loss:
            m = max(1, max(len(it["depth_points"]) for it in items))
            dp = np.zeros((len(items), m, 2), np.float32)
            dv = np.zeros((len(items), m), np.float32)
            for b, it in enumerate(items):
                k = len(it["depth_points"])
                dp[b, :k] = it["depth_points"][:m]
                dv[b, :k] = it["depth_values"][:m]
            batch.depth_points = torch.as_tensor(dp, device=self.device)
            batch.depth_values = torch.as_tensor(dv, device=self.device)
        return batch

    def _maybe_grow_capacity(self, metrics, step: int) -> None:
        """Grow pair_capacity when the pair table overflowed (host sync)."""
        cfg = self.cfg
        overflow = int(metrics["overflow"])
        if not cfg.auto_pair_capacity or overflow <= 0:
            return
        new_cap = grown_pair_capacity(int(metrics["pairs"]), overflow, cfg.chunk_size)
        print(
            f"[runner] growing pair_capacity {cfg.pair_capacity} -> {new_cap} "
            f"(overflow {overflow}) at step {step}"
        )
        cfg.pair_capacity = new_cap

    def train_iteration(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        batch = self._next_batch()
        bkgd = None
        if cfg.random_bkgd:
            bkgd = torch.rand((cfg.batch_size, 3), generator=self.gen, device=self.device)
        self.gstate, self.adam, self.sstate, metrics = self.step_fn(
            self.gstate, self.adam, self.sstate, batch, step, bkgd=bkgd
        )
        s = cfg.strategy
        if step == 0 or step % s.refine_every in (0, 1) or step % cfg.tb_every == 0:
            self._maybe_grow_capacity(metrics, step)
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
        self.global_step = step
        return metrics

    def train(self) -> dict:
        cfg = self.cfg
        t0 = time.time()
        last = {}
        for step in range(cfg.max_steps):
            metrics = self.train_iteration(step)
            if step % cfg.tb_every == 0:
                last = {k: float(v) for k, v in metrics.items()}
                print(
                    f"step {step}: loss={last['loss']:.4f} "
                    f"num_GS={num_alive(self.gstate)}"
                )
            if step + 1 in cfg.eval_steps or step + 1 == cfg.max_steps:
                self.eval(step + 1)
        stats = dict(elapsed=time.time() - t0, num_GS=num_alive(self.gstate), **last)
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
            cap = grown_pair_capacity(int(info.binning.tile_starts[-1]), overflow, cfg.chunk_size)
        color = out[0, ..., :3].clamp(0.0, 1.0).cpu().numpy()
        depth = out[0, ..., 3].cpu().numpy() if render_mode == "RGB+ED" else None
        return color, alpha[0, ..., 0].cpu().numpy(), depth

    def eval(self, step: int, stage: str = "val") -> Dict[str, float]:
        psnrs, ssims, times = [], [], []
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
        stats = dict(
            psnr=float(np.mean(psnrs)),
            ssim=float(np.mean(ssims)),
            ellipse_time=float(np.mean(times)) if times else 0.0,
            num_GS=num_alive(self.gstate),
        )
        with open(os.path.join(self.cfg.result_dir, "stats", f"{stage}_step{step}.json"), "w") as f:
            json.dump(stats, f, indent=2)
        print(f"eval step {step}: PSNR={stats['psnr']:.3f} SSIM={stats['ssim']:.4f}")
        return stats

    # ---------------------------------------------------- later slices

    def save(self, step: int):
        raise NotImplementedError("checkpoints are not ported yet (the checkpoint slice in ROADMAP.md)")

    def load(self, path: str):
        raise NotImplementedError("checkpoints are not ported yet (the checkpoint slice in ROADMAP.md)")

    def render_traj(self, step: int, n_frames: int = 60):
        raise NotImplementedError("trajectory renders are not ported yet (the eval/integration slice in ROADMAP.md)")

    def export_ply(self, step: int):
        raise NotImplementedError("PLY export is not ported yet (the eval/integration slice in ROADMAP.md)")

    def run_compression(self, step: int):
        raise NotImplementedError("splat compression is not ported yet (the eval/integration slice in ROADMAP.md)")
