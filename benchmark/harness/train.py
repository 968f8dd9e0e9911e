"""The training window, the general generator of ``"generator": "train"``
traffic.

Set-up: the scene from the seed (``scene.py``), the configuration through the
port's ``parse_cli``, ``Runner(cfg, mdi_model=stub)`` (the monocular-depth
init with the stub over the scene's own depth, the subset to the capacity,
the kNN scales), the batch prefetcher as ``Runner.train`` starts it, then the
warm-up steps ``[warmup_start, window_start)`` through
``Runner.train_iteration``: one epoch, which fills the image cache as a long
run's first epoch would. The first ``check_steps`` of them are the steps the
reference follows. The window drives ``Runner.train_iteration`` from
``window_start`` until ``--seconds`` have passed, with the pair-table retunes
of ``Runner._train_loop`` through the Runner's own method, and ends with a
synchronise. Train steps per second are the window's steps over its seconds.

With ``--trace 1`` the same window records the per-layer observations (CUDA
events at the step's marks, spans around refine, relocation and noise, the
Runner's data wait) and is followed by ``profile_steps`` steps under the
profiler, whose compositor inputs ``counts/`` reads.
"""
from __future__ import annotations

import gc
import math
import os
import sys
import time

from . import scene as S
from .common import CACHE, Limits, cell_metrics, device_line, program_seed, read_metric


def _get(cfg, dotted):
    for part in dotted.split("."):
        cfg = getattr(cfg, part)
    return cfg


def check_settings(cfg, settings: dict) -> None:
    """The port's parsed configuration must be the one the benchmark states."""
    bad = {k: (_get(cfg, k), v) for k, v in settings.items()
           if (list(_get(cfg, k)) if isinstance(_get(cfg, k), tuple) else _get(cfg, k)) != v}
    if bad:
        raise SystemExit(f"the port's configuration differs from the benchmark's: {bad}")


def build_runner(args, cell, config, traffic, dev, stages=None):
    """The scene on disk and the Runner over it (set-up up to the warm-up);
    ``stages`` receives the seconds of each part."""
    stages = {} if stages is None else stages
    t = time.perf_counter()
    from gs_init_tpu_torch import kernels, trainer
    from gs_init_tpu_torch.config import parse_cli
    from gs_init_tpu_torch.engine import runner as prunner
    from gs_init_tpu_torch.mdi.predictors.stub import StubPredictor

    sc = config["scene"]
    scn = S.scene(sc, args.seed, dev)
    data_dir = S.ensure_on_disk(scn, sc, f"{config['name']}-{args.seed}")
    stages["scene"] = time.perf_counter() - t
    t = time.perf_counter()
    if dev.type == "cuda":
        kernels.build()
    stages["kernels"] = time.perf_counter() - t
    argv = [config["preset"], f"--data_dir={data_dir}", f"--result_dir={os.path.join(CACHE, 'out', cell['name'])}",
            f"--seed={program_seed(args.seed)}"] + config["argv"] + traffic.get("argv", [])
    cfg = parse_cli(argv, trainer.build_presets())
    cfg.adjust_steps()
    check_settings(cfg, config["settings"])
    train_cams = [i for i in range(scn.n_cams) if i % sc["test_every"]]
    calls = iter(range(1 << 62))

    def oracle(image, intr):  # the scene's depth, image after image in trainset order
        return S.cast(scn, train_cams[next(calls) % len(train_cams)])[1].cpu().numpy()

    stub = StubPredictor(oracle=oracle, scale=config["stub"]["scale"], shift=config["stub"]["shift"])
    t = time.perf_counter()
    runner = prunner.Runner(cfg, mdi_model=stub, device=dev)
    stages["runner"] = time.perf_counter() - t
    return scn, cfg, runner


class Loop:
    """``Runner.train_iteration`` with ``Runner._train_loop``'s pair-table
    retunes (the overflow read every refine cycle and the demand missed
    since the last logged step), and nothing else of that loop."""

    def __init__(self, runner):
        import torch

        self.r = runner
        self.missed = torch.zeros((), dtype=torch.int64, device=runner.device)
        self.losses, self.pairs = [], []  # each step's, on the device

    def step(self, step: int):
        import torch

        r, cfg = self.r, self.r.cfg
        s = cfg.strategy
        metrics = r.train_iteration(step)
        over = torch.as_tensor(metrics["overflow"], device=r.device)
        self.missed = torch.maximum(self.missed, torch.where(over > 0, over + metrics["pairs"], 0))
        if (step % s.refine_every == 1 and s.refine_start_iter < step < s.refine_stop_iter + 2
                and int(metrics["overflow"]) > 0):
            r._maybe_retune_capacity(metrics, step)
        if step % cfg.tb_every == 0:
            demand = int(self.missed)
            self.missed.zero_()
            r._pairs_max = max(r._pairs_max, int(metrics["pairs"]) + int(metrics["overflow"]), demand)
            if demand > 0:
                r._maybe_retune_capacity(metrics, step, overflowed=True)
        self.losses.append(metrics["loss"])
        self.pairs.append(metrics["pairs"])
        return metrics


def host(x):
    return x.detach().to("cpu", copy=True)


def snapshot(runner) -> dict:
    """The Runner's state before its first step, on the host."""
    g, a = runner.gstate, runner.adam
    return dict(
        params={k: host(v) for k, v in g.params.items()}, alive=host(g.alive),
        mu={k: host(v) for k, v in a.mu.items()}, nu={k: host(v) for k, v in a.nu.items()}, count=a.count,
        sstate={k: host(getattr(runner.sstate, k)) for k in ("grad2d", "count", "radii_max")},
        gen_state=runner.gen.get_state(),
    )


class StrategyProbe:
    """Around the first refine (default) or relocation (MCMC) of the window:
    its inputs cloned on the device, and a fingerprint of its outputs (per
    leaf, the float64 sum and a weighted sum); in the traced run, the span of
    each call with synchronises."""

    def __init__(self, runner, trace: bool):
        import torch

        from gs_init_tpu_torch.engine.strategy import default as dstrat
        from gs_init_tpu_torch.engine.strategy import mcmc

        self.kind = runner._strategy_kind
        self.mod, self.name = (dstrat, "refine") if self.kind == "default" else (mcmc, "relocate")
        self.real = getattr(self.mod, self.name)
        self.trace, self.dev = trace, runner.device
        cuda = self.dev.type == "cuda"
        self.sync = (lambda: torch.cuda.synchronize(self.dev)) if cuda else (lambda: None)
        self.captured, self.spans = None, []
        cap = runner.cfg.max_gaussians
        w = torch.Generator(device=self.dev).manual_seed(12345)
        self.weights = torch.rand((cap,), generator=w, device=self.dev, dtype=torch.float64)
        setattr(self.mod, self.name, self)

    def restore(self):
        setattr(self.mod, self.name, self.real)

    def fingerprint(self, g, a):
        leaves = [("alive", g.alive)] + [(k, v) for k, v in g.params.items()]
        leaves += [("mu." + k, v) for k, v in a.mu.items()] + [("nu." + k, v) for k, v in a.nu.items()]
        out = {}
        for k, v in leaves:
            x = v.double().reshape(v.shape[0], -1)
            out[k] = (x.sum(), (x * self.weights[:, None]).sum())
        return out

    def __call__(self, g, a, st, *rest):
        import torch

        first = self.captured is None
        if first:
            cl = lambda obj, names: {k: getattr(obj, k).clone() for k in names}
            self.captured = dict(
                params={k: v.clone() for k, v in g.params.items()}, alive=g.alive.clone(),
                mu={k: v.clone() for k, v in a.mu.items()}, nu={k: v.clone() for k, v in a.nu.items()},
                sstate=cl(st, ("grad2d", "count", "radii_max")),
                rest=[r.clone() if isinstance(r, torch.Tensor) else r for r in rest],
                gen_state=rest[0].get_state() if self.kind == "mcmc" else None,
            )
        if self.trace:
            self.sync()
            t0 = time.perf_counter()
        out = self.real(g, a, st, *rest)
        if self.trace:
            self.sync()
            self.spans.append(time.perf_counter() - t0)
        if first:
            self.captured["out"] = self.fingerprint(out[0], out[1])
        return out


class StepMarks:
    """CUDA events at the train step's own marks (``mark(name)``) and around
    the MCMC noise; read after the window."""

    def __init__(self, runner):
        from gs_init_tpu_torch.engine.strategy import mcmc

        self.runner, self.mcmc = runner, mcmc
        self.real_step, self.real_noise = runner.step_fn, mcmc.add_noise
        self.steps, self.noise = [], []
        runner.step_fn = self.step
        mcmc.add_noise = self.add_noise

    def _event(self):
        import torch

        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def step(self, *a, **kw):
        marks = [("start", self._event())]
        self.steps.append(marks)
        kw["mark"] = lambda name: marks.append((name, self._event()))
        return self.real_step(*a, **kw)

    def add_noise(self, *a, **kw):
        e0 = self._event()
        out = self.real_noise(*a, **kw)
        self.noise.append((e0, self._event()))
        return out

    def restore(self):
        self.runner.step_fn = self.real_step
        self.mcmc.add_noise = self.real_noise

    def phase_ms(self):
        out = {}
        for marks in self.steps:
            for (a, ea), (b, eb) in zip(marks, marks[1:]):
                out.setdefault(f"{a}->{b}", []).append(ea.elapsed_time(eb))
        return out

    def noise_ms(self):
        return [a.elapsed_time(b) for a, b in self.noise]


class CompositorInputs:
    """The forward compositor's inputs of each step while active (the
    profiled steps), for the benchmark's own work counts."""

    def __init__(self):
        from gs_init_tpu_torch.ops import rasterize as prast

        self.prast, self.real = prast, prast.composite_fwd
        self.seen = []
        prast.composite_fwd = self

    def __call__(self, *args, **kw):
        self.seen.append(tuple(a.detach() if hasattr(a, "detach") else a for a in args[:8]))
        return self.real(*args, **kw)

    def restore(self):
        self.prast.composite_fwd = self.real


def run(args, spec, cell, config, traffic, t_start, dev):
    import torch

    from ..reference import train_check

    torch.backends.cuda.matmul.allow_tf32 = False  # float32, as the configuration states
    torch.backends.cudnn.allow_tf32 = False
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    stages = {}
    scn, cfg, runner = build_runner(args, cell, config, traffic, dev, stages)
    start = snapshot(runner)
    if cfg.data_prefetch > 0:  # as Runner.train starts it
        from gs_init_tpu_torch.datasets.prefetch import BatchPrefetcher

        runner._prefetcher = BatchPrefetcher(runner._build_batch, len(runner.trainset), cfg.batch_size,
                                             depth=cfg.data_prefetch, seed=cfg.seed)
    loop = Loop(runner)
    w0, ws = traffic["warmup_start"], traffic["window_start"]
    n_check = traffic["check_steps"]
    ids, first_grad, after = [], None, None
    real_step = runner.step_fn

    def recording_step(*a, **kw):
        ids.append(host(a[5].image_ids))
        return real_step(*a, **kw)

    runner.step_fn = recording_step
    b1 = runner.acfg.b1
    for step in range(w0, w0 + n_check):
        loop.step(step)
        if step == w0:  # Adam's first moment after one step is (1 - b1) g
            first_grad = {k: host(v) / (1 - b1) for k, v in runner.adam.mu.items()}
    runner.step_fn = real_step
    after = dict(params={k: host(v) for k, v in runner.gstate.params.items()},
                 sstate={k: host(getattr(runner.sstate, k)) for k in ("grad2d", "count", "radii_max")})
    check_losses = [float(x) for x in loop.losses[:n_check]]
    t = time.perf_counter()
    for step in range(w0 + n_check, ws):
        loop.step(step)
    loop.losses, loop.pairs = [], []
    sync()
    stages["warm_up"] = time.perf_counter() - t
    probe = StrategyProbe(runner, args.trace)
    marks = StepMarks(runner) if args.trace and cuda else None
    data0 = runner._phase_times["data"]
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    print("setup stages " + " ".join(f"{k} {v:.3f} s" for k, v in stages.items()), file=sys.stderr, flush=True)
    step, deadline = ws, t0 + args.seconds
    marks_s = []  # host seconds at each logged step, where the loop synchronises anyway
    while time.perf_counter() < deadline:
        loop.step(step)
        if step % cfg.tb_every == 0:
            marks_s.append((step, round(time.perf_counter() - t0, 4)))
        step += 1
    sync()
    window_s = time.perf_counter() - t0
    print(f"window {step - ws} steps in {window_s:.4f} s; at logged steps {marks_s}", file=sys.stderr, flush=True)
    n_steps = step - ws
    obs = dict(window_steps=n_steps, window_s=window_s, data_wait_s=runner._phase_times["data"] - data0,
               refine_ms=[], relocate_ms=[], noise_ms=[], phase_ms={},
               pairs=torch.stack(loop.pairs).double().mean().item() if loop.pairs else None)
    reading = None
    if args.trace:
        if marks is not None:
            obs["phase_ms"] = marks.phase_ms()
            obs["noise_ms"] = marks.noise_ms()
            marks.restore()
        obs["refine_ms" if probe.kind == "default" else "relocate_ms"] = [1e3 * s for s in probe.spans]
        if cuda:
            from ..counts import composite, step_ops
            from .trace import profiled

            inputs = CompositorInputs()
            alive = []

            def profiled_steps():
                nonlocal step
                for _ in range(traffic["profile_steps"]):
                    alive.append(runner.gstate.alive.sum())
                    loop.step(step)
                    step += 1

            _, reading = profiled(profiled_steps, dev)
            inputs.restore()
            works = [composite.work(*fa) for fa in inputs.seen]
            obs["profile"] = reading
            obs["work"] = works
            obs["step_ops"] = [step_ops.step_ops(w, int(n), cfg.max_gaussians, runner.width * runner.height,
                                                 min(step // cfg.sh_degree_interval, cfg.sh_degree))
                               for w, n in zip(works, alive)]
    probe.restore()
    failed = sum(1 for x in torch.stack(loop.losses).tolist() if not math.isfinite(x)) if loop.losses else 0
    device = device_line(dev, cell["chips"], reading)
    captured = probe.captured
    kind = runner._strategy_kind
    if runner._prefetcher is not None:
        runner._prefetcher.close()
        runner._prefetcher = None
    del runner, loop, probe, marks
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # The check, once the window has closed and the program's state is freed.
    limits = Limits()
    bounds = config["limits"][traffic["generator"]]
    got = dict(losses=check_losses, first_grad=first_grad, after=after, ids=[int(i[0]) for i in ids])
    _, nums = train_check.check(limits, bounds, config, scn, start, got, captured, kind, w0, args.seed, dev,
                                control=args.control)
    if getattr(args, "calibrate", False):
        import json

        cal = train_check.calibration(config, scn, start, got, captured, kind, w0, args.seed, dev)
        print("calibration " + json.dumps(dict(seed=args.seed, program=nums, **cal)), file=sys.stderr)
    if args.trace:
        metrics = {}
        for m in cell_metrics(spec, cell["name"], True):
            v = read_metric(m["name"], obs)
            if v is not None:
                metrics[m["name"]] = (v, m["unit"])
    else:
        metrics = {"train_steps_per_s": (n_steps / window_s, "steps/s"), "setup_s": (setup_s, "s")}
        metrics = {k: v for k, v in metrics.items()
                   if k in {m["name"] for m in cell_metrics(spec, cell["name"], False)}}
    return dict(correct=limits.correct, attempted=n_steps, failed=failed, metrics=metrics, device=device,
                limits=limits, breakdown=reading["breakdown"] if reading else None)
