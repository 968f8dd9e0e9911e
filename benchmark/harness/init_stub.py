"""The monocular-depth init window with the network bypassed, the general
generator of ``"generator": "init_stub"`` traffic: what a user pays when the
depth comes from the cache, for alignment, masks, unprojection and image
loads.

Set-up: the scene from the seed (``scene.py``), the configuration through
the port's ``parse_cli`` (with the traffic's ``argv``: the stub predictor,
no depth cache), the port's parser over the scene, the scene's depth ray-cast
for every training view and held on the host, and the port's
``StubPredictor`` reading it (the configuration's ``stub``: 0.37 depth +
1.3); one warm-up call on the first ``warmup_images`` training images. The
window calls the port's ``pts_and_rgb_from_monocular_depth`` on consecutive
chunks of ``chunk_images`` training images until ``--seconds`` have passed,
as ``init.py``'s does; the check (``reference/init_stub_check.py``) follows
``check_images`` of its first ``sample_from`` images, drawn from the seed.

With ``--trace 1`` the calls pass ``per_image`` and a profiler window of
``profile_images`` images follows.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

from . import scene as S
from .common import CACHE, Limits, cell_metrics, device_line, program_seed, read_metric
from .init import chunk_parser
from .train import check_settings


class Oracle:
    """The scene's depth of the image the stub is asked for: the training
    positions of the running call, in order."""

    def __init__(self, depths):
        self.depths, self.queue = depths, []

    def __call__(self, image, intrinsics):
        return self.depths[self.queue.pop(0)]


class Recorder:
    """The per-image core of the init, observed: for the sampled images the
    stub's depth and mask and ``points_from_depth``'s output; for every
    image its kept-point count in its call, on the device."""

    def __init__(self, sample, min_fraction):
        from gs_init_tpu_torch.mdi import init as pinit

        self.sample, self.min_fraction = set(sample), min_fraction
        self.pinit, self.real = pinit, pinit.points_from_depth
        pinit.points_from_depth = self.points_from_depth
        self.pos = 0  # images aligned so far (the window's count)
        self.images, self.calls = {}, []

    def start_call(self, positions, first_pos):
        self.positions, self.first = list(positions), first_pos
        self.calls.append(dict(order=[]))

    def points_from_depth(self, depth, mask, *a, **kw):
        out = self.real(depth, mask, *a, **kw)
        p = self.pos
        self.pos += 1
        call = self.calls[-1]
        call["order"].append((p, out.mask.sum() * (out.valid_sfm_fraction >= self.min_fraction)))
        if p in self.sample:
            self.images[p] = dict(position=self.positions[p - self.first], call=len(self.calls) - 1,
                                  index=p - self.first, depth=depth.clone(), mask=mask.clone(), out=out)
        return out

    def restore(self):
        self.pinit.points_from_depth = self.real


def run(args, spec, cell, config, traffic, t_start, dev):
    import torch

    from gs_init_tpu_torch import trainer
    from gs_init_tpu_torch.config import parse_cli
    from gs_init_tpu_torch.datasets.nerfstudio import open_dataset
    from gs_init_tpu_torch.mdi.init import pts_and_rgb_from_monocular_depth
    from gs_init_tpu_torch.mdi.predictors.stub import StubPredictor

    from ..reference import init_stub_check

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    stages = {}
    sc = config["scene"]
    t = time.perf_counter()
    scn = S.scene(sc, args.seed, dev)
    data_dir = S.ensure_on_disk(scn, sc, f"{config['name']}-{args.seed}")
    stages["scene"] = time.perf_counter() - t
    t = time.perf_counter()
    argv = [config["preset"], f"--data_dir={data_dir}", f"--result_dir={os.path.join(CACHE, 'out', cell['name'])}",
            f"--seed={program_seed(args.seed)}"] + config["argv"] + traffic.get("argv", [])
    cfg = parse_cli(argv, trainer.build_presets())
    cfg.adjust_steps()
    check_settings(cfg, config["settings"])
    parser = open_dataset(cfg.data_dir, factor=cfg.data_factor, normalize=cfg.normalize_world_space,
                          test_every=cfg.test_every)
    train_cams = [i for i in range(scn.n_cams) if i % sc["test_every"]]
    oracle = Oracle([S.cast(scn, cam)[1].cpu().numpy() for cam in train_cams])
    stub = StubPredictor(oracle=oracle, scale=config["stub"]["scale"], shift=config["stub"]["shift"])
    stages["parser_and_depth"] = time.perf_counter() - t
    n_train = len(train_cams)
    c = traffic["chunk_images"]
    rng = np.random.default_rng(args.seed)
    sample = sorted(rng.choice(traffic["sample_from"], traffic["check_images"], replace=False).tolist())
    warm = traffic["warmup_images"]

    def call(positions, model, per_image=None):
        oracle.queue = list(positions)
        return pts_and_rgb_from_monocular_depth(cfg, chunk_parser(parser, positions), model=model, device=dev,
                                                per_image=per_image)

    t = time.perf_counter()
    call(range(warm), stub)
    stages["warm_up"] = time.perf_counter() - t
    rec = Recorder([warm + s for s in sample], cfg.mdi.alignment.min_valid_sfm_fraction)
    per_image = [] if args.trace else None
    pos = warm
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    print("setup stages " + " ".join(f"{k} {v:.3f} s" for k, v in stages.items()), file=sys.stderr, flush=True)
    deadline = t0 + args.seconds
    rec.pos = pos  # window positions count from the warm-up's end
    while True:
        positions = [p % n_train for p in range(pos, pos + c)]
        rec.start_call(positions, pos)
        pts, rgb = call(positions, stub, per_image)
        if any(pos + k in rec.sample for k in range(c)):
            rec.calls[-1].update(pts=pts, rgb=rgb)
        pos += c
        if time.perf_counter() >= deadline:
            break
    sync()
    window_s = time.perf_counter() - t0
    n_images = pos - warm
    rec.restore()
    obs = dict(window_s=window_s, images=n_images, per_image=per_image)
    reading = None
    if args.trace and cuda:
        from .trace import profiled

        n_prof = traffic["profile_images"]
        positions = [p % n_train for p in range(pos, pos + n_prof)]
        per_prof = []
        _, reading = profiled(lambda: call(positions, stub, per_prof), dev)
        obs.update(profile=reading, profile_images=n_prof, per_image_profiled=per_prof)
    device = device_line(dev, cell["chips"], reading)
    limits = Limits()
    init_stub_check.check(limits, config["limits"]["init"], config, scn,
                          dict(images=rec.images, calls=rec.calls, sample=[warm + s for s in sample]),
                          program_seed(args.seed), dev)
    if args.trace:
        metrics = {}
        for m in cell_metrics(spec, cell["name"], True):
            v = read_metric(m["name"], obs)
            if v is not None:
                metrics[m["name"]] = (v, m["unit"])
    else:
        metrics = {"init_s_per_image": (window_s / n_images, "s/image"), "setup_s": (setup_s, "s")}
    return dict(correct=limits.correct, attempted=n_images, failed=0, metrics=metrics, device=device,
                limits=limits, breakdown=reading["breakdown"] if reading else None)
