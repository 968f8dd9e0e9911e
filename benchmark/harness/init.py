"""The monocular-depth init window, the general generator of ``"generator":
"init"`` traffic.

Set-up: the scene from the seed (``scene.py``, shared with the training
cells of the same configuration), the configuration through the port's
``parse_cli`` (the predictor the configuration names, with random weights
allowed, and no depth cache: a cache would turn every later run into a cache
read), the port's parser over the scene, the port's predictor with the
benchmark's weights (``weights.py``), and one warm-up call on the first
``warmup_images`` training images. The window calls the port's
``pts_and_rgb_from_monocular_depth`` on consecutive chunks of
``chunk_images`` training images (round the split again after its end)
until ``--seconds`` have passed; its time runs to the end of the call that
crosses the deadline. Seconds per image are the window's seconds over its
images.

With ``--trace 1`` the calls pass ``per_image`` (the port's per-stage
seconds) and a profiler window of ``profile_images`` images follows.
"""
from __future__ import annotations

import copy
import gc
import os
import sys
import time

import numpy as np

from . import scene as S
from .common import CACHE, Limits, cell_metrics, device_line, program_seed, read_metric
from .train import check_settings


def chunk_parser(parser, positions):
    """The port's parser restricted to some of its training images, all of
    them training images of the view (test_every 0)."""
    train = parser.split_indices("train")
    view = copy.copy(parser)
    view.images = [parser.images[int(train[p])] for p in positions]
    view.test_every = 0
    return view


class Recorder:
    """The predictor and the per-image core of the init, wrapped: for the
    sampled images, the program's depth and mask as the predictor returned
    them; for every image, its alignment's output and whether it was kept."""

    def __init__(self, model, sample):
        from gs_init_tpu_torch.mdi import init as pinit

        self.model, self.sample = model, set(sample)
        self.pinit, self.real_pfd = pinit, pinit.points_from_depth
        self.pos = 0  # images predicted so far
        self.depth, self.calls = {}, []
        pinit.points_from_depth = self.points_from_depth

    def predict_depth_batch(self, images, intrinsics):
        out = self.model.predict_depth_batch(images, intrinsics)
        for k, o in enumerate(out):
            if self.pos + k in self.sample:
                self.depth[self.pos + k] = (np.array(o.depth), np.array(o.mask))
        self.pos += len(out)
        return out

    def points_from_depth(self, *a, **kw):
        out = self.real_pfd(*a, **kw)
        self.calls.append(out)
        return out

    def restore(self):
        self.pinit.points_from_depth = self.real_pfd


def build(args, cell, config, traffic, dev, stages):
    import torch

    from gs_init_tpu_torch import trainer
    from gs_init_tpu_torch.config import parse_cli
    from gs_init_tpu_torch.datasets.nerfstudio import open_dataset
    from gs_init_tpu_torch.mdi.predictors.interface import pick_model

    from .weights import random_state_dict

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
    # The benchmark hands the network its weights, as a checkpoint would: the
    # port's own random initialisation, on the host, is skipped.
    from gs_init_tpu_torch.mdi.predictors import metric3d as pm3d

    real_init, pm3d.init_random_ = pm3d.init_random_, lambda module, seed: module
    try:
        model = pick_model(cfg, device=dev)
    finally:
        pm3d.init_random_ = real_init
    with torch.device("meta"):
        like = type(model.net)(model.backbone)
    sd = random_state_dict(like, args.seed, dev)
    model.net.load_state_dict(sd)
    stages["parser_and_network"] = time.perf_counter() - t
    return scn, cfg, parser, model, sd


def run(args, spec, cell, config, traffic, t_start, dev):
    import torch

    from gs_init_tpu_torch.mdi.init import pts_and_rgb_from_monocular_depth

    from ..reference import init_check

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    stages = {}
    scn, cfg, parser, model, sd = build(args, cell, config, traffic, dev, stages)
    n_train = len(parser.split_indices("train"))
    c = traffic["chunk_images"]
    rng = np.random.default_rng(args.seed)
    sample = sorted(rng.choice(traffic["sample_from"], traffic["check_images"], replace=False).tolist())
    warm = traffic["warmup_images"]
    t = time.perf_counter()
    pts_and_rgb_from_monocular_depth(cfg, chunk_parser(parser, range(warm)), model=model, device=dev)
    stages["warm_up"] = time.perf_counter() - t
    rec = Recorder(model, [warm + s for s in sample])
    chunks = []  # (first position, positions, the call's points and colours where sampled)
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
        first = len(rec.calls)
        pts, rgb = pts_and_rgb_from_monocular_depth(cfg, chunk_parser(parser, positions), model=rec,
                                                    device=dev, per_image=per_image)
        if any(pos + k in rec.sample for k in range(c)):
            chunks.append((pos, positions, first, pts, rgb))
        pos += c
        if time.perf_counter() >= deadline:
            break
    sync()
    window_s = time.perf_counter() - t0
    n_images = pos - warm
    obs = dict(window_s=window_s, images=n_images, per_image=per_image)
    reading = None
    if args.trace and cuda:
        from ..counts import depth_net
        from .trace import profiled

        n_prof = traffic["profile_images"]
        positions = [p % n_train for p in range(pos, pos + n_prof)]
        per_prof = []
        _, reading = profiled(lambda: pts_and_rgb_from_monocular_depth(
            cfg, chunk_parser(parser, positions), model=model, device=dev, per_image=per_prof), dev)
        obs.update(profile=reading, profile_images=n_prof, per_image_profiled=per_prof,
                   net_ops=depth_net.metric3d_ops(model.backbone, dev))
    rec.restore()
    device = device_line(dev, cell["chips"], reading)
    got = dict(depth=rec.depth, calls=rec.calls, chunks=chunks, sample=[warm + s for s in sample])
    del model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = Limits()
    init_check.check(limits, config["limits"]["init"], config, scn, got, sd, program_seed(args.seed), dev, n_train,
                     control=args.control)
    if args.calibrate:
        import json

        cal = init_check.calibration(config, scn, got, sd, dev, n_train)
        print("calibration " + json.dumps(dict(seed=args.seed, program=limits.as_dict(), **cal)), file=sys.stderr)
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

