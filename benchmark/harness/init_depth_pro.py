"""The monocular-depth init window with Apple Depth Pro as the depth network,
the general generator of ``"generator": "init_depth_pro"`` traffic.

Set-up: the scene from the seed (``scene.py``), the configuration through
the port's ``parse_cli`` (the configuration names ``--mdi.predictor=
depth_pro``; the traffic allows random weights and turns the depth cache
off), the port's parser over the scene, and the port's predictor from its
``pick_model``, built without the port's own random initialisation and
loaded with the benchmark's weights (``weights.py``, drawn on the device from
the seed, then the configuration's ``set_weights`` constants); the network's
parameter shapes and input size are checked against the configuration's
``depth_pro`` group. One warm-up call on the first ``warmup_images``
training images. The window calls the port's
``pts_and_rgb_from_monocular_depth`` on consecutive chunks of
``chunk_images`` training images until ``--seconds`` have passed, as
``init.py``'s does.

What the check (``reference/init_depth_pro_check.py``) compares is kept for
``check_images`` of the window's first ``sample_from`` images, drawn from the
seed: the predictor's depth and mask, the head's pre-activation (a forward
hook on its last convolution, on the device), and for every image of a call
that holds a sampled one, ``points_from_depth``'s output and the call's
points and colours.

With ``--trace 1`` the port's tracer is on over the window (its Depth Pro
spans and counter) and the calls pass ``per_image``; a profiler window of
``profile_images`` images follows.
"""
from __future__ import annotations

import gc
import os
import sys
import time

import numpy as np

from . import scene as S
from .common import CACHE, Limits, cell_metrics, device_line, program_seed, read_metric
from .init import Recorder as InitRecorder
from .init import chunk_parser
from .train import check_settings


class Recorder(InitRecorder):
    """``init.py``'s recorder, with the head's pre-activation of the
    sampled images (the predictor runs one image at a time)."""

    def __init__(self, model, sample):
        super().__init__(model, sample)
        self.pre, self.want = {}, False
        self.hook = model.net.head.layers[-2].register_forward_hook(self.hooked)

    def predict_depth_batch(self, images, intrinsics):
        if len(images) != 1:
            raise RuntimeError("the recorder follows one image at a time (mdi.predict_batch_size 1)")
        self.want = self.pos in self.sample
        try:
            return super().predict_depth_batch(images, intrinsics)
        finally:
            self.want = False

    def hooked(self, module, inputs, out):
        if self.want:
            self.pre[self.pos] = out[0, 0].clone()

    def restore(self):
        super().restore()
        self.hook.remove()


def build(args, cell, config, traffic, dev, stages):
    """(the scene, the port's configuration, its parser, its predictor, the
    state dict the predictor was given)."""
    import torch

    from gs_init_tpu_torch import trainer
    from gs_init_tpu_torch.config import parse_cli
    from gs_init_tpu_torch.datasets.nerfstudio import open_dataset
    from gs_init_tpu_torch.mdi.predictors import apple_depth_pro as pdp
    from gs_init_tpu_torch.mdi.predictors.interface import pick_model

    from ..reference.depthnet import depth_pro as R
    from .weights import random_state_dict

    sc, widths = config["scene"], config["depth_pro"]
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
    real_init, pdp.init_random_ = pdp.init_random_, lambda module, seed: module
    try:
        model = pick_model(cfg, device=dev)
    finally:
        pdp.init_random_ = real_init
    with torch.device("meta"):
        like = R.DepthProNet(**R.widths_of(widths))
    want = {k: tuple(v.shape) for k, v in like.state_dict().items()}
    have = {k: tuple(v.shape) for k, v in model.net.state_dict().items()}
    if want != have or model.input_size != widths["input_size"]:
        raise SystemExit(f"the port's Depth Pro differs from the benchmark's: "
                         f"{sorted(set(want.items()) ^ set(have.items()))[:8]}, input {model.input_size}")
    sd = random_state_dict(model.net, args.seed, dev)
    for key, value in config.get("set_weights", {}).items():
        sd[key].fill_(value)
    model.net.load_state_dict(sd)
    stages["parser_and_network"] = time.perf_counter() - t
    return scn, cfg, parser, model, sd


def run(args, spec, cell, config, traffic, t_start, dev):
    import torch

    from gs_init_tpu_torch.mdi.init import pts_and_rgb_from_monocular_depth

    from ..reference import init_depth_pro_check

    try:
        from gs_init_tpu_torch import trace
    except ImportError:  # a port without the tracer: nothing of it to read
        trace = None
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
    chunks = []  # (first position, positions, the call's first record, its points and colours) where sampled
    per_image = [] if args.trace else None
    pos = warm
    if args.trace and trace is not None:
        trace.enable(dev)
        trace.reset()
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
    if args.trace and trace is not None:
        obs["trace"] = trace.report()
        trace.disable()
    rec.restore()
    reading = None
    if args.trace and cuda:
        from ..counts import depth_pro as counts
        from .trace import profiled

        n_prof = traffic["profile_images"]
        positions = [p % n_train for p in range(pos, pos + n_prof)]
        per_prof = []
        _, reading = profiled(lambda: pts_and_rgb_from_monocular_depth(
            cfg, chunk_parser(parser, positions), model=model, device=dev, per_image=per_prof), dev)
        from ..reference.depthnet.depth_pro import widths_of

        ops = counts.ops(config["depth_pro"]["input_size"], widths_of(config["depth_pro"]))
        obs.update(profile=reading, profile_images=n_prof, per_image_profiled=per_prof, net_ops=ops["total"],
                   depth_pro_patch_ops=ops["patch_encoder"])
    device = device_line(dev, cell["chips"], reading)
    got = dict(depth=rec.depth, pre=rec.pre, calls=rec.calls, chunks=chunks, sample=[warm + s for s in sample])
    del model, rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = Limits()
    cal = init_depth_pro_check.check(limits, config["limits"]["init"], config, scn, got, sd,
                                     program_seed(args.seed), dev, control=args.control, calibrate=args.calibrate)
    if cal is not None:
        import json

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
