"""The monocular-depth init window with SAM regions, the general generator of
``"generator": "init_sam"`` traffic.

Set-up: as ``init.py``'s (the scene, the configuration through the port's
``parse_cli``, the parser, Metric3D with the benchmark's weights), then the
port's SAM mask generator, the one its ``_cached_generator`` hands
``segment_depth_sam``, built without the port's own random initialisation
and loaded with the benchmark's weights (``weights.py``, drawn on the device
from the seed; the prompt encoder's Fourier matrix normal(0, 1), as upstream
draws it); the generator's settings are checked against the configuration's
``amg`` group. One warm-up call on the first ``warmup_images`` training
images. The window calls the port's ``pts_and_rgb_from_monocular_depth`` on
consecutive chunks of ``chunk_images`` training images until ``--seconds``
have passed, as ``init.py``'s does.

What the check compares is kept during the window, on the device, for
``check_images`` of its first ``sample_from`` images (drawn from the seed):
the predictor's depth, mask and normals; each SAM call's embedding, multimask
logits and IoU predictions (forward hooks on the port's encoder and decoder);
the segmentation and merged regions; the generator's state at the image,
the aligned depth and mask; the unprojection mask. For every image of a
call that holds a sampled one, its kept points, to find the image's points
in the returned cloud.

With ``--trace 1`` the port's tracer is on over the window (its SAM spans
and counters) and the calls pass ``per_image``; a profiler window of
``profile_images`` images follows.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np

from .common import Limits, cell_metrics, device_line, read_metric
from .init import build as build_init
from .init import chunk_parser

SAM_SEED_OFFSET = 1  # the SAM weights' seed is the cell's seed plus this, Metric3D's the seed itself


def sam_generator(cfg, config, seed, dev):
    """The port's cached mask generator with the benchmark's weights; returns
    (the generator, the state dict it was given)."""
    import torch

    from gs_init_tpu_torch.device import resolve_device
    from gs_init_tpu_torch.mdi import segmentation_sam as pss
    from gs_init_tpu_torch.mdi.predictors.sam_convert import SAM_VARIANTS
    from gs_init_tpu_torch.models.sam import Sam

    from .weights import random_state_dict

    seg = cfg.mdi.alignment.segmentation
    real_init, pss.init_random_sam_ = pss.init_random_sam_, lambda net, s: net
    try:
        gen = pss._cached_generator(seg.sam_variant, seg.sam_allow_random_weights, seg.sam_img_size,
                                    str(resolve_device(dev)), pss.find_sam_checkpoint(seg.sam_variant))
    finally:
        pss.init_random_sam_ = real_init
    bad = {k: (getattr(gen, k), v) for k, v in config["amg"].items() if getattr(gen, k) != v}
    if bad:
        raise SystemExit(f"the port's mask generator differs from the benchmark's: {bad}")
    with torch.device("meta"):
        like = Sam(img_size=seg.sam_img_size, **SAM_VARIANTS[seg.sam_variant])
    sd = random_state_dict(like, seed + SAM_SEED_OFFSET, dev)
    key = "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"
    g = torch.Generator(device=dev).manual_seed((int(seed) + SAM_SEED_OFFSET) % 2**63)
    sd[key] = torch.randn(sd[key].shape, generator=g, device=dev)
    gen.net.load_state_dict(sd)
    return gen, sd


class Recorder:
    """The predictor, the SAM networks and the per-image pipeline of the
    init, observed: for the sampled images, everything the check compares
    (module docstring); for every image, its kept-point count in its call."""

    def __init__(self, model, sam_net, sample):
        from gs_init_tpu_torch.mdi import init as pinit
        from gs_init_tpu_torch.mdi.alignment import pipeline

        self.model, self.sample = model, set(sample)
        self.pinit, self.pipeline = pinit, pipeline
        self.real = dict(align_depth=pinit.align_depth, masks_and_unproject=pinit.masks_and_unproject,
                         merge_regions=pipeline.merge_regions)
        pinit.align_depth, pinit.masks_and_unproject = self.align_depth, self.masks_and_unproject
        pipeline.merge_regions = self.merge_regions
        self.hooks = [sam_net.image_encoder.register_forward_hook(self.encoded),
                      sam_net.mask_decoder.register_forward_hook(self.decoded)]
        self.pos = 0  # images predicted so far (the window's count)
        self.positions = []  # the current call's training-image positions
        self.images, self.calls = {}, []
        self.cur = None  # the sampled image being processed, or None

    def start_call(self, positions, first_pos):
        self.positions, self.first = list(positions), first_pos
        self.calls.append(dict(order=[]))

    def predict_depth_batch(self, images, intrinsics):
        out = self.model.predict_depth_batch(images, intrinsics)
        if len(out) != 1:
            raise RuntimeError("the recorder follows one image at a time (mdi.predict_batch_size 1)")
        p = self.pos
        self.pos += 1
        self.cur = None
        if p in self.sample:
            o = out[0]
            self.cur = self.images[p] = dict(
                position=self.positions[p - self.first], call=len(self.calls) - 1, depth=np.array(o.depth),
                mask=np.array(o.mask), normal=None if o.normal is None else np.array(o.normal), sam=[])
        return out

    def encoded(self, module, inputs, out):
        if self.cur is not None:
            self.cur["sam"].append(dict(embed=out.clone(), logits=[], iou=[]))

    def decoded(self, module, inputs, out):
        if self.cur is not None:
            call = self.cur["sam"][-1]
            call["logits"].append(out[0][:, 1:].clone())  # multimask output: tokens 1-3
            call["iou"].append(out[1][:, 1:].clone())

    def align_depth(self, *a, **kw):
        if self.cur is not None:
            self.cur["gen_state"] = kw["generator"].get_state()
        out = self.real["align_depth"](*a, **kw)
        if self.cur is not None:
            self.cur.update(aligned=np.array(out[0]), amask=np.array(out[1]))
        return out

    def merge_regions(self, labels, *a, **kw):
        out = self.real["merge_regions"](labels, *a, **kw)
        if self.cur is not None:
            self.cur.update(segment=np.array(labels), merged=np.array(out))
        return out

    def masks_and_unproject(self, *a, **kw):
        world, m = self.real["masks_and_unproject"](*a, **kw)
        self.calls[-1]["order"].append((self.pos - 1, m.sum()))
        if self.cur is not None:
            self.cur["m"] = m
        return world, m

    def restore(self):
        """The port as it was; each call's batches joined."""
        import torch

        self.pinit.align_depth = self.real["align_depth"]
        self.pinit.masks_and_unproject = self.real["masks_and_unproject"]
        self.pipeline.merge_regions = self.real["merge_regions"]
        for h in self.hooks:
            h.remove()
        for im in self.images.values():
            for call in im["sam"]:
                call["logits"], call["iou"] = torch.cat(call["logits"]), torch.cat(call["iou"])


def run(args, spec, cell, config, traffic, t_start, dev):
    import torch

    from gs_init_tpu_torch.mdi.init import pts_and_rgb_from_monocular_depth

    from ..reference import init_sam_check

    try:
        from gs_init_tpu_torch import trace
    except ImportError:  # a port without the tracer: nothing of it to read
        trace = None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    stages = {}
    scn, cfg, parser, model, sd = build_init(args, cell, config, traffic, dev, stages)
    t = time.perf_counter()
    gen, sam_sd = sam_generator(cfg, config, args.seed, dev)
    stages["sam"] = time.perf_counter() - t
    n_train = len(parser.split_indices("train"))
    c = traffic["chunk_images"]
    rng = np.random.default_rng(args.seed)
    sample = sorted(rng.choice(traffic["sample_from"], traffic["check_images"], replace=False).tolist())
    warm = traffic["warmup_images"]
    t = time.perf_counter()
    pts_and_rgb_from_monocular_depth(cfg, chunk_parser(parser, range(warm)), model=model, device=dev)
    stages["warm_up"] = time.perf_counter() - t
    rec = Recorder(model, gen.net, [warm + s for s in sample])
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
        rec.start_call(positions, pos)
        pts, rgb = pts_and_rgb_from_monocular_depth(cfg, chunk_parser(parser, positions), model=rec,
                                                    device=dev, per_image=per_image)
        if any(pos + k in rec.sample for k in range(c)):
            rec.calls[-1].update(pts=pts, rgb=rgb)
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
        from ..counts import depth_net
        from ..counts import sam as sam_counts
        from .trace import profiled

        n_prof = traffic["profile_images"]
        positions = [p % n_train for p in range(pos, pos + n_prof)]
        per_prof = []
        _, reading = profiled(lambda: pts_and_rgb_from_monocular_depth(
            cfg, chunk_parser(parser, positions), model=model, device=dev, per_image=per_prof), dev)
        seg = cfg.mdi.alignment.segmentation
        obs.update(profile=reading, profile_images=n_prof, per_image_profiled=per_prof,
                   net_ops=depth_net.metric3d_ops(model.backbone, dev),
                   sam_encoder_ops=sam_counts.encoder_ops(seg.sam_img_size, seg.sam_variant))
    device = device_line(dev, cell["chips"], reading)
    got = dict(images=rec.images, calls=rec.calls, sample=[warm + s for s in sample])
    del model, gen
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = Limits()
    cal = init_sam_check.check(limits, config["limits"]["init"], config, scn, got, sd, sam_sd, dev,
                               control=args.control, calibrate=args.calibrate)
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
