#!/usr/bin/env python3
"""Measurements on one NVIDIA H100 that calibrate checks of chip_smoke.py
or read the port's tracer; not part of chip_smoke.py's run.

    python3 chip_measure.py curve-witness    # ~4 minutes on the card
    python3 chip_measure.py growth-variants  # ~4 minutes on the card
    python3 chip_measure.py trace-probe --workload <cell> --seed <n> [options]
    python3 chip_measure.py span-cost        # ~1 minute on the card
    python3 chip_measure.py sam-garden [--seed <n>]  # ~10 minutes on the card

curve-witness: phase 11's 185-camera garden scene, a cache of the stub's
predictions, and two one-rank runs of phase 13 (b)'s config from it
(chip_smoke.cached_run): how far two runs of one config part in loss,
over the first CURVE_STEPS steps and to step 99. K2 sums with float
atomics, so this is the spread that the mesh's MESH_CURVE_RTOL and
MESH_PRE_REFINE_RTOL stand on.

growth-variants: phase 10's scene and its growth run (chip_smoke.growth_run)
at a lower growth threshold and earlier refines than the default preset's,
each held to the growth run's checks (the cloud more than doubles, a
retune grows the pair table after a refine): the measurement behind
GROWTH_STEPS and GROWTH_OVERRIDES.

trace-probe: one cell of BENCHMARK.json, built in this process by the
benchmark's own harness (``benchmark/harness``), then windows with the
port's tracer (``gs_init_tpu_torch/trace.py``) off and on in turns (off, on,
on, off, ...), each from the same step (train) or over the next images
(init); then the lines that synchronise the host with the card over a few
steps (torch's sync debug mode) and a few profiled steps or images with the
tracer off and with it on (the idle gaps by program span). A window either
runs ``--window`` seconds or, with ``--blocks N``, a fixed block: the N
steps before step 700 (100 by default: one refine or relocation; 10: none)
or three chunks of images. Writes
``probe-<cell>.json`` (every window's report) under ``--out`` and prints a
line per window, then ``SUMMARY`` (the rates off and on, the tracer's cost,
the idle shares and gaps) and ``SYNCS``. ``--root`` runs another checkout's
harness and program (a parent without the tracer runs its off windows
only); ``--device cpu`` rehearses a tiny checkout without the card (no
profiles, no sync sites).

span-cost: host microseconds a span costs, off and on, by part (the flag
check, ``record_function``, a pair of timing events, an event query), with
the card idle and busy.

sam-garden: the benchmark's garden-sam.init cell built by its harness (the
seeded garden scene, Metric3D large and SAM ViT-H with the benchmark's random
weights) on the card, then one ``pts_and_rgb_from_monocular_depth`` over
every training image, as a user's init runs, with the port's tracer on:
seconds an image, the host's resident memory before each image and after the
call, the card's peak memory, the images that failed (the call goes on image
by image past a failure) and the tracer's report. Writes
``results/sam-garden/sam-garden-<seed>.json``; ~10 minutes on the card.
"""
import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import chip_smoke as cs

# (steps, overrides on top of the stride-40 init) of each growth variant.
GROWTH_VARIANTS = (
    (800, ["--strategy.refine_start_iter=100", "--strategy.grow_grad2d=0.0001"]),
    (700, ["--strategy.refine_start_iter=100", "--strategy.grow_grad2d=0.00005"]),
)
BASE_GROWTH = ["--init_type=monocular_depth", "--mdi.predictor=stub", "--mdi.use_cache=false",
               "--mdi.subsample_factor=40"]


def curve_witness(dev, card, tmp):
    garden = cs.garden_files(dev, card, tmp, **cs.GARDEN_FULL)
    data_dir, parser, depths, _ = garden
    cache = os.path.join(tmp, "witness_cache")
    cs.write_stub_cache(cache, data_dir, parser, depths)
    argv = ["default", f"--data_dir={data_dir}", "--data_factor=1", f"--max_steps={cs.MESH_STEPS}",
            f"--eval_steps=[{cs.MESH_STEPS}]", f"--save_steps=[{cs.MESH_STEPS}]", "--init_type=monocular_depth",
            "--mdi.predictor=stub", f"--mdi.cache_dir={cache}", *cs.MESH_OVERRIDES, "--mesh=off"]
    runs = []
    for i in range(2):
        rec, runner = cs.cached_run(argv + [f"--result_dir={os.path.join(tmp, f'w{i}')}"], dev, sharded=False)
        runs.append(rec)
        del runner
        cs.release()
    g = cs.curve_gaps(runs[0]["loss"], runs[1]["loss"])
    cs.log(f"  [{card}] two one-rank runs of phase 13 (b)'s config: loss max rel gap over steps 0-"
           f"{cs.CURVE_STEPS - 1} {max(g[:cs.CURVE_STEPS]):.3e}, 0-99 {max(g[:100]):.3e}; the same initial state "
           f"{runs[0]['digest'] == runs[1]['digest']}; PSNR {runs[0]['psnr']:.4f} and {runs[1]['psnr']:.4f}; "
           f"refines (step, alive, granted) {[(x['step'], x['alive'], x['granted']) for x in runs[0]['refine']]} "
           f"and {[(x['step'], x['alive'], x['granted']) for x in runs[1]['refine']]}")


def growth_variants(dev, card, tmp):
    from gs_init_tpu_torch.datasets.parser import Parser
    from gs_init_tpu_torch.datasets.synthetic import write_colmap_scene

    g = cs.GARDEN
    scene, _ = cs.garden_scene(dev, g["n_cams"], g["width"], g["height"], g["n_fg"], g["n_bg"])
    data_dir = write_colmap_scene(tmp, scene._replace(surface_depths=cs.sfm_visible_depth(scene, g["n_sfm"])),
                                  n_points=g["n_sfm"])
    stub = cs.surface_depth_stub(scene, Parser(data_dir, factor=1, test_every=cs.GARDEN_TEST_EVERY))
    del scene
    failed = []
    for i, (steps, extra) in enumerate(GROWTH_VARIANTS):
        cs.GROWTH_STEPS, cs.GROWTH_OVERRIDES = steps, BASE_GROWTH + extra
        f = cs.growth_run(data_dir, os.path.join(tmp, f"g{i}"), card, dev, g["capacity"], stub)
        cs.log(f"  [{card}] variant {i} ({steps} steps, {' '.join(extra)}): {'passed' if not f else f}")
        failed += f
        cs.release()
    return failed


def probe_args(argv):
    ap = argparse.ArgumentParser(prog="chip_measure.py trace-probe")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--window", type=float, default=8.0, help="seconds a window, without --blocks")
    ap.add_argument("--blocks", type=int, nargs="?", const=100, default=0,
                    help="fixed blocks: steps [700 - N, 700) (N 100 by default), or 3 chunks of images")
    ap.add_argument("--turns", type=int, default=None,
                    help="groups of four windows (off, on, on, off); 3 by default, 5 with --blocks")
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--out", default=os.path.join("results", "trace-probe"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def trace_probe(opts) -> dict:
    """The readings of trace-probe (see the module's doc); returns the
    summary it prints."""
    t_start = time.perf_counter()
    root, out = os.path.abspath(opts.root), os.path.abspath(opts.out)
    sys.path.insert(0, root)
    os.chdir(root)
    from benchmark.harness import common

    common.cache_env()
    import torch

    from benchmark.harness.trace import profiled

    try:
        from gs_init_tpu_torch import trace as tracer
    except ImportError:  # a checkout from before the tracer
        tracer = None
    cpu = opts.device == "cpu"
    dev = torch.device("cpu") if cpu else torch.device("cuda", 0)
    if not cpu:
        torch.cuda.set_device(dev)
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def sync():
        if not cpu:
            torch.cuda.synchronize(dev)

    cell, config, traffic = common.find_cell(common.benchmark_spec(), opts.workload)
    args = argparse.Namespace(seed=opts.seed, trace=0, control=None, calibrate=False)
    os.makedirs(out, exist_ok=True)
    turns = opts.turns or (5 if opts.blocks else 3)
    pattern = [0, 1, 1, 0] * turns if tracer is not None else [0, 0] * turns
    train = traffic["generator"] == "train"

    def set_on(on):
        if tracer is None:
            return
        if on:
            tracer.enable(dev)
            tracer.reset()
        else:
            tracer.disable()

    def profile(fn):
        if cpu:
            fn()
            return dict(busy_s=0.0, window_s=1.0, breakdown=dict(idle_gaps=[]), kernels={})
        _, reading = profiled(fn, dev)
        return dict(busy_s=reading["busy_s"], window_s=reading["window_s"], breakdown=reading["breakdown"],
                    kernels={k: v[1] for k, v in reading["kernels"].items()})

    def per(rep, name, key, n=1.0):
        s = rep["spans"].get(name)
        return None if s is None or s[key] is None else s[key] / n

    res = dict(workload=opts.workload, seed=opts.seed, tracer=tracer is not None, windows=[], profiles={})
    set_on(1)
    if train:
        from benchmark.harness import train as H
        from gs_init_tpu_torch.datasets.prefetch import BatchPrefetcher

        stages = {}
        _, cfg, runner = H.build_runner(args, cell, config, traffic, dev, stages)
        runner._prefetcher = BatchPrefetcher(runner._build_batch, len(runner.trainset), cfg.batch_size,
                                             depth=cfg.data_prefetch, seed=cfg.seed)
        loop = H.Loop(runner)
        ws = traffic["window_start"]
        for st in range(traffic["warmup_start"], ws):
            loop.step(st)

        def window():
            first = 700 - opts.blocks if opts.blocks else ws
            step, t0 = first, time.perf_counter()
            while (step < 700) if opts.blocks else (time.perf_counter() < t0 + opts.window):
                loop.step(step)
                step += 1
            return step - first

        def reading(rep, n):
            c = rep["counters"]
            calls = sum(rep["spans"].get(k, {}).get("n", 0) for k in ("strategy.refine", "strategy.relocate"))
            changed = sum(c.get(k, 0) for k in ("strategy.grown", "strategy.pruned", "strategy.relocated"))
            return dict(host_ms=per(rep, "train_step", "median_host_ms"),
                        iter_host_ms=per(rep, "runner.iteration", "median_host_ms"),
                        overflow_share=100.0 * c.get("tiles.overflow", 0)
                        / max(c.get("tiles.pairs", 0) + c.get("tiles.overflow", 0), 1),
                        changed_per_call=changed / calls if calls else None)

        def sync_work():
            for st in range(600, 604):
                loop.step(st)

        def profile_work():
            for i in range(traffic["profile_steps"]):
                loop.step(ws + i)

        close = runner._prefetcher.close
    else:
        from benchmark.harness import init as HI
        from gs_init_tpu_torch.mdi.init import pts_and_rgb_from_monocular_depth as run_init

        stages = {}
        _, cfg, parser, model, _ = HI.build(args, cell, config, traffic, dev, stages)
        n_train = len(parser.split_indices("train"))
        chunk = traffic["chunk_images"]
        pos = [1]

        def images(n):
            run_init(cfg, HI.chunk_parser(parser, [p % n_train for p in range(pos[0], pos[0] + n)]),
                     model=model, device=dev)
            pos[0] += n

        run_init(cfg, HI.chunk_parser(parser, range(traffic["warmup_images"])), model=model, device=dev)

        def window():
            n, t0 = 0, time.perf_counter()
            while not ((n >= 3 * chunk) if opts.blocks else (n and time.perf_counter() >= t0 + opts.window)):
                images(chunk)
                n += chunk
            return n

        def reading(rep, n):
            return dict(load_s=per(rep, "datasets.load", "host_ms", 1e3 * n),
                        predict_device_s=per(rep, "init.predict", "device_ms", 1e3 * n),
                        predict_host_s=per(rep, "init.predict", "host_ms", 1e3 * n),
                        align_unproject_s=per(rep, "init.align_unproject", "host_ms", 1e3 * n),
                        init_self_s=per(rep, "init", "self_host_ms", 1e3 * n))

        def sync_work():
            images(2)

        def profile_work():
            images(traffic["profile_images"])

        def close():
            return None

    sync()
    res["setup_s"] = time.perf_counter() - t_start
    res["stages"] = stages
    if tracer is not None:
        res["setup_report"] = tracer.report()
    unit = "steps" if train else "images"
    for on in pattern:
        set_on(on)
        sync()
        t0 = time.perf_counter()
        n = window()
        sync()
        dt = time.perf_counter() - t0
        w = {"on": on, unit: n, "s": dt}
        w.update(rate=n / dt) if train else w.update(s_per_image=dt / n)
        if on:
            rep = tracer.report()
            w.update(reading(rep, n), report=rep)
        set_on(0)
        res["windows"].append(w)
        print(json.dumps({k: v for k, v in w.items() if k != "report"}), flush=True)
    res["sync_sites"] = {} if cpu else sync_sites(sync_work, torch, dev)
    for on in ([0, 1] if tracer is not None else [0]):
        set_on(on)
        key = "on" if on else "off"
        res["profiles"][key] = profile(profile_work)
        if on:
            res["profiles"][key]["report"] = tracer.report()
        set_on(0)
    close()
    res["device"] = "cpu" if cpu else torch.cuda.get_device_name(dev)
    with open(os.path.join(out, f"probe-{opts.workload}.json"), "w") as f:
        json.dump(res, f, indent=1)
    key = "rate" if train else "s_per_image"
    off = [w[key] for w in res["windows"] if not w["on"]]
    on = [w[key] for w in res["windows"] if w["on"]]
    summary = dict(workload=opts.workload, seed=opts.seed, setup_s=res["setup_s"], off=off, on=on)
    if on:
        # The tracer's cost: the rate lost (train) or the seconds an image added (init), in %, of
        # the medians, and of each on window against its neighbouring off window (off, on, on, off):
        # the quartiles and the median of those pairs.
        sign = 1 if train else -1
        summary["cost_pct"] = sign * 100.0 * (statistics.median(off) - statistics.median(on)) / statistics.median(off)
        ws = [w[key] for w in res["windows"]]
        pairs = [sign * 100.0 * (a - b) / a for i in range(0, len(ws) - 3, 4)
                 for a, b in ((ws[i], ws[i + 1]), (ws[i + 3], ws[i + 2]))]
        summary["cost_pairs_pct"] = statistics.quantiles(pairs, n=4) if len(pairs) > 1 else pairs
    for k, p in res["profiles"].items():
        summary[f"idle_{k}"] = 1 - p["busy_s"] / p["window_s"]
        summary[f"gaps_{k}"] = p["breakdown"]["idle_gaps"][:6]
    print("SUMMARY " + json.dumps(summary), flush=True)
    print("SYNCS " + json.dumps(res["sync_sites"]), flush=True)
    return summary


def sync_sites(fn, torch, dev) -> dict:
    """The port's (or the harness's) lines that synchronised the host with
    the card while ``fn`` ran, by torch's sync debug mode, with their
    counts."""
    import collections
    import traceback
    import warnings

    sites = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "gs_init_tpu_torch" in f.filename or "/benchmark/" in f.filename]
        if frames:
            f = frames[-1]
            where = f.filename.split("/gs_init_tpu_torch/")[-1].split("/benchmark/")[-1]
            sites[f"{where}:{f.lineno} {f.line}"] += 1
        else:
            sites[f"{filename}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode(1)
        try:
            fn()
            torch.cuda.synchronize(dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return dict(sites)


def span_cost(dev) -> None:
    """Host microseconds a span and its parts cost (the loop's mean)."""
    import torch

    from gs_init_tpu_torch import trace

    x = torch.randn(4096, 4096, device=dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    stream = torch.cuda.current_stream(dev)

    def bench(label, fn, n=20000, busy=False):
        torch.cuda.synchronize(dev)
        if busy:  # ~40 large products queued ahead of the loop
            for _ in range(40):
                x @ x
        t = time.perf_counter()
        for _ in range(n):
            fn()
        dt = time.perf_counter() - t
        torch.cuda.synchronize(dev)
        cs.log(f"  {label:44s} {1e6 * dt / n:9.2f} us")

    def span():
        with trace.span("a"):
            pass

    def nested():
        with trace.span("a"):
            with trace.span("b"):
                pass

    def events():
        ev[0].record(stream)
        ev[1].record(stream)

    def record_function():
        with torch.profiler.record_function("a"):
            pass

    def launch():
        x[0, 0].add_(1)

    trace.disable()
    bench("off: span", span)
    bench("record_function enter and exit", record_function)
    bench("2 event records", events)
    bench("event query", lambda: ev[1].query())
    bench("one tiny kernel launch", launch)
    trace.enable("cpu")
    trace.reset()
    bench("on, host clock only: span", span)
    trace.enable(dev)
    trace.reset()
    bench("on, with events: span", span)
    bench("on, with events: nested pair", nested, n=10000)
    bench("on, with events: span, card busy", span, n=2000, busy=True)
    bench("tiny launch, card busy", launch, n=2000, busy=True)
    bench("2 event records, card busy", events, n=2000, busy=True)
    trace.disable()
    trace.reset()


def rss_bytes() -> int:
    """This process's resident set, from /proc/self/status."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def sam_garden(argv) -> int:
    """The readings of sam-garden (see the module's doc); returns the number
    of images that failed."""
    ap = argparse.ArgumentParser(prog="chip_measure.py sam-garden")
    ap.add_argument("--seed", type=int, default=2654435769)
    opts = ap.parse_args(argv)
    from benchmark.harness import common

    common.cache_env()
    import numpy as np
    import torch

    from benchmark.harness.init import build, chunk_parser
    from benchmark.harness.init_sam import sam_generator
    from gs_init_tpu_torch import trace
    from gs_init_tpu_torch.mdi import init as pinit

    dev = torch.device("cuda", 0)
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell, config, traffic = common.find_cell(common.benchmark_spec(), "garden-sam.init")
    args = argparse.Namespace(seed=opts.seed, trace=0, control=None, calibrate=False)
    t = time.perf_counter()
    _, cfg, parser, model, _ = build(args, cell, config, traffic, dev, {})
    sam_generator(cfg, config, opts.seed, dev)
    setup_s = time.perf_counter() - t
    n = len(parser.split_indices("train"))
    view = chunk_parser(parser, range(n))
    rss, starts, failed = [], [], []

    class Watched:  # the predictor, with the host's memory before each image
        def predict_depth_batch(self, images, intrinsics):
            rss.append(rss_bytes())
            starts.append(time.perf_counter())
            return model.predict_depth_batch(images, intrinsics)

    real_align = pinit.align_depth

    def align_depth(*a, **kw):  # an image that fails is recorded and left out, as a skipped one
        try:
            return real_align(*a, **kw)
        except Exception as e:  # noqa: BLE001 - any failure of one image is what this records
            failed.append(dict(image=len(starts) - 1, error=repr(e)[:500]))
            h, w = a[0].shape
            return np.full((h, w), -42.0, np.float32), np.zeros((h, w), bool)

    pinit.align_depth = align_depth
    torch.cuda.reset_peak_memory_stats(dev)
    trace.enable(dev)
    trace.reset()
    per_image = []
    t0 = time.perf_counter()
    try:
        pts, _ = pinit.pts_and_rgb_from_monocular_depth(cfg, view, model=Watched(), device=dev, per_image=per_image)
    finally:
        pinit.align_depth = real_align
    torch.cuda.synchronize(dev)
    total_s = time.perf_counter() - t0
    rep = trace.report()
    trace.disable()
    res = dict(
        seed=opts.seed, images=n, setup_s=setup_s, total_s=total_s, s_per_image=total_s / n,
        points=len(pts), rss_before_image=rss, rss_after=rss_bytes(), image_start_s=[s - t0 for s in starts],
        per_image=[dict(seconds=p["seconds"], stages=p["stages"], align_parts=p["align_parts"]) for p in per_image],
        peak_device_bytes=int(torch.cuda.max_memory_allocated(dev)), failed=failed, trace=rep, card=cs.card_line())
    out = os.path.join("results", "sam-garden")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"sam-garden-{opts.seed}.json"), "w") as f:
        json.dump(res, f)
    gib = 2.0**30
    after = lambda i: rss[i] if i < len(rss) else res["rss_after"]  # noqa: E731 - before image i is after i - 1
    cs.log(f"sam-garden: {n} images in {total_s:.1f} s ({total_s / n:.3f} s an image), set-up {setup_s:.1f} s; "
           f"host RSS after image 10 {after(10) / gib:.3f} GiB, after image {n} {res['rss_after'] / gib:.3f} GiB; "
           f"card peak {res['peak_device_bytes'] / gib:.2f} GiB; {len(failed)} failed; {len(pts)} points")
    spans = {k: {kk: v[kk] for kk in ("n", "host_ms", "device_ms")} for k, v in rep["spans"].items()}
    cs.log("SPANS " + json.dumps(spans))
    cs.log("COUNTERS " + json.dumps(rep["counters"]))
    return len(failed)


def main(argv):
    import torch

    cmds = ("curve-witness", "growth-variants", "trace-probe", "span-cost", "sam-garden")
    if not argv or argv[0] not in cmds or (argv[0] not in ("trace-probe", "sam-garden") and len(argv) != 1):
        print(__doc__, file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    if argv[0] == "sam-garden":
        if not torch.cuda.is_available():
            print("chip_measure.py sam-garden needs a CUDA card", file=sys.stderr)
            return 2
        failed = sam_garden(argv[1:])
        cs.log(f"{argv[0]}: {time.perf_counter() - t0:.1f} s")
        return 1 if failed else 0
    if argv[0] == "trace-probe":
        opts = probe_args(argv[1:])
        if opts.device == "cuda" and not torch.cuda.is_available():
            print("chip_measure.py trace-probe needs a CUDA card, or --device cpu", file=sys.stderr)
            return 2
        if opts.device == "cuda":
            cs.log(cs.card_line())
        trace_probe(opts)
        cs.log(f"{argv[0]} {opts.workload}: {time.perf_counter() - t0:.1f} s")
        return 0
    if not torch.cuda.is_available():
        print("chip_measure.py needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    if argv[0] == "span-cost":
        cs.log(card)
        torch.cuda.set_device(dev)
        span_cost(dev)
        return 0
    cs.build_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        failed = curve_witness(dev, card, tmp) if argv[0] == "curve-witness" else growth_variants(dev, card, tmp)
    cs.log(f"{argv[0]}: {time.perf_counter() - t0:.1f} s")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
