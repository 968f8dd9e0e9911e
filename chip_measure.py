#!/usr/bin/env python3
"""Measurements on one NVIDIA H100 that calibrate checks of chip_smoke.py;
not part of its run.

    python3 chip_measure.py curve-witness    # ~4 minutes on the card
    python3 chip_measure.py growth-variants  # ~4 minutes on the card

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
"""
import os
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


def main(argv):
    import torch

    if len(argv) != 1 or argv[0] not in ("curve-witness", "growth-variants"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_measure.py needs a CUDA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.build_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        failed = curve_witness(dev, card, tmp) if argv[0] == "curve-witness" else growth_variants(dev, card, tmp)
    cs.log(f"{argv[0]}: {time.perf_counter() - t0:.1f} s")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
