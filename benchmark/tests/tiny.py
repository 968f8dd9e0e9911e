"""A copy of the benchmark at a tiny size, for its CPU tests: the benchmark's
folder and the port's package in a temporary checkout, with a
``BENCHMARK.json`` whose cells are tiny versions of the real ones (found by
name, as a later change's new configuration would be)."""
from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

TINY_SCENE = dict(width=96, height=64, cameras=16, sfm_points=400)
TINY_ARGV = ["--max_gaussians=3000", "--mdi.subsampling.factor=2", "--strategy.cap_max=3000"]


def tiny_config(name: str) -> dict:
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        c = json.load(f)
    c = copy.deepcopy(c)
    c["name"] = "tiny-" + name
    c["scene"].update(TINY_SCENE)
    argv = [a for a in TINY_ARGV if c["preset"] == "mcmc" or "cap_max" not in a]
    c["argv"] = c["argv"] + argv
    c["settings"]["max_gaussians"] = 3000
    c["argv"].append("--mdi.backbone=vits")  # Metric3D small: the CPU runs ViT-L too slowly
    c["settings"]["mdi.backbone"] = "vits"
    c["settings"]["mdi.subsampling.factor"] = 2
    if "strategy.cap_max" in c["settings"]:
        c["settings"]["strategy.cap_max"] = 3000
    return c


def make_copy(tmp: str, cells=("garden-default.train", "garden-mcmc.train", "garden-default.init")) -> str:
    """A checkout under ``tmp`` whose BENCHMARK.json holds ``tiny-<cell>``
    for each of ``cells``; returns its root."""
    root = os.path.join(tmp, "checkout")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    os.symlink(os.path.join(ROOT, "gs_init_tpu_torch"), os.path.join(root, "gs_init_tpu_torch"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    configs = {c["name"]: c for c in spec["configs"]}
    tiny = dict(spec, configs=[], workloads=[])
    for cell in cells:
        w = next(w for w in spec["workloads"] if w["name"] == cell)
        conf = configs[w["config"]]
        c = tiny_config(conf["name"])
        path = f"benchmark/configs/{c['name']}.json"
        with open(os.path.join(root, path), "w") as f:
            json.dump(c, f)
        if c["name"] not in {x["name"] for x in tiny["configs"]}:
            tiny["configs"].append(dict(conf, name=c["name"], file=path))
        traffic = "tiny-" + w["traffic"]
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
            t = json.load(f)
        if t["generator"] == "train":  # a refine at the window's first step
            t.update(warmup_start=597, window_start=600)
        else:
            t.update(chunk_images=2, sample_from=2, check_images=1, profile_images=1)
        with open(os.path.join(root, "benchmark", "traffic", traffic + ".json"), "w") as f:
            json.dump(t, f)
        tiny["workloads"].append(dict(w, name="tiny-" + cell, config=c["name"], traffic=traffic))
    for m in tiny["end_to_end"] + tiny["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny-" + n for n in m["workloads"]]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(tiny, f)
    return root


def run_cell(root: str, workload: str, seed: int = 7, seconds: float = 1.0, trace: int = 0, extra=(),
             env=None, timeout=900):
    """``benchmark/run.py`` on the CPU in a fresh interpreter; returns the
    completed process."""
    cmd = [sys.executable, "benchmark/run.py", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace), "--device", "cpu", *extra]
    e = dict(os.environ, JAX_PLATFORMS="cpu", **(env or {}))
    return subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=timeout, env=e)
