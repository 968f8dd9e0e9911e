"""What every cell shares: the files found by name, the device line, the
profiler's reading, the metric readers, the limits, the result line.

A cell is ``BENCHMARK.json``'s workload entry; its configuration is the JSON
file the entry names and its traffic ``benchmark/traffic/<traffic>.json``,
whose ``generator`` names the general generator that reads it
(``benchmark/harness/<generator>.py``). A per-layer metric is read by
``benchmark/metrics/<name>.py``'s ``read(obs)``, which returns a number or None
(nothing to read: the metric is left out of the line).
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
CACHE = os.path.join(BENCH_DIR, ".cache")
# Top-level module names that must not be loaded: JAX and the JAX package.
# Compared whole: the port's own name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "gs_init_tpu")
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): FP32
# outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def find_cell(spec: dict, workload: str):
    """(the cell, its configuration file, its traffic file), each parsed."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic", cell["traffic"] + ".json"))
    return cell, config, traffic


def cell_metrics(spec: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics this cell reports: its end-to-end metrics, or with
    ``trace`` the per-layer metrics that list it (or, listing no cells, move
    one of its end-to-end metrics)."""
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]


def read_metric(name: str, obs: dict) -> Optional[float]:
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(obs)


def forbidden_modules() -> List[str]:
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def program_seed(seed: int) -> int:
    """The port's ``cfg.seed`` for a benchmark seed (its numpy RandomState
    takes 32 bits)."""
    return int(seed) % (2**31 - 1)


def device_line(dev, count: int, trace: Optional[dict]) -> dict:
    import torch

    if dev.type == "cuda":
        line = dict(platform="gpu", kind=torch.cuda.get_device_name(dev), count=count,
                    memory_peak_bytes=int(torch.cuda.max_memory_allocated(dev)))
    else:
        line = dict(platform="cpu", kind="cpu", count=count, memory_peak_bytes=0)
    if trace is not None:
        line.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    return line


class Limits:
    """The numbers that decide ``correct``, each beside its limit."""

    def __init__(self):
        self.rows = []  # (name, value, limit)

    def add(self, name: str, value: float, limit: float) -> None:
        self.rows.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.rows) and all(v == v and v <= lim for _, v, lim in self.rows)

    def text(self) -> str:
        return "\n".join(f"check {n}: {v!r} (limit {lim!r})" for n, v, lim in self.rows)

    def as_dict(self) -> Dict[str, dict]:
        return {n: dict(value=v, limit=lim) for n, v, lim in self.rows}


def emit(correct: bool, attempted: int, failed: int, metrics: Dict[str, tuple], device: dict,
         limits: Limits, breakdown: Optional[dict] = None) -> None:
    """The result: the compared numbers as the last lines of standard error,
    and one JSON line, the last of standard output."""
    line = dict(correct=bool(correct), attempted=int(attempted), failed=int(failed),
                metrics={k: dict(value=v, unit=u) for k, (v, u) in metrics.items()}, device=device)
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = limits.as_dict()
    sys.stdout.flush()
    print(limits.text(), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
