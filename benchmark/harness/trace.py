"""A ``torch.profiler`` window and what the benchmark reads from its trace:
device time by kernel name, the union of device-busy intervals, and the
longest idle gaps by what the host was doing meanwhile."""
from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict

from .common import CACHE

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
ATTRIBUTED_GAPS = 400
HOST_LOOKBACK = 4000


def profiled(fn, dev):
    """Run ``fn()`` under the profiler; returns (fn's result, the reading)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t0
    os.makedirs(CACHE, exist_ok=True)
    path = os.path.join(CACHE, f"trace-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return out, read_trace(events, window_s)


def read_trace(events, window_s: float) -> dict:
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    by_name = defaultdict(lambda: [0.0, 0])
    for a, b, name in dev:
        by_name[name][0] += (b - a) * 1e-6
        by_name[name][1] += 1
    # Union of the busy intervals, and the gaps between its segments.
    busy, gaps = 0.0, []
    cur = None
    for a, b, _ in dev:
        if cur is None:
            cur = [a, b]
        elif a > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], a))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS)
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    for n, (a, b) in enumerate(gaps):
        if n >= ATTRIBUTED_GAPS:
            idle["(shorter gaps)"] += (b - a) * 1e-6
            continue
        mid = 0.5 * (a + b)
        inner = None
        # The innermost host event over the gap's middle, among those that
        # started at most HOST_LOOKBACK events before it.
        i = bisect.bisect_right(starts, mid)
        for ha, hb, name in host[max(0, i - HOST_LOOKBACK):i]:
            if hb >= mid and (inner is None or hb - ha < inner[1] - inner[0]):
                inner = (ha, hb, name)
        idle[inner[2] if inner else "(no host event)"] += (b - a) * 1e-6
    top = lambda d, key: sorted(d.items(), key=key, reverse=True)[:10]
    return dict(
        busy_s=busy * 1e-6, window_s=window_s,
        kernels={k: tuple(v) for k, v in by_name.items()},
        breakdown=dict(
            device_ops=[[k, v[0]] for k, v in top(by_name, lambda kv: kv[1][0])],
            idle_gaps=[[k, v] for k, v in top(idle, lambda kv: kv[1])],
        ),
    )


def kernel_seconds(reading: dict, fragment: str):
    """(device seconds, launches) of the kernels whose name holds ``fragment``."""
    s, n = 0.0, 0
    for name, (sec, cnt) in reading["kernels"].items():
        if fragment in name:
            s += sec
            n += cnt
    return s, n
