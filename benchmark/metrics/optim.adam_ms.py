"""Median device time per window step of Adam over the capacity: CUDA events at the
train step's own marks ``backward`` and ``adam``."""
import statistics


def read(obs):
    xs = obs.get("phase_ms", {}).get("backward->adam")
    return statistics.median(xs) if xs else None
