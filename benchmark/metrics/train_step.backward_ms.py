"""Median device time per window step of the backward, the compositor's K2 included: CUDA events at the
train step's own marks ``loss`` and ``backward``."""
import statistics


def read(obs):
    xs = obs.get("phase_ms", {}).get("loss->backward")
    return statistics.median(xs) if xs else None
