"""Median device time per window step of the projection, SH, binning and the forward compositor (K1): CUDA events at the
train step's own marks ``setup`` and ``render``."""
import statistics


def read(obs):
    xs = obs.get("phase_ms", {}).get("setup->render")
    return statistics.median(xs) if xs else None
