"""Median milliseconds of the MCMC noise of each window step, CUDA events around the call."""
import statistics


def read(obs):
    xs = obs.get("noise_ms")
    return statistics.median(xs) if xs else None
