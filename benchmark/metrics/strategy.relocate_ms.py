"""Median milliseconds of each MCMC relocation in the window, a span with synchronises around the call."""
import statistics


def read(obs):
    xs = obs.get("relocate_ms")
    return statistics.median(xs) if xs else None
