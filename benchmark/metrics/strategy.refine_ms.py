"""Median milliseconds of each default-strategy refine in the window, a span with synchronises around the call."""
import statistics


def read(obs):
    xs = obs.get("refine_ms")
    return statistics.median(xs) if xs else None
