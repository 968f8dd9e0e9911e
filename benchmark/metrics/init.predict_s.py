"""Seconds an image of the depth prediction in the window: the port's own
``per_image[i]["stages"]["predict"]`` of ``pts_and_rgb_from_monocular_depth``."""
import statistics


def read(obs):
    per = obs.get("per_image")
    xs = [p["stages"]["predict"] for p in per or [] if "predict" in p["stages"]]
    return statistics.mean(xs) if xs else None
