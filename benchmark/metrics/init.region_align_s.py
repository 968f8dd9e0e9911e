"""Seconds an image of the region alignment and unprojection in the window,
on the pipeline path (a segmenter): the port's own ``per_image[i]["stages"]``
``align`` less its ``align_parts["segment"]`` (the segmenter's share), plus
``unproject``; that is the region merge, the margin, a RANSAC fit a region,
the masks and the unprojection."""
import statistics


def read(obs):
    xs = [p["stages"]["align"] - p["align_parts"]["segment"] + p["stages"].get("unproject", 0.0)
          for p in obs.get("per_image") or []
          if "align" in p.get("stages", {}) and "segment" in p.get("align_parts", {})]
    return statistics.mean(xs) if xs else None
