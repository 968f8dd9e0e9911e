"""Seconds an image of the segmentation in the window: the port's own
``per_image[i]["align_parts"]["segment"]`` (SAM's mask generation on the
depth and normal images, the painting and its postprocess)."""
import statistics


def read(obs):
    xs = [p["align_parts"]["segment"] for p in obs.get("per_image") or [] if "segment" in p.get("align_parts", {})]
    return statistics.mean(xs) if xs else None
