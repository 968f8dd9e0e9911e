"""Seconds an image of the alignment and unprojection in the window: the
port's own ``per_image[i]["stages"]``, ``align_and_unproject`` on the default
path, else ``align`` plus ``unproject``."""
import statistics


def read(obs):
    xs = []
    for p in obs.get("per_image") or []:
        st = p["stages"]
        if "align_and_unproject" in st:
            xs.append(st["align_and_unproject"])
        elif "align" in st:
            xs.append(st["align"] + st.get("unproject", 0.0))
    return statistics.mean(xs) if xs else None
