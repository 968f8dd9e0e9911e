"""The depth network's share of the card's FP32 peak: its operations an image
(``counts/depth_net.py``, from the network's shapes) over the predict seconds
an image of the profiled images (the port's ``stages["predict"]``) times
67 TFLOP/s, in percent."""
import statistics

from benchmark.harness.common import PEAK_FP32_FLOPS


def read(obs):
    ops, per = obs.get("net_ops"), obs.get("per_image_profiled")
    xs = [p["stages"]["predict"] for p in per or [] if "predict" in p["stages"]]
    if not ops or not xs:
        return None
    return 100.0 * ops / (statistics.mean(xs) * PEAK_FP32_FLOPS)
