"""SAM's image encoder's share of the card's FP32 peak: its operations a pass
(``counts/sam.py``, from the network's shapes, for the image's own 4,096
tokens: the work on the windows' zero padding is not counted) over its
device time a pass (the port's ``sam.encode`` spans' CUDA events) times
67 TFLOP/s, in percent."""
from benchmark.harness.common import PEAK_FP32_FLOPS


def read(obs):
    ops = obs.get("sam_encoder_ops")
    enc = ((obs.get("trace") or {}).get("spans") or {}).get("sam.encode")
    if not ops or not enc or not enc.get("device_ms") or not enc["n"]:
        return None
    return 100.0 * ops / (enc["device_ms"] / enc["n"] * 1e-3 * PEAK_FP32_FLOPS)
