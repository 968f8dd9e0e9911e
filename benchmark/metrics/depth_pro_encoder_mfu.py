"""Depth Pro's patch encoder's share of the card's FP32 peak: its operations
a pass (``counts/depth_pro.py``: the 35 crops of 577 tokens through ViT-L/16)
over its device time a pass (the port's ``depth_pro.patch_encode`` spans'
CUDA events) times 67 TFLOP/s, in percent."""
from benchmark.harness.common import PEAK_FP32_FLOPS


def read(obs):
    ops = obs.get("depth_pro_patch_ops")
    enc = ((obs.get("trace") or {}).get("spans") or {}).get("depth_pro.patch_encode")
    if not ops or not enc or not enc.get("device_ms") or not enc["n"]:
        return None
    return 100.0 * ops / (enc["device_ms"] / enc["n"] * 1e-3 * PEAK_FP32_FLOPS)
