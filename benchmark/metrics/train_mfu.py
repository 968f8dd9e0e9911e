"""The whole training step's share of the card's FP32 peak: the operations
the profiled steps need (``counts/step_ops.py``), per step, over the window's
seconds per step times 67 TFLOP/s, in percent."""
from benchmark.harness.common import PEAK_FP32_FLOPS


def read(obs):
    ops, n, secs = obs.get("step_ops"), obs.get("window_steps"), obs.get("window_s")
    if not ops or not n or not secs:
        return None
    return 100.0 * (sum(ops) / len(ops)) / (secs / n * PEAK_FP32_FLOPS)
