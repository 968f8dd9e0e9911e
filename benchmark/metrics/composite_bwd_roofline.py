"""composite_bwd's share of its roofline over the profiled steps: the least
time the card could take for the work these steps' inputs need (the larger of
their FP32 operations over 67 TFLOP/s and their bytes over 3.35 TB/s, as
``counts/composite.py`` counts them) over the kernel's device time in the
profiler's trace, in percent."""
from benchmark.harness.common import PEAK_BYTES_PER_S, PEAK_FP32_FLOPS
from benchmark.harness.trace import kernel_seconds


def read(obs):
    works, prof = obs.get("work"), obs.get("profile")
    if not works or not prof:
        return None
    secs, launches = kernel_seconds(prof, "composite_bwd_kernel")
    if launches != len(works) or secs <= 0:
        return None
    least = sum(max(w["bwd_ops"] / PEAK_FP32_FLOPS, w["bwd_bytes"] / PEAK_BYTES_PER_S) for w in works)
    return 100.0 * least / secs
