"""The device's idle share over the profiled training steps: one less the
union of device-busy intervals over the profiler's window, in percent."""


def read(obs):
    prof = obs.get("profile")
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
