"""Host wait on the batch prefetcher per window step: the Runner's own
``_phase_times["data"]`` over the window."""


def read(obs):
    if "data_wait_s" not in obs or not obs.get("window_steps"):
        return None
    return 1e3 * obs["data_wait_s"] / obs["window_steps"]
