"""Megabytes (10^6 bytes) the mask generator copies from the device to the
host per call in the window: the port's ``sam.host_bytes`` counter over the
number of ``sam.generate`` spans."""


def read(obs):
    tr = obs.get("trace") or {}
    calls = tr.get("spans", {}).get("sam.generate")
    n = tr.get("counters", {}).get("sam.host_bytes")
    if n is None or not calls or not calls["n"]:
        return None
    return n / 1e6 / calls["n"]
