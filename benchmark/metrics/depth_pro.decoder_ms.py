"""Device milliseconds of Depth Pro's decoder a pass in the window: the CUDA
events of the port's ``depth_pro.decode`` spans (the neck, the fusion stage
and the head, one span a pass) over their number."""


def read(obs):
    dec = ((obs.get("trace") or {}).get("spans") or {}).get("depth_pro.decode")
    if not dec or dec.get("device_ms") is None or not dec["n"]:
        return None
    return dec["device_ms"] / dec["n"]
