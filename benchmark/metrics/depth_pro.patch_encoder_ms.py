"""Device milliseconds of Depth Pro's patch encoder a pass in the window: the
CUDA events of the port's ``depth_pro.patch_encode`` spans (the 35 crops
through the shared ViT, one span a pass) over their number."""


def read(obs):
    enc = ((obs.get("trace") or {}).get("spans") or {}).get("depth_pro.patch_encode")
    if not enc or enc.get("device_ms") is None or not enc["n"]:
        return None
    return enc["device_ms"] / enc["n"]
