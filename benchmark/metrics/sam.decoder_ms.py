"""Device milliseconds of SAM's mask decoder per mask-generator call in the
window: the CUDA events of the port's ``sam.decode`` spans (one a batch of
point prompts), summed, over the number of ``sam.generate`` spans."""


def read(obs):
    spans = (obs.get("trace") or {}).get("spans", {})
    dec, calls = spans.get("sam.decode"), spans.get("sam.generate")
    if not dec or not calls or dec.get("device_ms") is None or not calls["n"]:
        return None
    return dec["device_ms"] / calls["n"]
