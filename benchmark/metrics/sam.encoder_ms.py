"""Device milliseconds of SAM's image encoder per mask-generator call in the
window: the CUDA events of the port's ``sam.encode`` spans over the number
of ``sam.generate`` spans (one encoder pass a call)."""


def read(obs):
    spans = (obs.get("trace") or {}).get("spans", {})
    enc, calls = spans.get("sam.encode"), spans.get("sam.generate")
    if not enc or not calls or enc.get("device_ms") is None or not calls["n"]:
        return None
    return enc["device_ms"] / calls["n"]
