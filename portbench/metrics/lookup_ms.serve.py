"""The front door of a served request: each flush's host ms less the
waves inside it (``serve.spgemm_wave`` spans), ms a request. That is the
``StructureCache.get`` fingerprint and the grouping."""


def read(rec):
    spans = [s for s in rec.get("spans", [])
             if s["name"] == "serve.spgemm_wave"]
    if not spans or not rec["units"]:
        return None
    wave_ms = sum(s["dur_us"] for s in spans) / 1e3
    return (sum(rec["flush_ms"]) - wave_ms) / len(rec["units"])
