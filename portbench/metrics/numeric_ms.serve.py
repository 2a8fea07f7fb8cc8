"""The warm numeric phase (``serve.spgemm_wave`` spans), ms a request."""


def read(rec):
    spans = [s for s in rec.get("spans", [])
             if s["name"] == "serve.spgemm_wave"]
    if not spans or not rec["units"]:
        return None
    return sum(s["dur_us"] for s in spans) / 1e3 / len(rec["units"])
