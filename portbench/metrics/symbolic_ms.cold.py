"""The planner's symbolic pass (``spgemm.symbolic`` spans), ms a call."""


def read(rec):
    spans = [s for s in rec.get("spans", []) if s["name"] == "spgemm.symbolic"]
    if not spans or not rec["units"]:
        return None
    return sum(s["dur_us"] for s in spans) / 1e3 / len(rec["units"])
