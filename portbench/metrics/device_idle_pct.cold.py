"""The profiled part's share of time with no kernel, copy or set on the
device, in %."""


def read(rec):
    prof = rec.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
