"""The 95th percentile of a cold call's ms, on the host clock around the
call ending in a device synchronise, over the traced window's calls."""
import numpy as np


def read(rec):
    ms = [u["ms"] for u in rec["units"]]
    return float(np.percentile(ms, 95)) if ms else None
