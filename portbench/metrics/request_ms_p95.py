"""The 95th percentile, over every request due in the window that
returned, of the ms from when it fell due to when its result was on the
device."""
import numpy as np


def read(rec):
    lat = rec.get("latency_ms")
    return float(np.percentile(lat, 95)) if lat else None
