"""The whole product's share of its roofline: each call's least time
(``roofline.product_least_s``) over its host-clock time, summed over the
traced window's calls, in %."""
from portbench import roofline


def read(rec):
    return roofline.product_pct(rec, sum(u["ms"] for u in rec["units"]) / 1e3)
