"""The whole product's share of its roofline: the served requests' least
time (``roofline.product_least_s``) over the flushes' host-clock time, in
%."""
from portbench import roofline


def read(rec):
    return roofline.product_pct(rec, sum(rec["flush_ms"]) / 1e3)
