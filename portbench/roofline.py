"""Roofline arithmetic: the least time the chip could take for what a
product's inputs need, against the published peaks (``peaks.json``).

Bytes count each input non-zero read once and each output non-zero written
once; operations count 2 a valid scalar product. Nothing counts padded
ELLPACK lanes, so the shares read the same whatever implements the product.
"""
from __future__ import annotations

from typing import Optional


def least_s(n_bytes: float, n_ops: float, peaks: dict) -> float:
    return max(n_bytes / peaks["hbm_bytes_per_s"],
               n_ops / peaks["fp32_flop_per_s"])


def unit_stats(rec: dict, unit: dict) -> Optional[dict]:
    s = rec.get("product_stats", {}).get(unit["pattern"])
    return s if s and s.get("nnz_c") is not None else None


def product_least_s(s: dict, peaks: dict) -> float:
    """C = A·B: A's and B's non-zeros read once (8 B each: a value and an
    index), C's written once (12 B: row, column, value); 2 a product."""
    return least_s(8 * (s["nnz_a"] + s["nnz_b"]) + 12 * s["nnz_c"],
                   2 * s["products"], peaks)


def product_pct(rec: dict, measured_s: float) -> Optional[float]:
    """The window's products' least time over ``measured_s``, in %."""
    stats = [unit_stats(rec, u) for u in rec["units"]]
    if not stats or None in stats or measured_s <= 0:
        return None
    return 100.0 * sum(product_least_s(s, rec["peaks"])
                       for s in stats) / measured_s


def kernels_pct(rec: dict) -> Optional[float]:
    """Σ least time of the kernel wrappers that each profiled call or
    request launched itself (its ``launched``), over the device time of
    the program's kernels in the profiled part, in %."""
    prof = rec.get("profile")
    if not prof or prof["port_kernel_s"] <= 0 or not prof["units"]:
        return None
    least = 0.0
    for unit in prof["units"]:
        s = unit_stats(rec, unit)
        if s is None:
            return None
        for wrapper in sorted(unit["launched"]):
            if wrapper in rec["counts"]:
                least += least_s(*rec["counts"][wrapper](s), rec["peaks"])
    return 100.0 * least / prof["port_kernel_s"]
