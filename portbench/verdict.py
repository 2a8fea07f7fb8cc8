"""How ``correct`` is decided: the program's sampled results against the
plain reference, number by number, each beside its limit.

The values are integers and every partial sum stays far below 2²⁴, so a
float32 result is exact whatever the order of its sums: the comparison is
exact, and every limit is 0. The control (the reference in bfloat16, the
precision below the configuration's float32) reads ``val_err`` 1 or more,
since C's diagonal sums pass 256; ``PERF.md`` gives the readings.

Numbers compared (each summed or maxed over the sampled results):

  coord_mismatch  C's coordinates, slot by slot in the program's order,
                  that are not the reference's sorted unique coordinates
  val_err         the largest |program − reference| at matching coordinates
  ngroups_gap     |ngroups − nnz(C)| + |valid slots − nnz(C)|
  missing         requests due in the window that never returned, and
                  calls that raised
"""
from __future__ import annotations

from typing import Dict, Iterable

import torch

from portbench.reference.product import Block

LIMITS = {"coord_mismatch": 0, "val_err": 0.0, "ngroups_gap": 0,
          "missing": 0}


def compare(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
            ngroups, blocks: Iterable[Block], n_cols: int) -> Dict[str, float]:
    """One result (a sorted COO: ``row``, ``col``, ``val``, ``ngroups``)
    against the reference's blocks of the same product."""
    ok = row >= 0
    p_row = row[ok].long()
    p_key = p_row * n_cols + col[ok].long()
    p_val = val[ok].double()
    mismatch, err, ref_nnz = 0, 0.0, 0
    for b in blocks:
        sel = (p_row >= b.row_lo) & (p_row < b.row_hi)
        key, v = p_key[sel], p_val[sel]
        n = min(key.numel(), b.key.numel())
        same = key[:n] == b.key[:n]
        mismatch += int((~same).sum()) + abs(key.numel() - b.key.numel())
        if n:
            gap = (v[:n] - b.val[:n].double()).abs()[same]
            if gap.numel():
                err = max(err, float(gap.max()))
        ref_nnz += b.key.numel()
    n_valid = int(ok.sum())
    return {"coord_mismatch": mismatch, "val_err": err,
            "ngroups_gap": abs(int(ngroups) - ref_nnz) + abs(n_valid
                                                             - ref_nnz)}


def merge(readings: Iterable[Dict[str, float]], missing: int) -> Dict:
    """The cell's numbers: mismatches and gaps summed, the error maxed."""
    out = {"coord_mismatch": 0, "val_err": 0.0, "ngroups_gap": 0,
           "missing": missing}
    for r in readings:
        out["coord_mismatch"] += r["coord_mismatch"]
        out["ngroups_gap"] += r["ngroups_gap"]
        out["val_err"] = max(out["val_err"], r["val_err"])
    return out


def judge(numbers: Dict[str, float], n_checked: int) -> bool:
    """Correct: at least one result checked and no number past its limit."""
    return n_checked > 0 and all(numbers[k] <= LIMITS[k] for k in LIMITS)


def lines(numbers: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each number beside its limit, for the result line and stderr."""
    return {k: {"value": numbers[k], "limit": LIMITS[k]} for k in LIMITS}
