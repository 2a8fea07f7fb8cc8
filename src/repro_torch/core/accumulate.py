"""Unstructured accumulation, the ``'sort'`` realization of the in-situ
search's contract (paper §III-B), mirroring ``src/repro/core/accumulate.py``.

A lexicographic (row, col) sort of the product stream followed by a
segmented sum gives the sorted, duplicate-free COO stream. The reference
computes this with XLA ops and no Pallas kernel, so the port uses library
ops: one ``torch.sort`` of an int64 key that orders (row, col)
lexicographically for any int32 coordinates, ``index_add_`` for the
segment-sum and ``scatter_reduce_('amin')`` for the segment-min.
"""
from __future__ import annotations

import numpy as np
import torch

from .formats import INVALID, Coo


def sort_by_coords(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                   n_rows: int):
    """Lexicographic (row, col) sort; invalid entries sink to the tail."""
    row = row.reshape(-1)
    col = col.reshape(-1)
    val = val.reshape(-1)
    park = row < 0
    row_s = torch.where(park, n_rows, row).to(torch.int64)   # sentinel last
    col_s = torch.where(park, 0, col).to(torch.int64)
    # row in the high 32 bits, col shifted to unsigned in the low 32 bits
    key = (row_s << 32) | (col_s + 2 ** 31)
    key, order = torch.sort(key)
    row_s = (key >> 32).to(torch.int32)
    col_s = ((key & 0xFFFFFFFF) - 2 ** 31).to(torch.int32)
    val_s = val[order]
    dead = row_s >= n_rows
    return (torch.where(dead, INVALID, row_s),
            torch.where(dead, INVALID, col_s),
            torch.where(dead, 0, val_s))


class AccumulatorOverflow(ValueError):
    """The true unique-coordinate count exceeded the static ``out_cap``."""


def merge_sorted(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                 out_cap: int, n_rows: int, n_cols: int) -> Coo:
    """Coalesce a coordinate-sorted stream: sum runs of equal (row, col)
    into at most ``out_cap`` slots. The returned ``Coo`` carries
    ``ngroups``, the TRUE group count, so truncation is detectable."""
    s = row.shape[0]
    valid = row >= 0
    new_grp = (row != torch.roll(row, 1)) | (col != torch.roll(col, 1))
    new_grp[0] = True
    new_grp &= valid
    seg = torch.cumsum(new_grp, 0, dtype=torch.int32) - 1   # group id
    seg = torch.where(valid, seg, out_cap).clamp_(0, out_cap)  # park, truncate
    sums = torch.zeros(out_cap + 1, dtype=val.dtype, device=val.device)
    sums.index_add_(0, seg, val)
    # representative coordinates per group = first element of each run
    idx = torch.arange(s, device=row.device)
    first = torch.where(new_grp, idx, s - 1)
    first_idx = torch.full((out_cap + 1,), s - 1, dtype=torch.int64,
                           device=row.device)
    first_idx.scatter_reduce_(0, seg.long(), first, "amin")
    first_idx = first_idx[:out_cap]
    ngroups = new_grp.sum(dtype=torch.int32)
    slot_ok = torch.arange(out_cap, device=row.device) < ngroups
    out_row = torch.where(slot_ok, row[first_idx], INVALID).to(torch.int32)
    out_col = torch.where(slot_ok, col[first_idx], INVALID).to(torch.int32)
    out_val = torch.where(slot_ok, sums[:out_cap], 0)
    return Coo(row=out_row, col=out_col, val=out_val, shape=(n_rows, n_cols),
               ngroups=ngroups)


def accumulate(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
               out_cap: int, n_rows: int, n_cols: int) -> Coo:
    """sort + merge: the full in-situ-search-equivalent accumulation."""
    r, c, v = sort_by_coords(row, col, val, n_rows)
    return merge_sorted(r, c, v, out_cap, n_rows, n_cols)


def check_no_overflow(coo: Coo) -> Coo:
    """Raise ``AccumulatorOverflow`` if the producer dropped groups beyond
    ``cap`` (host sync on ``ngroups``). Accepts batched ``Coo`` (leading
    axis on ``ngroups``): raises if ANY batch entry overflowed."""
    if coo.ngroups is None:
        return coo
    ngroups = np.asarray(coo.ngroups.cpu())
    cap = coo.row.shape[-1]
    worst = int(ngroups.max())
    if worst > cap:
        n_bad = int((ngroups > cap).sum()) if ngroups.ndim else 1
        where = ("" if ngroups.ndim == 0 else
                 f" in {n_bad} batch entr{'y' if n_bad == 1 else 'ies'}")
        # exactly one event per offending call (not per batch entry)
        from ..obs import metrics as _obs_metrics
        from ..obs import trace as _obs
        _obs_metrics.inc("spgemm.overflow_events")
        _obs.instant("spgemm.overflow", worst=worst, cap=cap, n_bad=n_bad)
        raise AccumulatorOverflow(
            f"accumulation produced up to {worst} unique coordinates but "
            f"out_cap={cap}{where}; {worst - cap} group(s) were dropped — "
            f"resize out_cap (e.g. from plan.symbolic.out_cap_auto)")
    return coo


def accumulate_checked(row: torch.Tensor, col: torch.Tensor,
                       val: torch.Tensor, out_cap: int, n_rows: int,
                       n_cols: int) -> Coo:
    """``accumulate`` + host-side overflow check (raises on truncation)."""
    return check_no_overflow(accumulate(row, col, val, out_cap, n_rows, n_cols))


def scatter_dense(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                  n_rows: int, n_cols: int) -> torch.Tensor:
    """Decompression-style accumulation into a dense C (the baseline the
    paper argues against; kept as the oracle)."""
    r = row.reshape(-1)
    ok = r >= 0
    r = torch.where(ok, r, n_rows).long()
    c = torch.where(col.reshape(-1) >= 0, col.reshape(-1), 0).long()
    dense = torch.zeros((n_rows + 1, n_cols), dtype=val.dtype,
                        device=val.device)
    dense.index_put_((r, c), torch.where(ok, val.reshape(-1), 0),
                     accumulate=True)
    return dense[:n_rows]
