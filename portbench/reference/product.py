"""The plain reference of the benchmark's product: C = X[:c_rows] · Xᵀ.

Plain PyTorch, on whatever device its inputs are on; it imports nothing of
the program. It starts from X's entries as the benchmark made them (row,
column and value of each, in CSR order), and works out for itself which
entries a pattern keeps, every scalar product, and each coordinate's sum.
A relabelling puts C's row r at ``p[r]`` and its column j at ``q[j]``.

The output is made in blocks of C's rows, each one sorted list of unique
coordinates with their sums, so that no block needs more than
``max_products`` products at once. ``dtype`` is the precision of the
products and of the sums: float64 for the reference (exact on the
benchmark's integer values), bfloat16 for the control.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch


class Block(NamedTuple):
    row_lo: int             # the block holds C's rows [row_lo, row_hi)
    row_hi: int
    key: torch.Tensor       # (u,) int64 sorted unique row · n_cols + col
    val: torch.Tensor       # (u,) sums in the product's dtype


def product(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor, *,
            dim: int, c_rows: int, keep: Optional[torch.Tensor] = None,
            p: Optional[torch.Tensor] = None,
            q: Optional[torch.Tensor] = None, dtype=torch.float64,
            max_products: int = 1 << 26) -> Iterator[Block]:
    """Blocks of C = X[:c_rows] · Xᵀ (relabelled by ``p``, ``q``) over
    X's entries ``row``, ``col``, ``val`` where ``keep``."""
    row, col = row.long(), col.long()
    if keep is not None:
        row, col, val = row[keep], col[keep], val[keep]
    order = torch.argsort(col, stable=True)
    s_row, s_val = row[order], val[order].to(dtype)
    per_col = torch.bincount(col, minlength=dim)
    start = torch.cumsum(per_col, 0) - per_col
    left = (row < c_rows).nonzero().squeeze(1)
    out_row = row[left] if p is None else p.long()[row[left]]
    by_row = torch.argsort(out_row, stable=True)
    left, out_row = left[by_row], out_row[by_row]
    n_prod = per_col[col[left]]
    cum = torch.cumsum(n_prod, 0).cpu().numpy()
    rows_np = out_row.cpu().numpy()
    i0, total = 0, len(cum)
    while i0 < total:
        base = cum[i0 - 1] if i0 else 0
        i1 = int(np.searchsorted(cum, base + max_products, side="right"))
        i1 = max(i1, i0 + 1)
        if i1 < total:                  # end the block on a row boundary
            cut = int(np.searchsorted(rows_np, rows_np[i1], side="left"))
            i1 = cut if cut > i0 else int(np.searchsorted(
                rows_np, rows_np[i1], side="right"))
        lo = int(rows_np[i0]) if i0 else 0
        hi = int(rows_np[i1]) if i1 < total else c_rows
        yield _block(left[i0:i1], out_row[i0:i1], n_prod[i0:i1], row, col,
                     val, s_row, s_val, start, q, dim, dtype, lo, hi)
        i0 = i1


def _block(left, out_row, n_prod, row, col, val, s_row, s_val, start, q,
           dim, dtype, lo, hi) -> Block:
    dev = row.device
    rep = torch.repeat_interleave(
        torch.arange(left.numel(), device=dev), n_prod)
    first = torch.cumsum(n_prod, 0) - n_prod
    partner = start[col[left]][rep] + (
        torch.arange(rep.numel(), device=dev) - first[rep])
    j = s_row[partner]
    out_col = j if q is None else q.long()[j]
    key = out_row[rep] * dim + out_col
    prod = val[left].to(dtype)[rep] * s_val[partner]
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    sums = torch.zeros(uniq.numel(), dtype=dtype, device=dev)
    sums.index_add_(0, inv, prod)
    return Block(lo, hi, uniq, sums)
