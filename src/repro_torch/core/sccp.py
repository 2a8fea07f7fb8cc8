"""SCCP — Structured Condensing Computation Paradigm (paper §III-A, Fig. 7/8),
mirroring ``src/repro/core/sccp.py``.

Every (A row-vector, B column-vector) slab pair is combined element-wise
along the shared axis, aligned by physical position:

    P[i, c, j]    = A.val[i, c] * B.val[c, j]
    row(P[i,c,j]) = A.idx[i, c]
    col(P[i,c,j]) = B.idx[c, j]

``sccp_multiply`` runs through the hand-written kernel
(``kernels/sccp_multiply.py``) on CUDA operands; the reference's main path
uses an XLA broadcast here and reaches its Pallas kernel only through
``kernels/ops.py``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import sccp_multiply as _sccp
from .formats import INVALID, EllCols, EllRows


def sccp_multiply(a: EllRows, b: EllCols) -> Tuple[torch.Tensor, torch.Tensor,
                                                   torch.Tensor]:
    """All slab-pair products: ``(val, row, col)`` each ``(k_a, n, k_b)``.
    Invalid lanes (either operand slot empty) carry row = col = -1, val = 0."""
    if a.n_cols != b.n_rows:
        raise ValueError(f"contraction mismatch: A has {a.n_cols} cols, B has "
                         f"{b.n_rows} rows")
    return _sccp.sccp_multiply(a.val, a.idx, b.val, b.idx)


def sccp_multiply_slab(a: EllRows, b: EllCols, i: int):
    """Products of A slab ``i`` against *all* B slabs: shapes ``(n, k_b)``
    (one iteration of the paper's Fig. 8)."""
    av = a.val[i]
    ai = a.idx[i]
    val = av[:, None] * b.val
    row = ai[:, None].expand(val.shape)
    col = b.idx
    ok = (row >= 0) & (col >= 0)
    return (torch.where(ok, val, 0), torch.where(ok, row, INVALID),
            torch.where(ok, col, INVALID))


def count_products_rows(a: EllRows, b: EllCols) -> torch.Tensor:
    """Per-output-row SCCP product counts: output row r receives
    Σ_{lanes of A with idx==r} nnzrow_B(c) products. int32."""
    b_row_nnz = b.valid_mask().sum(dim=1)                       # (n,)
    w = b_row_nnz[None, :].expand(a.idx.shape)
    rows = torch.where(a.idx >= 0, a.idx, a.n_rows).reshape(-1)
    per_row = torch.zeros(a.n_rows + 1, dtype=w.dtype, device=w.device)
    per_row.index_add_(0, rows, torch.where(a.idx >= 0, w, 0).reshape(-1))
    return per_row[: a.n_rows].to(torch.int32)


def count_products(a: EllRows, b: EllCols) -> torch.Tensor:
    """Number of *valid* scalar multiplies SCCP performs (the paper's NK²)."""
    return (a.valid_mask().sum(0) * b.valid_mask().sum(1)).sum().to(torch.int32)
