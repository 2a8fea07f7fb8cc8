"""End-to-end SPLIM SpGEMM: SCCP multiply → in-situ-search-style accumulate,
mirroring the cold single-device subset of ``src/repro/core/spgemm.py``.

  * ``spgemm_coo``       — C = A·B as sorted COO with the ``'sort'`` (default)
                           or ``'search'`` accumulation (the paper's own
                           Alg. 1 / Fig. 11, kernels/insitu_search.py);
                           ``out_cap='auto'`` sizes the output symbolically,
                           ``check=True`` raises on truncation.
  * ``spgemm_dense``     — C dense via the same structured multiply.
  * ``spgemm_streaming`` — loop over A slabs, scatter-accumulating dense C.
  * ``spgemm_coo_batched`` / ``spgemm_dense_batched`` — a loop over a
                           leading batch axis of both ELLPACK operands.
  * ``spmm_ell_dense`` / ``spmm_dense_ell`` — ELLPACK × dense.

Backends, options and phases that later slices port raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import torch

from .accumulate import accumulate, check_no_overflow, scatter_dense
from .formats import (INVALID, Coo, EllCols, EllRows, ell_cols_from_dense,
                      ell_rows_from_dense)
from .sccp import sccp_multiply, sccp_multiply_slab

KEY_SPACE = 2 ** 31 - 1     # packed int32 keys span n_rows·n_cols below this
BACKENDS = ("sort", "tiled", "bucket", "hash", "stream", "search")
_LATER = {
    "tiled": "ROADMAP queue 1 item 4 (remaining accumulators)",
    "bucket": "ROADMAP queue 1 item 4 (remaining accumulators)",
    "hash": "ROADMAP queue 1 item 4 (remaining accumulators)",
    "stream": "ROADMAP queue 1 item 5 (streaming engine)",
    "auto": "ROADMAP queue 1 item 3 (planner)",
    "plan": "ROADMAP queue 1 item 3 (planner)",
    "structure": "ROADMAP queue 1 item 3 (warm numeric phase)",
    "mesh": "ROADMAP queue 1 item 9 (distributed SpGEMM)",
    "stream_cap": "ROADMAP queue 1 item 5 (streaming engine)",
}


def _not_ported(what: str, key: str):
    raise NotImplementedError(f"{what} is not ported to repro_torch yet: "
                              f"{_LATER[key]}")


def _poison_overflow(coo: Coo, dropped: torch.Tensor) -> Coo:
    """Fold a backend's dropped-product count into the overflow contract:
    any drop pushes ``ngroups`` past ``cap`` so ``overflowed()`` flags it
    and ``check_no_overflow`` raises."""
    ng = coo.ngroups + torch.where(dropped > 0, coo.row.shape[-1] + 1, 0).to(
        coo.ngroups.dtype)
    return Coo(row=coo.row, col=coo.col, val=coo.val, shape=coo.shape,
               ngroups=ng)


def _coo_from_slots(key: torch.Tensor, sums: torch.Tensor, nnz: torch.Tensor,
                    *, out_cap: int, n_rows: int, n_cols: int) -> Coo:
    """Dress segment-summed slot values in the sorted-COO contract:
    coordinates from the sorted unique keys, pad slots (beyond the true
    nnz) row = col = -1 / val = 0, ``ngroups`` the exact group count."""
    ok = torch.arange(out_cap, dtype=torch.int32, device=key.device) < nnz
    row = torch.where(ok, (key // n_cols).to(torch.int32), INVALID)
    col = torch.where(ok, (key % n_cols).to(torch.int32), INVALID)
    val = torch.where(ok, sums, 0)
    return Coo(row=row, col=col, val=val, shape=(n_rows, n_cols),
               ngroups=nnz.to(torch.int32))


def accumulate_stream(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                      out_cap: int, n_rows: int, n_cols: int, *,
                      backend: str = "sort") -> Coo:
    """Run one accumulation backend over a raw product stream → sorted COO
    (the backend-dispatch half of ``spgemm_coo``)."""
    if backend == "sort":
        return accumulate(row, col, val, out_cap, n_rows, n_cols)
    if backend == "search":
        # Paper Alg. 1 / Fig. 11: emit the sorted unique keys, align every
        # product against them — values are never sorted. Truncation keeps
        # the first out_cap unique keys and flags via nnz > out_cap.
        from ..kernels import ops
        uk, sums, nnz = ops.search_merge(row, col, val, n_rows, n_cols,
                                         out_cap=out_cap)
        return _coo_from_slots(uk, sums, nnz, out_cap=out_cap,
                               n_rows=n_rows, n_cols=n_cols)
    if backend in _LATER:
        _not_ported(f"accumulator {backend!r}", backend)
    raise ValueError(f"unknown accumulator {backend!r}")


def spgemm_coo(a: EllRows, b: EllCols, out_cap="auto", *,
               accumulator: str | None = None, check: bool = False,
               plan=None) -> Coo:
    """Sorted-COO SpGEMM (paper Fig. 7-11 pipeline, single device).

    Prefer ``repro_torch.spgemm(a, b, ...)``. ``out_cap`` is the static
    output capacity, or ``'auto'`` to size it with the exact symbolic pass
    (``plan.symbolic.out_cap_auto``). ``accumulator`` is ``'sort'``
    (``None`` defaults to it) or ``'search'``; output spaces with
    ``n_rows·n_cols ≥ 2³¹−1`` reroute to ``'sort'``, whose two-key sort is
    the only lossless realization there. ``check=True`` raises
    ``AccumulatorOverflow`` on truncation.
    """
    if plan is not None:
        _not_ported("plan=", "plan")
    if accumulator == "auto":
        _not_ported("accumulator='auto'", "auto")
    accumulator = accumulator or "sort"
    if accumulator not in BACKENDS:
        raise ValueError(f"unknown accumulator {accumulator!r}")
    if a.n_rows * b.n_cols >= KEY_SPACE:
        accumulator = "sort"
    if accumulator in _LATER:
        _not_ported(f"accumulator {accumulator!r}", accumulator)
    if out_cap == "auto":
        from ..plan.symbolic import out_cap_auto
        out_cap = out_cap_auto(a, b, exact=True)
    val, row, col = sccp_multiply(a, b)
    coo = accumulate_stream(row, col, val, out_cap, a.n_rows, b.n_cols,
                            backend=accumulator)
    if check:
        coo = check_no_overflow(coo)
    return coo


def spgemm_dense(a: EllRows, b: EllCols) -> torch.Tensor:
    """Dense-output SpGEMM via the same structured multiply."""
    val, row, col = sccp_multiply(a, b)
    return scatter_dense(row, col, val, a.n_rows, b.n_cols)


def spgemm_streaming(a: EllRows, b: EllCols) -> torch.Tensor:
    """Loop over A slabs (one Fig.-8 iteration per step) accumulating dense
    C, so each step materializes only one (n, k_b) slab intermediate."""
    c = torch.zeros((a.n_rows, b.n_cols), dtype=a.val.dtype,
                    device=a.val.device)
    for i in range(a.k):
        val, row, col = sccp_multiply_slab(a, b, i)
        c = c + scatter_dense(row, col, val, a.n_rows, b.n_cols)
    return c


def _slices(a: EllRows, b: EllCols):
    for i in range(a.val.shape[0]):
        yield (EllRows(val=a.val[i], idx=a.idx[i], n_rows=a.n_rows),
               EllCols(val=b.val[i], idx=b.idx[i], n_cols=b.n_cols))


def spgemm_coo_batched(a: EllRows, b: EllCols, out_cap="auto", *,
                       accumulator: str | None = None, check: bool = False,
                       plan=None) -> Coo:
    """Batched C[i] = A[i]·B[i] over a leading batch axis of the ELLPACK
    planes (shared n_rows/n_cols/k/caps). Every leaf of the result,
    ``ngroups`` included, has the batch as its leading axis. Needs a
    concrete ``out_cap`` and backend; ``check`` runs once on the batch."""
    if plan is not None:
        _not_ported("plan=", "plan")
    if accumulator == "auto" or out_cap == "auto":
        raise ValueError("batched spgemm needs a concrete out_cap/backend: "
                         "size one with plan.symbolic.out_cap_auto on a "
                         "representative slice")
    coos = [spgemm_coo(ai, bi, out_cap, accumulator=accumulator)
            for ai, bi in _slices(a, b)]
    coo = Coo(row=torch.stack([c.row for c in coos]),
              col=torch.stack([c.col for c in coos]),
              val=torch.stack([c.val for c in coos]),
              shape=(a.n_rows, b.n_cols),
              ngroups=torch.stack([c.ngroups for c in coos]))
    if check:
        coo = check_no_overflow(coo)
    return coo


def spgemm_dense_batched(a: EllRows, b: EllCols) -> torch.Tensor:
    """Batched dense-output SpGEMM over a leading batch axis."""
    return torch.stack([spgemm_dense(ai, bi) for ai, bi in _slices(a, b)])


def spgemm_from_dense(a_dense, b_dense, k_a: int, k_b: int, out_cap: int, *,
                      device=None) -> Coo:
    """Convenience: dense inputs → ELLPACK on ``device`` → SpGEMM → COO."""
    a = ell_rows_from_dense(a_dense, k_a, device=device)
    b = ell_cols_from_dense(b_dense, k_b, device=device)
    return spgemm_coo(a, b, out_cap)


def spmm_ell_dense(a: EllRows, x: torch.Tensor) -> torch.Tensor:
    """C = A @ X with A in row-wise ELLPACK and X dense (n, d): each lane
    A.val[s, c]·X[c, :] scatter-adds into output row A.idx[s, c]."""
    d = x.shape[-1]
    rows = torch.where(a.idx >= 0, a.idx, a.n_rows).reshape(-1)
    contrib = (a.val[:, :, None] * x[None, :, :]).reshape(-1, d)
    out = torch.zeros((a.n_rows + 1, d), dtype=contrib.dtype, device=x.device)
    out.index_add_(0, rows, contrib)
    return out[: a.n_rows]


def spmm_dense_ell(x: torch.Tensor, b: EllCols) -> torch.Tensor:
    """C = X @ B with X dense (d, n) and B in column-wise ELLPACK."""
    d = x.shape[0]
    cols = torch.where(b.idx >= 0, b.idx, b.n_cols).reshape(-1)
    contrib = (x[:, :, None] * b.val[None, :, :]).reshape(d, -1)
    out = torch.zeros((b.n_cols + 1, d), dtype=contrib.dtype, device=x.device)
    out.index_add_(0, cols, contrib.T)
    return out[: b.n_cols].T
