"""Hybrid ELLPACK + COO format (paper §III-C, Fig. 12), mirroring
``src/repro/core/hybrid.py``.

Rows/columns whose non-zero count exceeds ``NNZ-a + σ`` (mean + one stddev)
would inflate the ELLPACK width ``k`` for everyone; their overflow beyond the
threshold is diverted to a COO side structure. ELL-PEs process the condensed
part with SCCP (K1, through ``core.spgemm.spgemm_dense``); COO-PEs process
the remainder against the *densified* other operand, the paper's COO-PE
dataflow (§IV-B).

``HybridRows`` / ``HybridCols`` are frozen dataclasses of ``(ell, coo)``,
not pytrees. The split functions take ``device=`` like the converters they
build on (``None`` is CUDA, or an error). ``hybrid_from_numpy`` carries the
reference's split across as numpy planes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .formats import (Coo, EllCols, EllRows, coo_from_dense,
                      ell_cols_from_dense, ell_rows_from_dense, from_numpy,
                      resolve_device)
from .spgemm import spgemm_dense

# ``_coo_matmul_dense`` gathers at most this many bytes of the other
# operand's rows (or columns) at a time: at bcsstk32's width the whole
# (coo_cap, n_out) block would be 9.7 GiB, and its products as much again.
_CHUNK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class HybridRows:
    """Row-wise hybrid for the left matrix: ELLPACK trunk + COO overflow."""

    ell: EllRows
    coo: Coo

    def to_dense(self) -> torch.Tensor:
        return self.ell.to_dense().add_(self.coo.to_dense())


@dataclasses.dataclass(frozen=True)
class HybridCols:
    """Column-wise hybrid for the right matrix: ELLPACK trunk + COO
    overflow."""

    ell: EllCols
    coo: Coo

    def to_dense(self) -> torch.Tensor:
        return self.ell.to_dense().add_(self.coo.to_dense())


def ell_width_rule(nnz_per_lane: np.ndarray) -> int:
    """Paper's boundary: k = ceil(mean + std) of per-lane non-zero counts."""
    nnz_av = float(np.mean(nnz_per_lane))
    sigma = float(np.std(nnz_per_lane))
    return max(1, int(np.ceil(nnz_av + sigma)))


def _split(x, k: int, coo_cap: int, device, to_ell, cls):
    """``x``'s width-``k`` ELLPACK trunk and, as COO, its overflow ``x −
    trunk``, which is written over the trunk's dense copy (one dense
    temporary, not two)."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    ell = to_ell(x, k, device=dev)
    trunk = ell.to_dense()
    overflow = torch.sub(x, trunk, out=trunk)
    return cls(ell=ell, coo=coo_from_dense(overflow, coo_cap, device=dev))


def split_rows_hybrid(a, k: int, coo_cap: int, *, device=None) -> HybridRows:
    """Left matrix: first k non-zeros of each *column* into ELLPACK, rest
    COO."""
    return _split(a, k, coo_cap, device, ell_rows_from_dense, HybridRows)


def split_cols_hybrid(b, k: int, coo_cap: int, *, device=None) -> HybridCols:
    """Right matrix: first k non-zeros of each *row* into ELLPACK, rest
    COO."""
    return _split(b, k, coo_cap, device, ell_cols_from_dense, HybridCols)


def _coo_matmul_dense(coo: Coo, other_dense: torch.Tensor, left: bool, *,
                      chunk: int | None = None) -> torch.Tensor:
    """COO-PE path: partial products of a COO operand against the densified
    other operand (paper Fig. 5 procedure). left=True → coo is the A part.

    The COO entries go in chunks of ``chunk`` (by default as many as
    ``_CHUNK_BYTES`` of gathered rows or columns hold), each chunk's products
    added in place into the output: the reference's sum, in another float
    summation order (integer operands stay exact)."""
    m, n = coo.shape
    ok = coo.valid_mask()
    dtype = torch.result_type(coo.val, other_dense)
    if left:
        # C[r, :] += v * B[c, :]
        out = torch.zeros((m + 1, other_dense.shape[1]), dtype=dtype,
                          device=other_dense.device)
        line = other_dense.shape[1]
    else:
        # C[:, c] += A[:, r] * v
        out = torch.zeros((other_dense.shape[0], n + 1), dtype=dtype,
                          device=other_dense.device)
        line = other_dense.shape[0]
    step = chunk or max(1, _CHUNK_BYTES // max(1, line * out.element_size()))
    for lo in range(0, coo.cap, step):
        sl = slice(lo, lo + step)
        okc = ok[sl]
        if left:
            gathered = other_dense.index_select(
                0, torch.where(okc, coo.col[sl], 0)).to(dtype)  # (c, n_out)
            gathered.mul_(coo.val[sl, None]).masked_fill_(~okc[:, None], 0)
            out.index_add_(0, torch.where(okc, coo.row[sl], m), gathered)
        else:
            gathered = other_dense.index_select(
                1, torch.where(okc, coo.row[sl], 0)).to(dtype)  # (n_out, c)
            gathered.mul_(coo.val[None, sl]).masked_fill_(~okc[None, :], 0)
            out.index_add_(1, torch.where(okc, coo.col[sl], n), gathered)
    return out[:m] if left else out[:, :n]


def hybrid_spgemm_dense(a: HybridRows, b: HybridCols) -> torch.Tensor:
    """Full hybrid SpGEMM (dense output): ELL×ELL via SCCP + the COO-PE
    terms. Each dense temporary is freed before the next is made."""
    c = spgemm_dense(a.ell, b.ell)                      # ELL-PEs (SCCP)
    # COO_A × (all of B), then ELL_A × COO_B
    c += _coo_matmul_dense(a.coo, b.to_dense(), left=True)
    c += _coo_matmul_dense(b.coo, a.ell.to_dense(), left=False)
    return c


def hybrid_from_numpy(ell_val, ell_idx, coo_row, coo_col, coo_val,
                      coo_ngroups=None, *, n_rows: int | None = None,
                      n_cols: int | None = None, device=None):
    """A hybrid operand from numpy (or anything ``np.asarray`` takes, such
    as the reference's split): its ELLPACK planes and its COO's row, col,
    val and ngroups, on ``device``. A ``HybridRows`` when ``n_rows`` is
    given, a ``HybridCols`` when ``n_cols`` is."""
    ell = from_numpy(ell_val, ell_idx, n_rows=n_rows, n_cols=n_cols,
                     device=device)
    dev = ell.val.device
    shape = (ell.n_rows, ell.n_cols)

    def arr(x, dtype=None):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(dev)

    coo = Coo(row=arr(coo_row, np.int32), col=arr(coo_col, np.int32),
              val=arr(coo_val), shape=shape,
              ngroups=None if coo_ngroups is None
              else arr(coo_ngroups, np.int32))
    return (HybridRows if n_rows is not None else HybridCols)(ell=ell,
                                                              coo=coo)
