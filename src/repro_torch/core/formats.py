"""Sparse-matrix storage formats (paper §II-A, Fig. 2) as frozen dataclasses
of torch tensors, mirroring ``src/repro/core/formats.py``.

Empty ELLPACK slots carry index ``-1``; empty COO slots carry
row = col = -1 and val = 0. Every index tensor is int32, as in the
reference, so the packed-key arithmetic and its sentinels behave the same.

  * ``EllRows`` — row-wise ELLPACK of the left matrix A: ``val[s, c]`` is
    the s-th non-zero of column ``c``, ``idx[s, c]`` its row. (k, n).
  * ``EllCols`` — column-wise ELLPACK of the right matrix B: ``val[r, s]``
    is the s-th non-zero of row ``r``, ``idx[r, s]`` its column. (n, k).

Constructors that make tensors take ``device=``, which defaults to
``default_device()`` (CUDA, or an error); compute follows the operands.
``from_numpy`` / ``to_numpy`` carry operands and results across from and
to numpy, so the reference and the port compute on the same inputs;
``nm_from_numpy`` carries an N:M weight's planes and ``params_from_numpy``
a nested parameter dict (the reference's MoE and FFN layouts).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .nm import NmWeights

INVALID = -1


def default_device() -> torch.device:
    """The port's device: CUDA. Raises where there is none; CPU runs must
    ask for ``device="cpu"`` themselves."""
    if not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on a CUDA device and none is "
                           "available; pass device='cpu' to run the plain "
                           "torch versions on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


@dataclasses.dataclass(frozen=True)
class EllRows:
    """Row-wise ELLPACK (left operand). val/idx: (k, n)."""

    val: torch.Tensor  # (k, n) float
    idx: torch.Tensor  # (k, n) int32, original row coord, -1 = empty
    n_rows: int

    @property
    def k(self) -> int:
        return self.val.shape[-2]

    @property
    def n_cols(self) -> int:
        return self.val.shape[-1]

    def valid_mask(self) -> torch.Tensor:
        return self.idx >= 0

    def to_dense(self) -> torch.Tensor:
        """Scatter back to (n_rows, n_cols). Oracle/debug only."""
        k, n = self.val.shape
        rows = torch.where(self.idx >= 0, self.idx, self.n_rows)
        cols = torch.arange(n, device=self.val.device).expand(k, n)
        dense = torch.zeros((self.n_rows + 1, n), dtype=self.val.dtype,
                            device=self.val.device)
        dense.index_put_((rows.reshape(-1).long(), cols.reshape(-1)),
                         torch.where(self.idx >= 0, self.val, 0).reshape(-1),
                         accumulate=True)
        return dense[: self.n_rows]


@dataclasses.dataclass(frozen=True)
class EllCols:
    """Column-wise ELLPACK (right operand). val/idx: (n, k)."""

    val: torch.Tensor  # (n, k) float
    idx: torch.Tensor  # (n, k) int32, original column coord, -1 = empty
    n_cols: int

    @property
    def k(self) -> int:
        return self.val.shape[-1]

    @property
    def n_rows(self) -> int:
        return self.val.shape[-2]

    def valid_mask(self) -> torch.Tensor:
        return self.idx >= 0

    def to_dense(self) -> torch.Tensor:
        n, k = self.val.shape
        cols = torch.where(self.idx >= 0, self.idx, self.n_cols)
        rows = torch.arange(n, device=self.val.device)[:, None].expand(n, k)
        dense = torch.zeros((n, self.n_cols + 1), dtype=self.val.dtype,
                            device=self.val.device)
        dense.index_put_((rows.reshape(-1), cols.reshape(-1).long()),
                         torch.where(self.idx >= 0, self.val, 0).reshape(-1),
                         accumulate=True)
        return dense[:, : self.n_cols]


@dataclasses.dataclass(frozen=True)
class Coo:
    """Padded COO. Invalid (padding) entries have row = col = -1.

    ``ngroups`` is the TRUE number of unique coordinates the producer saw;
    it may exceed ``cap``, in which case the stored stream was truncated and
    ``overflowed()`` flags the loss. ``None`` means the producer didn't
    count.
    """

    row: torch.Tensor  # (cap,) int32
    col: torch.Tensor  # (cap,) int32
    val: torch.Tensor  # (cap,) float
    shape: Tuple[int, int]
    ngroups: Optional[torch.Tensor] = None  # () int32

    @property
    def cap(self) -> int:
        return self.row.shape[-1]

    def valid_mask(self) -> torch.Tensor:
        return self.row >= 0

    def nnz(self) -> torch.Tensor:
        return self.valid_mask().sum()

    def overflowed(self) -> torch.Tensor:
        """Did the producer drop groups beyond ``cap``? Per-batch for a
        batched ``Coo``."""
        if self.ngroups is None:
            return torch.zeros((), dtype=torch.bool, device=self.row.device)
        return self.ngroups > self.row.shape[-1]

    def to_dense(self) -> torch.Tensor:
        m, n = self.shape
        r = torch.where(self.row >= 0, self.row, m).long()
        c = torch.where(self.col >= 0, self.col, 0).long()
        dense = torch.zeros((m + 1, n), dtype=self.val.dtype,
                            device=self.val.device)
        dense.index_put_((r, c), torch.where(self.row >= 0, self.val, 0),
                         accumulate=True)
        return dense[:m]


# ---------------------------------------------------------------------------
# Dense -> format converters
# ---------------------------------------------------------------------------

def _slots(a: torch.Tensor, k: int, by_col: bool):
    """The non-zeros of dense ``a`` that fill a width-``k`` ELLPACK:
    ``(line, pos, slot)``, each one's column and row when ``by_col`` (its
    row and column otherwise) and its place in that line, the line's first
    ``k`` in ascending order of ``pos``. Only the non-zeros' coordinates
    are formed, never an index per entry of ``a``, so a dense operand of
    ~2³¹ entries converts in the memory of its non-zeros."""
    nz = torch.nonzero(a)                    # row-major (row, col) pairs
    line, pos = nz[:, 1 if by_col else 0], nz[:, 0 if by_col else 1]
    if by_col:                               # stable: rows stay ascending
        order = torch.sort(line, stable=True).indices
        line, pos = line[order], pos[order]
    counts = torch.bincount(line, minlength=a.shape[1 if by_col else 0])
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(line.numel(), device=a.device) - start[line]
    keep = slot < k
    return line[keep], pos[keep], slot[keep]


def ell_rows_from_dense(a, k: int, *, device=None) -> EllRows:
    """Row-wise ELLPACK (condense each *column* upward) of left matrix A.
    Entries beyond slot ``k`` in a column are dropped."""
    a = torch.as_tensor(a, device=resolve_device(device))
    m, n = a.shape
    col, row, slot = _slots(a, k, by_col=True)
    val = torch.zeros((k, n), dtype=a.dtype, device=a.device)
    idx = torch.full((k, n), INVALID, dtype=torch.int32, device=a.device)
    val[slot, col] = a[row, col]
    idx[slot, col] = row.to(torch.int32)
    return EllRows(val=val, idx=idx, n_rows=m)


def ell_cols_from_dense(b, k: int, *, device=None) -> EllCols:
    """Column-wise ELLPACK (condense each *row* leftward) of right matrix B."""
    b = torch.as_tensor(b, device=resolve_device(device))
    m, n = b.shape
    row, col, slot = _slots(b, k, by_col=False)
    val = torch.zeros((m, k), dtype=b.dtype, device=b.device)
    idx = torch.full((m, k), INVALID, dtype=torch.int32, device=b.device)
    val[row, slot] = b[row, col]
    idx[row, slot] = col.to(torch.int32)
    return EllCols(val=val, idx=idx, n_cols=n)


def coo_from_dense(a, cap: int, *, device=None) -> Coo:
    """Dense -> padded COO (row-major order) with static cap."""
    a = torch.as_tensor(a, device=resolve_device(device))
    m, n = a.shape
    nz = torch.nonzero(a)                    # row-major (row, col) pairs
    r, c = nz[:cap, 0], nz[:cap, 1]
    row = torch.full((cap,), INVALID, dtype=torch.int32, device=a.device)
    col = torch.full((cap,), INVALID, dtype=torch.int32, device=a.device)
    val = torch.zeros((cap,), dtype=a.dtype, device=a.device)
    row[:r.numel()] = r.to(torch.int32)
    col[:c.numel()] = c.to(torch.int32)
    val[:r.numel()] = a[r, c]
    return Coo(row=row, col=col, val=val, shape=(m, n),
               ngroups=torch.tensor(nz.shape[0], dtype=torch.int32,
                                    device=a.device))


# ---------------------------------------------------------------------------
# Host-side (numpy / scipy) constructors and the numpy carry-over
# ---------------------------------------------------------------------------

def np_ell_rows_from_scipy(a_csc, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """scipy CSC -> row-wise ELLPACK planes (numpy)."""
    a_csc = a_csc.tocsc()
    m, n = a_csc.shape
    val = np.zeros((k, n), dtype=np.float32)
    idx = np.full((k, n), INVALID, dtype=np.int32)
    indptr, indices, data = a_csc.indptr, a_csc.indices, a_csc.data
    for c in range(n):
        lo, hi = indptr[c], min(indptr[c + 1], indptr[c] + k)
        cnt = hi - lo
        val[:cnt, c] = data[lo:hi]
        idx[:cnt, c] = indices[lo:hi]
    return val, idx


def np_ell_cols_from_scipy(b_csr, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """scipy CSR -> column-wise ELLPACK planes (numpy)."""
    b_csr = b_csr.tocsr()
    m, n = b_csr.shape
    val = np.zeros((m, k), dtype=np.float32)
    idx = np.full((m, k), INVALID, dtype=np.int32)
    indptr, indices, data = b_csr.indptr, b_csr.indices, b_csr.data
    for r in range(m):
        lo, hi = indptr[r], min(indptr[r + 1], indptr[r] + k)
        cnt = hi - lo
        val[r, :cnt] = data[lo:hi]
        idx[r, :cnt] = indices[lo:hi]
    return val, idx


def from_numpy(val, idx, *, n_rows: Optional[int] = None,
               n_cols: Optional[int] = None, device=None):
    """ELLPACK planes from numpy (or anything ``np.asarray`` takes, such as
    the reference's arrays) on ``device``: an ``EllRows`` when ``n_rows``
    is given, an ``EllCols`` when ``n_cols`` is. Indices become int32."""
    if (n_rows is None) == (n_cols is None):
        raise ValueError("from_numpy: give exactly one of n_rows (EllRows) "
                         "or n_cols (EllCols)")
    dev = resolve_device(device)
    v = torch.from_numpy(np.array(val)).to(dev)                # owned copy
    i = torch.from_numpy(np.array(idx, dtype=np.int32)).to(dev)
    if n_rows is not None:
        return EllRows(val=v, idx=i, n_rows=int(n_rows))
    return EllCols(val=v, idx=i, n_cols=int(n_cols))


def as_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays on its device unless ``device`` is
    given; anything else (numpy, the reference's arrays) goes to
    ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(torch.device(device))
    return torch.from_numpy(np.array(x)).to(resolve_device(device))


def nm_from_numpy(val, off, *, n: int, m: int, d_in: int, device=None):
    """A ``core.nm.NmWeights`` from the reference's condensed planes (val
    float, off int8) on ``device``."""
    dev = resolve_device(device)
    return NmWeights(val=torch.from_numpy(np.array(val)).to(dev),
                     off=torch.from_numpy(np.array(off, dtype=np.int8))
                     .to(dev), n=int(n), m=int(m), d_in=int(d_in))


def params_from_numpy(params, *, device=None, dtype=None):
    """The reference's parameter tree (nested dicts and lists of arrays, as
    numpy, or JAX arrays, e.g. ``repro.models.Model.init``'s) as the same
    tree of tensors on ``device``, cast to ``dtype`` when one is given.
    bfloat16 arrays (``ml_dtypes.bfloat16``, which ``torch.from_numpy``
    does not take) pass through float32, which holds every bfloat16 value,
    and stay bfloat16 unless ``dtype`` says otherwise."""
    dev = resolve_device(device)
    if isinstance(params, dict):
        return {k: params_from_numpy(v, device=dev, dtype=dtype)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_from_numpy(v, device=dev, dtype=dtype)
                            for v in params)
    a = np.array(params)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return (t if dtype is None else t.to(dtype)).to(dev)


def to_numpy(coo: Coo):
    """A ``Coo`` as numpy ``(row, col, val, ngroups)``; ``ngroups`` is None
    when the producer did not count."""
    ng = None if coo.ngroups is None else coo.ngroups.cpu().numpy()
    return (coo.row.cpu().numpy(), coo.col.cpu().numpy(),
            coo.val.cpu().numpy(), ng)
