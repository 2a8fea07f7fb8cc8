"""The Table I matrices of the SPLIM paper, regenerated from their published
statistics.

A frozen copy of the generator of ``benchmarks/common.py`` (``TABLE1``,
``_draw_row_counts``, ``build_scipy``): SuiteSparse cannot be fetched
offline, so each matrix is a random pattern with the paper's dimension,
non-zero count and spread of non-zeros a row, and each row's columns drawn
uniformly. That is not the real matrix: its banded and block structure is
gone, so X·Xᵀ barely compresses (about 1.05 to 1.2 products a non-zero of
C, where the real matrices' products compress far more). The row counts
come from the seed ``count_seed`` and the column positions from
``place_seed``; both are part of a configuration, so one configuration is
one fixed pattern. Kept here, and not imported, so that a change to the
program's repository can never move the yardstick.
"""
from __future__ import annotations

import numpy as np

# (id, name, dim, nnz, nnz_av, sigma) -- the paper's Table I
TABLE1 = (
    (1, "pdb1HYS", 36_000, 4_300_000, 119.3, 31.86),
    (2, "rma10", 47_000, 2_300_000, 49.7, 27.78),
    (3, "bcsstk32", 45_000, 2_000_000, 45.2, 15.48),
    (4, "ct20stif", 52_000, 2_600_000, 49.7, 16.98),
    (5, "cant", 62_000, 4_000_000, 64.2, 14.06),
    (6, "crankseg_2", 64_000, 14_000_000, 222.0, 95.88),
    (7, "lhr71", 70_000, 1_500_000, 21.3, 26.32),
    (8, "consph", 83_000, 6_000_000, 72.1, 19.08),
    (9, "soc-sign-epinions", 132_000, 841_000, 6.4, 32.95),
    (10, "shipsec1", 141_000, 3_600_000, 25.3, 11.07),
    (11, "xenon2", 157_000, 3_900_000, 24.6, 4.07),
    (12, "ohne2", 181_000, 6_900_000, 37.9, 21.09),
    (13, "pwtk", 218_000, 11_500_000, 52.9, 4.74),
    (14, "stanford", 282_000, 2_300_000, 8.2, 166.33),
    (15, "cage14", 1_500_000, 27_100_000, 18.0, 5.37),
    (16, "webbase-1M", 1_000_000, 3_100_000, 3.1, 25.35),
)


def row_counts(dim: int, nnz: int, sigma: float, seed: int) -> np.ndarray:
    """Non-zeros a row: normal around nnz/dim with spread ``sigma``, then
    adjusted by single steps at random rows to total ``nnz``."""
    rng = np.random.default_rng(seed)
    counts = rng.normal(nnz / dim, sigma, size=dim)
    counts = np.clip(np.round(counts), 0, dim).astype(np.int64)
    diff = nnz - counts.sum()
    idx = rng.integers(0, dim, size=abs(int(diff)))
    np.add.at(counts, idx, 1 if diff > 0 else -1)
    return np.clip(counts, 0, dim)


def pattern(dim: int, nnz: int, sigma: float, count_seed: int,
            place_seed: int):
    """CSR pattern ``(indptr int64, indices int32)`` of a ``dim`` x ``dim``
    matrix: each row's columns drawn without replacement, in the order the
    draw gives them (not sorted)."""
    counts = row_counts(dim, nnz, sigma, count_seed)
    rng = np.random.default_rng(place_seed)
    indptr = np.zeros(dim + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = np.empty(indptr[-1], np.int32)
    for r in range(dim):
        lo, hi = indptr[r], indptr[r + 1]
        k = hi - lo
        if k:
            indices[lo:hi] = rng.choice(dim, size=k, replace=False) \
                if k < dim // 4 else rng.permutation(dim)[:k]
    return indptr, indices


def table1_row(name: str):
    """The Table I row of matrix ``name``."""
    for row in TABLE1:
        if row[1] == name:
            return row
    raise KeyError(f"{name!r} is not a matrix of Table I")
