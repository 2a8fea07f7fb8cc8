"""The operands a cell hands to the program, made from its configuration
and ``--seed``.

A configuration is one Table I matrix X (its pattern fixed by the
generator's seeds in the configuration's file) and the rows of C it keeps:
C = X[:c_rows] · Xᵀ. The seed draws X's integer values in [-4, 4] \\ {0}
(a pool of value sets, one for each request that needs fresh values), the
entries each serving pattern drops, and the cold calls' relabellings.
Everything is drawn on the device, in a few large calls; only the pattern
comes from the host generator.

The program's inputs are ELLPACK planes: A = X[:c_rows] as ``EllRows``
(its columns, each a slot list of rows) and B = Xᵀ as ``EllCols`` (its
rows, the same columns of X). Every pattern is padded to the full matrix's
slot counts, so all requests of a cell have one shape.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from portbench.reference import generator


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose (``tag``) of run seed ``seed``."""
    words = [seed % 2 ** 32, (seed // 2 ** 32) % 2 ** 32,
             *tag.encode()]
    hi, lo = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def device_generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


@dataclasses.dataclass
class Matrix:
    """X's pattern as entries sorted by (column, row), on the device."""
    dim: int
    c_rows: int
    row: torch.Tensor       # (nnz,) int64, sorted within each column
    col: torch.Tensor       # (nnz,) int64, ascending
    csr_pos: torch.Tensor   # (nnz,) int64: each entry's place in X's CSR
    slot: torch.Tensor      # (nnz,) int64: rank within its column
    k_a: int                # A's slots: most rows < c_rows in a column
    k_b: int                # B's slots: most entries in a column

    @property
    def nnz(self) -> int:
        return self.row.numel()


def load_matrix(cfg: dict, device) -> Matrix:
    """X of configuration ``cfg`` (its ``matrix``, ``dim``, ``nnz``,
    ``sigma``, ``count_seed``, ``place_seed`` and ``c_rows``)."""
    indptr, indices = generator.pattern(
        cfg["dim"], cfg["nnz"], cfg["sigma"], cfg["count_seed"],
        cfg["place_seed"])
    return matrix_from_csr(indptr, indices, cfg["dim"], cfg["c_rows"],
                           device)


def matrix_from_csr(indptr: np.ndarray, indices: np.ndarray, dim: int,
                    c_rows: int, device) -> Matrix:
    counts = torch.from_numpy(np.diff(indptr)).to(device)
    row = torch.repeat_interleave(torch.arange(dim, device=device), counts)
    col = torch.from_numpy(indices.astype(np.int64)).to(device)
    order = torch.argsort(col * dim + row)
    row, col = row[order], col[order]
    per_col = torch.bincount(col, minlength=dim)
    start = torch.cumsum(per_col, 0) - per_col
    slot = torch.arange(col.numel(), device=device) - start[col]
    top = torch.bincount(col[row < c_rows], minlength=dim)
    return Matrix(dim=dim, c_rows=c_rows, row=row, col=col, csr_pos=order,
                  slot=slot, k_a=max(1, int(top.max())),
                  k_b=max(1, int(per_col.max())))


def draw_values(m: Matrix, n_sets: int, seed: int) -> torch.Tensor:
    """``n_sets`` value sets, (n_sets, nnz) float32, in X's CSR order:
    integers in [-4, 4] \\ {0}, every one as likely."""
    g = device_generator(seed, "values", m.row.device)
    mag = torch.randint(1, 5, (n_sets, m.nnz), generator=g,
                        device=m.row.device)
    sign = torch.randint(0, 2, (n_sets, m.nnz), generator=g,
                         device=m.row.device) * 2 - 1
    return (mag * sign).to(torch.float32)


def draw_keeps(m: Matrix, drops: List[float], seed: int) -> torch.Tensor:
    """(len(drops), nnz) bool in X's CSR order: pattern i lacks
    round(drops[i] · nnz) entries, chosen from the seed."""
    g = device_generator(seed, "drops", m.row.device)
    keep = torch.ones((len(drops), m.nnz), dtype=torch.bool,
                      device=m.row.device)
    for i, d in enumerate(drops):
        n_drop = int(round(d * m.nnz))
        if n_drop:
            gone = torch.randperm(m.nnz, generator=g,
                                  device=m.row.device)[:n_drop]
            keep[i, gone] = False
    return keep


@dataclasses.dataclass
class Planes:
    """One pattern's ELLPACK planes, with a value plane per value set."""
    a_idx: torch.Tensor     # (k_a, dim) int32
    a_val: torch.Tensor     # (n_sets, k_a, dim) float32
    b_idx: torch.Tensor     # (dim, k_b) int32
    b_val: torch.Tensor     # (n_sets, dim, k_b) float32
    products: int           # valid scalar products of A·B


def planes(m: Matrix, values: torch.Tensor,
           keep: Optional[torch.Tensor] = None) -> Planes:
    """The planes of X (its entries where ``keep``, in CSR order) with
    value sets ``values`` (n_sets, nnz in CSR order). Dropped entries leave
    their slots empty (index -1, value 0); the slots of the others stay as
    in the full matrix."""
    dev = m.row.device
    ok = torch.ones(m.nnz, dtype=torch.bool, device=dev) if keep is None \
        else keep[m.csr_pos]
    vals = values[:, m.csr_pos] * ok
    n_sets = values.shape[0]
    b_idx = torch.full((m.dim, m.k_b), -1, dtype=torch.int32, device=dev)
    b_idx[m.col, m.slot] = torch.where(ok, m.row, -1).to(torch.int32)
    b_val = torch.zeros((n_sets, m.dim, m.k_b), dtype=torch.float32,
                        device=dev)
    b_val[:, m.col, m.slot] = vals
    top = m.row < m.c_rows
    a_idx = torch.full((m.k_a, m.dim), -1, dtype=torch.int32, device=dev)
    a_idx[m.slot[top], m.col[top]] = torch.where(
        ok[top], m.row[top], -1).to(torch.int32)
    a_val = torch.zeros((n_sets, m.k_a, m.dim), dtype=torch.float32,
                        device=dev)
    a_val[:, m.slot[top], m.col[top]] = vals[:, top]
    products = int(((a_idx >= 0).sum(0).long()
                    * (b_idx >= 0).sum(1).long()).sum())
    return Planes(a_idx=a_idx, a_val=a_val, b_idx=b_idx, b_val=b_val,
                  products=products)


def relabel(idx: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """An index plane with every valid index i replaced by perm[i]."""
    return torch.where(idx >= 0, perm[idx.clamp(min=0).long()],
                       -1).to(torch.int32)
