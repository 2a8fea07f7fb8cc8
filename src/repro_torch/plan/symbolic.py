"""Symbolic phase: size nnz(C) before the numeric SpGEMM, mirroring the
``out_cap`` subset of ``src/repro/plan/symbolic.py``.

  * ``product_count``   — Σ_c nnzcol_A(c)·nnzrow_B(c), the exact number of
    scalar products SCCP performs.
  * ``upper_bound_nnz`` — row-flop counting, clipped to the row width.
  * ``exact_nnz``       — the exact unique-coordinate count from a
    coordinate-only sort (no value multiply, no value sort).

``out_cap_auto`` turns either into a Python int, rounded up to a multiple
of ``LANE`` and at least ``LANE`` — with ``exact=True`` the same cap the
reference planner gives a pinned backend. ``per_row_counts`` and
``max_slab_products`` are the planner's histogram inputs
(``plan.planner.make_plan``); ``per_shard_products``, ``per_grid_products``
and ``per_block_nnz`` those of the distributed planner
(``plan.planner.make_dist_plan``).
"""
from __future__ import annotations

import torch

from ..core.formats import EllCols, EllRows
from ..core.sccp import count_products, count_products_rows

LANE = 128


def product_count(a: EllRows, b: EllCols) -> torch.Tensor:
    """Exact count of valid SCCP products."""
    return count_products(a, b)


def product_count_rows(a: EllRows, b: EllCols) -> torch.Tensor:
    """Per-output-row SCCP product counts."""
    return count_products_rows(a, b)


def upper_bound_nnz(a: EllRows, b: EllCols) -> torch.Tensor:
    """Upper bound on nnz(C): per-row flops clipped to the row width."""
    return torch.clamp(product_count_rows(a, b),
                       max=b.n_cols).sum().to(torch.int32)


def sorted_coords(a_idx: torch.Tensor, b_idx: torch.Tensor, n_rows: int):
    """The coordinate-only pass: every SCCP product's (row, col) as an int64
    key ``row << 32 | (col + 2³¹)``, sorted (one sort of the broadcast
    coordinate planes, no values; invalid lanes parked last at row
    ``n_rows``), with the mask of the valid run heads (C's unique
    coordinates) and each lane's row."""
    shape = (a_idx.shape[0], a_idx.shape[1], b_idx.shape[1])
    row = a_idx[:, :, None].expand(shape).reshape(-1)
    col = b_idx[None, :, :].expand(shape).reshape(-1)
    ok = (row >= 0) & (col >= 0)
    row_s = torch.where(ok, row, n_rows).to(torch.int64)    # park invalid last
    col_s = torch.where(ok, col, 0).to(torch.int64)
    key = torch.sort((row_s << 32) | (col_s + 2 ** 31)).values
    head = key != torch.roll(key, 1)
    head[0] = True
    row_s = key >> 32
    head &= row_s < n_rows
    return key, head, row_s


def row_counts(head: torch.Tensor, row: torch.Tensor,
               n_rows: int) -> torch.Tensor:
    """Per-row count of the ``head`` lanes (int32, rows ≥ n_rows dropped)."""
    counts = torch.zeros(n_rows + 1, dtype=torch.int32, device=head.device)
    counts.index_add_(0, row.clamp(max=n_rows), head.to(torch.int32))
    return counts[:n_rows]


def exact_nnz_rows(a: EllRows, b: EllCols) -> torch.Tensor:
    """Per-row exact unique-coordinate counts of C (coordinate-only pass):
    one sort of the broadcast coordinate planes, run heads counted per row."""
    _, head, row = sorted_coords(a.idx, b.idx, a.n_rows)
    return row_counts(head, row, a.n_rows)


def exact_nnz(a: EllRows, b: EllCols) -> torch.Tensor:
    """Exact nnz(C): coordinate-only symbolic pass (one sort, no values)."""
    return exact_nnz_rows(a, b).sum().to(torch.int32)


def per_slab_products(a: EllRows, b: EllCols) -> torch.Tensor:
    """Per-A-slab SCCP product counts: ``out[i] = Σ_c valid(a.idx[i, c]) ·
    nnzrow_B(c)``."""
    b_row_nnz = b.valid_mask().sum(dim=1)                       # (n,)
    w = torch.where(a.idx >= 0, b_row_nnz[None, :], 0)          # (k_a, n)
    return w.sum(dim=1).to(torch.int32)


def max_slab_products(a: EllRows, b: EllCols) -> torch.Tensor:
    """Largest single-slab product count: the streaming engine's per-tile
    compaction bound (``Plan.stream_cap``)."""
    return per_slab_products(a, b).max()


def per_shard_products(a: EllRows, b: EllCols, n_shards: int) -> torch.Tensor:
    """Exact product counts per contiguous A-slab shard: ``k_a`` padded up to
    a multiple of ``n_shards`` (padding slabs hold no products, as the
    distributed engine's slab padding), slab counts summed a shard."""
    per_slab = per_slab_products(a, b)
    pad = (-per_slab.shape[0]) % n_shards
    if pad:
        per_slab = torch.cat([per_slab, per_slab.new_zeros(pad)])
    return per_slab.reshape(n_shards, -1).sum(dim=1).to(torch.int32)


def per_grid_products(a: EllRows, b: EllCols, pr: int,
                      pc: int) -> torch.Tensor:
    """Exact product counts per cell of the ``pr × pc`` grid of the 2-D
    ``'summa'`` schedule, ``(pr, pc)``: cell ``(r, c)`` multiplies A
    shard-blocks ``[r·pc, (r+1)·pc)`` by B shard-blocks ``{r'·pc + c}``.
    Both slab axes are padded to a multiple of ``p = pr·pc`` as the engine
    pads them. ``per_grid_products(a, b, p, 1)[:, 0]`` is
    ``per_shard_products(a, b, p)``."""
    p = pr * pc
    a_valid = (a.idx >= 0).to(torch.int64)                     # (k_a, n)
    b_valid = b.valid_mask().to(torch.int64)                   # (n, k_b)
    pad_a = (-a_valid.shape[0]) % p
    if pad_a:
        a_valid = torch.cat([a_valid, a_valid.new_zeros(pad_a,
                                                        a_valid.shape[1])])
    pad_b = (-b_valid.shape[1]) % p
    if pad_b:
        b_valid = torch.cat([b_valid, b_valid.new_zeros(b_valid.shape[0],
                                                        pad_b)], dim=1)
    n = a_valid.shape[1]
    blk_a = a_valid.reshape(p, -1, n).sum(dim=1)               # (p, n)
    blk_b = b_valid.reshape(n, p, -1).sum(dim=2).T             # (p, n)
    # an exact integer product on the host: CUDA has no int64 matmul
    g = blk_a.cpu() @ blk_b.cpu().T                            # (p, p)
    return (g.reshape(pr, pc, pr, pc).sum(dim=(1, 2)).to(torch.int32)
            .to(a.idx.device))


def per_block_nnz(a: EllRows, b: EllCols, n_blocks: int, *,
                  exact: bool = True) -> torch.Tensor:
    """Unique-coordinate counts of C per block of ``ceil(n_rows/n_blocks)``
    contiguous rows (the C-stationary ownership partition). ``exact=False``
    puts the clipped row-flop bound in their place, which dominates them."""
    per_row = (exact_nnz_rows(a, b) if exact
               else torch.clamp(product_count_rows(a, b),
                                max=b.n_cols).to(torch.int32))
    rpb = -(-a.n_rows // n_blocks)
    pad = n_blocks * rpb - a.n_rows
    if pad:
        per_row = torch.cat([per_row, per_row.new_zeros(pad)])
    return per_row.reshape(n_blocks, rpb).sum(dim=1).to(torch.int32)


def per_row_counts(a: EllRows, b: EllCols, *, exact: bool = True):
    """(products_per_row, unique_per_row), the planner's histogram inputs.
    ``exact=False`` puts the clipped row-flop bound in place of the unique
    counts; sizes from it stay safe, as the bound dominates them."""
    prod = product_count_rows(a, b)
    uniq = (exact_nnz_rows(a, b) if exact
            else torch.clamp(prod, max=b.n_cols).to(torch.int32))
    return prod, uniq


def out_cap_auto(a: EllRows, b: EllCols, *, exact: bool = True,
                 slack: float = 1.0) -> int:
    """Host-side ``out_cap`` from concrete operands: ``exact=True`` runs the
    coordinate-only sort pass (tight), ``False`` the row-flop bound. Always
    a multiple of LANE and at least LANE."""
    nnz = int(exact_nnz(a, b) if exact else upper_bound_nnz(a, b))
    want = int(-(-int(nnz * slack) // LANE)) * LANE
    return max(LANE, want)
