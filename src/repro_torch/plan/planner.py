"""Accumulation planning for a pinned backend: the sizing half of
``src/repro/plan/planner.py``.

``make_plan(a, b, backend=...)`` runs the symbolic phase (``symbolic``) on
concrete operands and derives every size a backend needs from *exact*
histograms: ``out_cap`` from the unique count, the ``'bucket'`` bins and the
``'hash'`` tables from per-row-range product and unique counts (so the
planned bucket and hash paths never drop a product), and the streaming
engine's per-tile sizes. It returns a frozen ``Plan`` of Python ints stamped
with the operands' fingerprint; every int field, and ``fp``, equals the
reference planner's for the same operands and backend, so one package's
plan is accepted by the other.

Choosing the backend (``backend=None``, behind ``accumulator='auto'``) is not
ported: its cost constants were set for the TPU.

``plan_spmm_format`` routes a pruned weight to its SpMM storage format (N:M
condensed planes or ELLPACK), the weights-side twin of the backend choice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.formats import EllCols, EllRows
from ..kernels.bitonic_merge import next_pot as _pot
from . import symbolic
from .structure import fingerprint

BACKENDS = ("sort", "tiled", "bucket", "hash", "stream", "search")

# Off the TPU a streaming scan step's tile should be large enough to amortize
# its fixed cost: stream_group targets this many lanes a tile, while the
# streamed intermediate stays at least STREAM_INTERM_MARGIN x under the
# materialized stream.
STREAM_TILE_TARGET = 32768
STREAM_INTERM_MARGIN = 4.0

# The intermediate bytes above which the reference's backend selection
# overrides its choice with 'stream'; with a pinned backend it is unread.
DEFAULT_MEM_BUDGET = 1 << 30


@dataclasses.dataclass(frozen=True)
class Plan:
    """A fully static accumulation plan.

    ``fp`` is the operands' sparsity fingerprint (``plan.structure``);
    ``spgemm_coo(plan=)`` checks it against the operands it is given and
    raises on a mismatch. ``dataclasses.replace(plan, fp=None)`` opts a plan
    out of that check for deliberate reuse across similar patterns. Leaving
    a blocking size None resolves to the ops layer's default: ONE
    stream-sized bucket or table.
    """

    backend: str                      # one of BACKENDS
    out_cap: int
    tile: int = 4096                  # 'tiled' merge-tree tile
    stream_cap: Optional[int] = None  # 'stream' per-tile compaction width
    stream_group: int = 1             # 'stream' A slabs per scan step
    n_buckets: Optional[int] = None   # 'bucket' row-range partitions
    bucket_cap: Optional[int] = None  # per-bucket slots (pow2)
    n_blocks: Optional[int] = None    # 'hash' row-range partitions
    block_cap: Optional[int] = None   # per-block table slots (pow2)
    max_probes: Optional[int] = None  # None = full probe cycle
    fp: Optional[str] = None          # operand sparsity fingerprint


def _stream_interm_bytes(tile_lanes: int, stream_cap: int) -> float:
    """The streaming engine's peak intermediate: the packed (key + value,
    8 B a lane) sorted tile plus the compacted ``stream_cap`` lanes."""
    return 8.0 * (_pot(tile_lanes) + stream_cap)


def make_plan(a: EllRows, b: EllCols, *, out_cap: Optional[int] = None,
              backend: Optional[str] = None, exact: bool = True,
              tile: int = 4096, slack: float = 1.0,
              mem_budget: int = DEFAULT_MEM_BUDGET) -> Plan:
    """Symbolic phase and blocking sizes for a pinned ``backend``.

    ``out_cap`` pins the output capacity; otherwise it is the exact unique
    count times ``slack``, rounded up to a multiple of ``symbolic.LANE``.
    ``exact=False`` (or a pinned ``out_cap`` with a backend other than
    ``'hash'``) replaces the unique counts by the clipped row-flop bound,
    which keeps every size safe. ``mem_budget`` feeds only the backend
    selection, so with a pinned backend it is ignored, as in the reference.
    """
    if backend is None:
        raise NotImplementedError(
            "backend selection (make_plan(backend=None), accumulator='auto') "
            "is not ported to repro_torch yet: ROADMAP queue 1 item 3 "
            "(planner)")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    n_rows, n_cols, n = a.n_rows, b.n_cols, a.n_cols
    if n_rows * n_cols >= 2 ** 31 - 1 and backend != "sort":
        raise ValueError(
            f"backend {backend!r} needs packed int32 coordinate keys but the "
            f"output space is {n_rows}x{n_cols}; only 'sort' (unpacked "
            "two-key path) spans it")
    stream = a.k * n * b.k
    stream_pot = _pot(stream)
    slab_lanes = n * b.k

    # symbolic phase: the exact unique pass only where tight uniques are used
    exact = exact and (out_cap is None or backend == "hash")
    products_per_row, unique_per_row = symbolic.per_row_counts(a, b,
                                                               exact=exact)
    products_per_row = products_per_row.cpu().numpy()
    unique_per_row = unique_per_row.cpu().numpy()
    nnz_c = int(unique_per_row.sum())
    if out_cap is None:
        cap = -(-int(max(1, nnz_c) * slack) // symbolic.LANE) * symbolic.LANE
        out_cap = max(symbolic.LANE, cap)

    # blocking sizes from exact histograms (the never-drop guarantee)
    n_buckets = min(64, max(2, _pot(stream_pot // 4096)))
    n_blocks = n_buckets
    rpb = -(-n_rows // n_buckets)
    pad = n_buckets * rpb - n_rows
    prod_hist = np.pad(products_per_row, (0, pad)).reshape(
        n_buckets, rpb).sum(axis=1)
    uniq_hist = np.pad(unique_per_row, (0, pad)).reshape(
        n_blocks, rpb).sum(axis=1)
    bucket_cap = min(stream_pot, max(128, _pot(int(prod_hist.max()))))
    block_cap = min(stream_pot, max(128, _pot(2 * int(uniq_hist.max()))))

    # streaming sizes: a group tile's uniques never exceed its products, so
    # group x the largest slab count never drops; the group is the largest
    # that reaches STREAM_TILE_TARGET lanes within the memory margin
    max_slab = int(symbolic.max_slab_products(a, b))

    def _scap(g: int) -> int:
        return min(_pot(g * slab_lanes), max(128, _pot(g * max_slab)))

    group = max(1, min(a.k, STREAM_TILE_TARGET // max(1, slab_lanes)))
    while group > 1 and (STREAM_INTERM_MARGIN
                         * _stream_interm_bytes(group * slab_lanes,
                                                _scap(group))
                         > 12.0 * stream):
        group -= 1

    return Plan(backend=backend, out_cap=int(out_cap), tile=tile,
                stream_cap=_scap(group), stream_group=group,
                n_buckets=n_buckets, bucket_cap=bucket_cap,
                n_blocks=n_blocks, block_cap=block_cap, max_probes=None,
                fp=fingerprint(a, b))


def plan_spmm_format(w, candidates=None):
    """Route a pruned dense ``(d_in, d_out)`` weight to its SpMM format:
    ``("nm", (n, m))`` when some candidate N:M window balances every
    column's reduction windows (the ``kernels/nm_spmm.py`` route),
    ``("ellpack", None)`` otherwise (``spmm_dense_ell``, any pattern at
    worst-row slab width). Results are bit-identical either way;
    ``models.sparse.SparseLinear`` consumes the decision."""
    from ..core.nm import NM_CANDIDATES, detect_nm
    shape = detect_nm(w, NM_CANDIDATES if candidates is None else candidates)
    if shape is not None:
        return ("nm", shape)
    return ("ellpack", None)
