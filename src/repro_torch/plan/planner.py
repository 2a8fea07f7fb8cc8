"""Workload-adaptive accumulation planning, mirroring the single-device half
of ``src/repro/plan/planner.py``.

SPLIM splits SpGEMM into a *structured* multiply (SCCP, one dataflow) and an
*unstructured* accumulation, where one size does not fit all. This module
sizes the accumulation and, with ``backend=None`` (behind
``accumulator='auto'``), chooses one of the six backends:

  sort    — one int64 key sort + segmented sum (core/accumulate)
  tiled   — the row sort and merge tree (K5, K6)
  bucket  — propagation blocking: bin by row range (K7), sort each bin (K5)
  hash    — per-row-block open-addressing tables, sorted (K5)
  stream  — slab-group multiply → sort → compact → merge (K8, K6), the only
            backend that never materializes the (k_a, n, k_b) stream
  search  — the paper's in-situ search: emit the sorted unique keys (K2),
            align every product against them (K3), sum by slot

``make_plan`` runs the symbolic phase (``symbolic``) on concrete operands and
derives every size a backend needs from *exact* histograms: ``out_cap`` from
the unique count, the ``'bucket'`` bins and ``'hash'`` tables from per-row-
range product and unique counts (so the planned bucket and hash paths never
drop a product), and the streaming engine's per-tile sizes. Every int field,
and ``fp``, equals the reference planner's for the same operands and
backend, so one package's plan is accepted by the other.

Selection scores the backends with the reference's operation-count cost
forms, fed by ``hwmodel.MatrixStats`` (``stats_from_ell``), in units kept
per device (``CostTable``, chosen by the operands' device): on the CPU the
reference's off-TPU constants and its interpreter penalty, so the CPU plan
equals the reference's in every field; on CUDA one unit a backend and a
fixed term a call, fitted to the times the H100 measures (PERF.md §5;
``chip_smoke.py`` prints the fit). The model is memory-aware: every
backend's modeled intermediate bytes go into ``Plan.est`` (``interm_*``), and
when the winner's exceeds ``mem_budget`` the planner overrides it with
``'stream'``, whose intermediate does not grow with ``k_a``. Output spaces of
2³¹−1 coordinates or more go to ``'sort'``, the only unpacked-key backend.

``make_dist_plan`` extends a plan across a mesh axis: the distributed
schedule (``'ring'``, ``'cstat'`` or ``'summa'``, by modeled bytes) and the
exchange's capacities, as a ``DistPlan``.

``plan_spmm_format`` routes a pruned weight to its SpMM storage format (N:M
condensed planes or ELLPACK), the weights-side twin of the backend choice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional

import numpy as np

from ..core.formats import EllCols, EllRows
from ..core.hwmodel import MatrixStats, splim_latency, stats_from_ell
from ..kernels.bitonic_merge import next_pot as _pot
from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs
from . import symbolic
from .structure import _digest, _index_planes

BACKENDS = ("sort", "tiled", "bucket", "hash", "stream", "search")

# The reference's cost-model units (relative vector-op units per element).
XLA_SORT_C = 1.0        # a library sort, per element per log2 level
CE_C = 1.0              # one compare-exchange step
BIN_C = 2.0             # binning scan + scatter, per element
PROBE_C = 3.0           # one probe round: 2 gathers + 1 scatter-min
SEGSUM_C = 1.0          # segment sum per element
INTERPRET_PENALTY = 50.0   # the reference's Pallas interpret mode off the TPU
SORT_TRAFFIC = 1.5      # 'sort' moves 12 B a lane with a two-key comparator
STREAM_SORT_C = 0.5     # the streaming tile sort's packed single key
SEARCH_SORT_C = 0.4     # 'search' sorts keys only (4 B a lane)
ALIGN_C = 0.5           # one alignment level against the unique keys
SCAN_STEP_C = 16384.0   # fixed floor of one streaming step

# Off the TPU a streaming scan step's tile should be large enough to amortize
# its fixed cost: stream_group targets this many lanes a tile, while the
# streamed intermediate stays at least STREAM_INTERM_MARGIN x under the
# materialized stream.
STREAM_TILE_TARGET = 32768
STREAM_INTERM_MARGIN = 4.0

# The intermediate-bytes budget past which selection forces 'stream', for
# operands on the CPU: the reference's default.
DEFAULT_MEM_BUDGET = 1 << 30
# On CUDA the default budget is this share of the card's memory. The model's
# intermediate bytes are a floor of what a call holds: on the H100 a planned
# call's measured peak is 1.25-6.44x its backend's modeled bytes (6.44 for
# 'sort', whose int64 keys and sort scratch the model leaves out; 'stream',
# the override's choice, is the smallest peak; PERF.md §5), so an eighth of
# the card keeps a chosen backend's peak under 81% of it.
CUDA_MEM_SHARE = 0.125


@dataclasses.dataclass(frozen=True)
class CostTable:
    """The units of the cost model on one kind of device.

    A backend's cost is ``unit[b] * form_b + fixed[b]``, where ``form_b`` is
    the reference's operation count with every Pallas term multiplied by
    ``pallas_penalty``. Only the order of the costs matters to selection."""

    pallas_penalty: float
    unit: Mapping[str, float]
    fixed: Mapping[str, float]


# The reference's off-TPU table: the CPU realizations are plain torch, the
# reference's are XLA and interpret-mode Pallas; the CPU plan equals the
# reference's in every field.
CPU_COSTS = CostTable(pallas_penalty=INTERPRET_PENALTY,
                      unit={b: 1.0 for b in BACKENDS},
                      fixed={b: 0.0 for b in BACKENDS})
# The forms alone, every backend a hand-written kernel (no penalty): what
# CUDA_COSTS is fitted on (``chip_smoke.py`` prints both).
FORMS = CostTable(pallas_penalty=1.0, unit={b: 1.0 for b in BACKENDS},
                  fixed={b: 0.0 for b in BACKENDS})
# µs a form unit and µs a call, fitted on an H100 80GB HBM3 at 700 W through
# the median planned calls (``spgemm(a, b, plan=p)``, the multiply included)
# of bcsstk32 A·Aᵀ and of A cut to its first 5,625 columns times its
# transpose, to 4 digits (``chip_smoke.py``'s ``[fit]`` line; PERF.md §5).
# Off those two points only the pick is checked, on ``matmul_sparse``'s
# activation operand (``chip_smoke.py``'s ``held_out_selection``); the
# magnitudes there are not.
CUDA_COSTS = CostTable(
    pallas_penalty=1.0,
    unit={"sort": 3.995e-5, "tiled": 9.070e-7, "bucket": 1.705e-6,
          "hash": 6.944e-6, "stream": 3.658e-7, "search": 5.889e-5},
    fixed={"sort": 3119.0, "tiled": 2567.0, "bucket": 2826.0,
           "hash": 32640.0, "stream": 39880.0, "search": 2505.0})


def cost_table(device) -> CostTable:
    """The cost table for operands on ``device`` (a ``torch.device``)."""
    return CUDA_COSTS if device.type == "cuda" else CPU_COSTS


def default_mem_budget(device) -> int:
    """``make_plan``'s ``mem_budget`` when none is given: the reference's
    1 GiB on the CPU, ``CUDA_MEM_SHARE`` of the card's memory on CUDA."""
    if device.type != "cuda":
        return DEFAULT_MEM_BUDGET
    import torch
    total = torch.cuda.get_device_properties(device).total_memory
    return int(total * CUDA_MEM_SHARE)


def _net_cost(n: int, length: int) -> float:
    """Compare-exchange count of a full bitonic sort of ``n`` elements in
    power-of-2 rows of ``length`` (all rows ride one network)."""
    lt = max(1, int(math.log2(max(2, length))))
    return n * lt * (lt + 1) / 2 * CE_C


@dataclasses.dataclass(frozen=True)
class Plan:
    """A fully static accumulation plan.

    ``fp`` is the operands' sparsity fingerprint (``plan.structure``);
    ``spgemm_coo(plan=)`` checks it against the operands it is given and
    raises on a mismatch. ``dataclasses.replace(plan, fp=None)`` opts a plan
    out of that check for deliberate reuse across similar patterns. Leaving
    a blocking size None resolves to the ops layer's default: ONE
    stream-sized bucket or table. ``stats`` and ``est`` (the selection's
    statistics, modeled costs and bytes) are advisory and excluded from
    equality and hashing.
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
    stats: Optional[MatrixStats] = dataclasses.field(default=None,
                                                     compare=False)
    est: Dict[str, float] = dataclasses.field(default_factory=dict,
                                              compare=False)


def _backend_costs(s: MatrixStats, stream_pot: int, tile: int,
                   n_buckets: int, bucket_cap: int,
                   n_blocks: int, block_cap: int,
                   n_steps: int, tile_lanes: int, stream_cap: int,
                   buf_cap: int, table: CostTable) -> Dict[str, float]:
    """Each backend's modeled cost: the reference's forms (every backend
    pays the padded SCCP stream ``S``, then its own work per element) in
    ``table``'s units."""
    S = float(stream_pot)
    ls = max(1.0, math.log2(S))
    pal = table.pallas_penalty

    form = {"sort": SORT_TRAFFIC * XLA_SORT_C * S * ls}

    lt = math.log2(tile)
    tree_ce = S * (lt * (lt + 1) / 2 + sum(range(int(lt) + 1, int(ls) + 1)))
    form["tiled"] = pal * tree_ce * CE_C

    form["bucket"] = (pal * (BIN_C * S * (1 + n_buckets / 64)
                             + _net_cost(n_buckets * bucket_cap, bucket_cap)))

    load = min(0.95, s.nnz_c / max(1, n_blocks * block_cap))
    probes = 1.0 / max(0.05, 1.0 - load)
    form["hash"] = (PROBE_C * S * probes + SEGSUM_C * S
                    + pal * _net_cost(n_blocks * block_cap, block_cap))

    # n_steps sequential steps of (tile sort, merge with the 2·buf_cap
    # buffer pair) plus the fixed per-step floor; the tile sort is a
    # library-style sort of the packed keys (K8 on the card)
    t = float(_pot(tile_lanes))
    ltile = max(1.0, math.log2(max(2.0, t)))
    tile_sort = STREAM_SORT_C * XLA_SORT_C * t * ltile
    mrg = float(2 * buf_cap)
    merge = CE_C * mrg * (math.log2(mrg) + 1)
    form["stream"] = n_steps * (tile_sort + merge + SCAN_STEP_C)

    # key-only emission sort + per-product alignment against the nnz(C)
    # unique keys + one segment sum: the duplicate ratio S/nnz_C moves the
    # alignment term below a full re-sort
    lu = max(1.0, math.log2(max(2.0, float(s.nnz_c))))
    form["search"] = (SEARCH_SORT_C * XLA_SORT_C * S * ls
                      + ALIGN_C * S * lu + SEGSUM_C * S)
    return {b: table.unit[b] * form[b] + table.fixed[b] for b in BACKENDS}


def _stream_interm_bytes(tile_lanes: int, stream_cap: int) -> float:
    """The streaming engine's peak intermediate: the packed (key + value,
    8 B a lane) sorted tile plus the compacted ``stream_cap`` lanes."""
    return 8.0 * (_pot(tile_lanes) + stream_cap)


def _backend_interm_bytes(stream_lanes: int, stream_pot: int,
                          tile_lanes: int, stream_cap: int,
                          n_buckets: int, bucket_cap: int,
                          n_blocks: int, block_cap: int,
                          out_cap: int) -> Dict[str, float]:
    """Modeled peak *materialized intermediate* bytes per backend: the
    un-accumulated product lanes alive at once, not the output all backends
    share. Every materializing backend pays the 12 B a lane (val, row, col)
    SCCP stream; the packed-key ones add an 8 B a lane (key, val) copy,
    blocking adds its bins or tables; 'stream''s does not grow with k_a."""
    raw = 12.0 * stream_lanes
    packed = 8.0 * stream_pot
    return {
        "sort": raw,
        "tiled": raw + packed,
        "bucket": raw + packed + 8.0 * n_buckets * bucket_cap,
        "hash": raw + packed + 8.0 * n_blocks * block_cap,
        "stream": _stream_interm_bytes(tile_lanes, stream_cap),
        # the packed copy, the key-only sorted copy (4 B a lane), and the
        # unique keys and slot sums the alignment scatters into
        "search": raw + 12.0 * stream_pot + 8.0 * out_cap,
    }


def _select(costs: Dict[str, float], interm: Dict[str, float],
            mem_budget: int, n_rows: int, n_cols: int) -> str:
    """The cheapest backend; one whose intermediate exceeds ``mem_budget``
    loses to 'stream' where that holds less; spaces of 2³¹−1 coordinates
    or more take 'sort', the only unpacked-key backend."""
    chosen = min(costs, key=costs.get)
    if interm[chosen] > mem_budget and interm["stream"] < interm[chosen]:
        chosen = "stream"
    if n_rows * n_cols >= 2 ** 31 - 1:
        chosen = "sort"
    return chosen


def make_plan(a: EllRows, b: EllCols, *, out_cap: Optional[int] = None,
              backend: Optional[str] = None, exact: bool = True,
              tile: int = 4096, slack: float = 1.0,
              mem_budget: Optional[int] = None) -> Plan:
    """Symbolic phase, blocking sizes and backend selection on concrete
    operands.

    ``out_cap``/``backend`` pin the respective decision while the planner
    still derives the rest. ``out_cap`` otherwise is the exact unique count
    times ``slack``, rounded up to a multiple of ``symbolic.LANE``.
    ``exact=False`` (or a pinned ``out_cap`` with a backend other than
    ``'hash'``) replaces the unique counts by the clipped row-flop bound,
    which keeps every size safe. ``mem_budget`` bounds the modeled
    intermediate bytes of the chosen backend (``None``: the operands'
    device's default, ``default_mem_budget``); a pinned backend skips the
    statistics and the cost model, so it ignores it.
    """
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    n_rows, n_cols, n = a.n_rows, b.n_cols, a.n_cols
    if n_rows * n_cols >= 2 ** 31 - 1 and backend not in (None, "sort"):
        raise ValueError(
            f"backend {backend!r} needs packed int32 coordinate keys but the "
            f"output space is {n_rows}x{n_cols}; only 'sort' (unpacked "
            "two-key path) spans it")
    stream = a.k * n * b.k
    stream_pot = _pot(stream)
    slab_lanes = n * b.k

    # symbolic phase: the exact unique pass only where tight uniques are used.
    # The index planes reach the host before its kernels are queued, so the
    # fingerprint is hashed while the device runs them.
    exact = exact and (out_cap is None or backend in (None, "hash"))
    planes = _index_planes(a, b)
    with _obs.span("spgemm.symbolic", backend=backend or "auto", exact=exact,
                   n_rows=n_rows, n_cols=n_cols):
        products_per_row, unique_per_row = symbolic.per_row_counts(
            a, b, exact=exact)
        fp = _digest(planes, a, b)
        products_per_row = products_per_row.cpu().numpy()   # host sync
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
    plan = Plan(backend=backend or "sort", out_cap=int(out_cap), tile=tile,
                stream_cap=_scap(group), stream_group=group,
                n_buckets=n_buckets, bucket_cap=bucket_cap,
                n_blocks=n_blocks, block_cap=block_cap, max_probes=None,
                fp=fp)

    # backend selection; a pinned backend is a sizing-only request
    if backend is None:
        dev = a.idx.device
        if mem_budget is None:
            mem_budget = default_mem_budget(dev)
        plan = dataclasses.replace(plan,
                                   stats=stats_from_ell(a, b, nnz_c=nnz_c))
        costs, interm = plan_costs(plan, a.k, n, b.k, cost_table(dev))
        est = {f"cost_{k}": v for k, v in costs.items()}
        est.update({f"interm_{k}": v for k, v in interm.items()})
        est["mem_budget"] = float(mem_budget)
        est["splim_model_s"] = splim_latency(plan.stats)["total"]
        plan = dataclasses.replace(
            plan, backend=_select(costs, interm, mem_budget, n_rows, n_cols),
            est=est)
    if _obs.is_enabled():
        # the planner-evidence ledger: modeled costs now, measured µs from
        # the instrumented accumulate spans keyed by the same fingerprint
        _obs_metrics.record_plan(plan.fp[:12], plan.backend, plan.est)
        _obs.instant("plan.decision", backend=plan.backend,
                     out_cap=plan.out_cap, pinned=backend is not None)
    return plan


def plan_costs(plan: Plan, k_a: int, n: int, k_b: int,
               table: CostTable):
    """``(costs, interm)``: each backend's modeled cost in ``table``'s units
    and its modeled intermediate bytes, for the sizes of ``plan`` (which
    must carry ``stats``: a plan from ``make_plan(backend=None)``) on
    (k_a, n) × (n, k_b) operands, as ``make_plan`` scores them."""
    stream = k_a * n * k_b
    tile_lanes = plan.stream_group * n * k_b
    costs = _backend_costs(plan.stats, _pot(stream), plan.tile,
                           plan.n_buckets, plan.bucket_cap, plan.n_blocks,
                           plan.block_cap, -(-k_a // plan.stream_group),
                           tile_lanes, plan.stream_cap,
                           _pot(max(plan.out_cap, 128)), table)
    interm = _backend_interm_bytes(stream, _pot(stream), tile_lanes,
                                   plan.stream_cap, plan.n_buckets,
                                   plan.bucket_cap, plan.n_blocks,
                                   plan.block_cap, plan.out_cap)
    return costs, interm


# ---------------------------------------------------------------------------
# Distributed planning (core/distributed.spgemm_coo_sharded)
# ---------------------------------------------------------------------------

SCHEDULES = ("ring", "cstat", "summa")


def _lane_pad(x: int) -> int:
    return max(symbolic.LANE, -(-int(x) // symbolic.LANE) * symbolic.LANE)


def grid_candidates(n_dev: int):
    """The ``(pr, pc)`` factorizations of ``n_dev`` with both sides ≥ 2. A
    side of 1 is a 1-D schedule whose traffic the 2-D model would
    undercount, so such grids are never ``schedule='auto'`` candidates; an
    explicit ``'summa'`` on a prime mesh still runs on one
    (``best_grid(allow_degenerate=True)``), modeled with 1-D bytes."""
    return [(pr, n_dev // pr) for pr in range(2, n_dev)
            if n_dev % pr == 0 and n_dev // pr >= 2]


def best_grid(n_dev: int, k_a: int, k_b: int, *,
              allow_degenerate: bool = False):
    """The ``(pr, pc)`` grid of least operand motion, ``k_a·(pc−1) +
    k_b·(pr−1)`` slab lanes a device. ``None`` where no grid has both sides
    ≥ 2, unless ``allow_degenerate``: then the better of ``(n_dev, 1)`` and
    ``(1, n_dev)``."""
    cands = grid_candidates(n_dev)
    if not cands:
        if not allow_degenerate:
            return None
        cands = [(n_dev, 1), (1, n_dev)] if n_dev > 1 else [(1, 1)]
    return min(cands, key=lambda g: k_a * (g[1] - 1) + k_b * (g[0] - 1))


@dataclasses.dataclass(frozen=True)
class DistPlan:
    """A static distributed-SpGEMM plan; its capacities come from exact
    per-shard, per-grid-cell and per-block histograms, so a planned run
    never drops a partial:

      local_cap — a device's local accumulation width: at least the unique
                  coordinates of any one device's product stream, under the
                  1-D shards and every 2-D grid alike (so
                  ``dataclasses.replace(dp, schedule=...)`` stays safe);
      bin_cap   — a (device, owner) exchange bin;
      block_cap — an owner's row block of C.

    ``(pr, pc)`` is the ``'summa'`` grid (``pr·pc == n_dev``), always set.
    ``base`` is the device-local accumulation's ``Plan``. Equal field by
    field to the reference's plan for the same operands on the CPU, ``est``
    (modeled bytes, excluded from equality) included."""

    schedule: str             # 'ring' | 'cstat' | 'summa'
    n_dev: int
    rows_per_dev: int         # owner(r) = r // rows_per_dev
    local_cap: int
    bin_cap: int
    block_cap: int
    out_cap: int              # the global COO capacity
    base: Plan
    fp: Optional[str] = None  # the operands' sparsity fingerprint
    pr: int = 1               # 'summa' grid rows (A panels hop along rows)
    pc: int = 1               # 'summa' grid columns (B panels along columns)
    est: Dict[str, float] = dataclasses.field(default_factory=dict,
                                              compare=False)


def make_dist_plan(a: EllRows, b: EllCols, *, n_dev: int,
                   schedule: Optional[str] = None,
                   out_cap: Optional[int] = None,
                   backend: Optional[str] = None,
                   tile: int = 4096, slack: float = 1.0) -> DistPlan:
    """The distributed symbolic phase and schedule choice on concrete
    operands, over a mesh axis of ``n_dev`` devices.

    ``make_plan`` gives the device-local backend and the global ``out_cap``
    (on CUDA operands with the card's cost table); the per-shard and
    per-grid-cell product counts and the per-row-block unique counts size
    the exchange. The schedule is the one of fewest modeled bytes a device
    (8 B a lane of operand motion, 12 B a COO triple): ``'ring'`` rotates
    all of B and exchanges the partials by owner, ``'cstat'`` rotates B and
    replicates A, ``'summa'`` hops A panels along grid rows and B panels
    along grid columns plus ``'ring'``'s exchange; a mesh with no grid of
    both sides ≥ 2 models ``'summa'`` as ``'ring'`` and never picks it.
    ``schedule=`` pins the choice. No card's constants enter the bytes."""
    if schedule is not None and schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; expected "
                         f"{SCHEDULES}")
    if n_dev < 1:
        raise ValueError(f"n_dev must be >= 1, got {n_dev}")
    base = make_plan(a, b, out_cap=out_cap, backend=backend, tile=tile,
                     slack=slack)
    n_rows, n = a.n_rows, a.n_cols
    rpd = -(-n_rows // n_dev)
    block_uniq = symbolic.per_block_nnz(a, b, n_dev).cpu().numpy()
    shard_prod = symbolic.per_shard_products(a, b, n_dev).cpu().numpy()
    pr, pc = best_grid(n_dev, a.k, b.k, allow_degenerate=True)
    # caps cover every factorization (both degenerate orientations too), so
    # a plan stays never-drop under dataclasses.replace(dp, pr=, pc=)
    grid_cell_max = max(
        int(symbolic.per_grid_products(a, b, gr, gc).max())
        for gr, gc in grid_candidates(n_dev) + [(1, n_dev)])
    nnz_c = int(block_uniq.sum())
    block_cap = _lane_pad(int(block_uniq.max()))
    local_cap = _lane_pad(min(max(1, nnz_c),
                              max(int(shard_prod.max()), grid_cell_max)))
    # device d sends owner o at most min(d's local uniques, o's block nnz)
    bin_cap = _lane_pad(min(local_cap, block_cap))
    flops = int(shard_prod.sum())
    rotate_b = 8.0 * n * b.k
    exchange = 12.0 * min(nnz_c, max(1, flops // n_dev))
    ring_bytes = rotate_b + exchange
    cstat_bytes = rotate_b + 8.0 * n * a.k
    degenerate = min(pr, pc) < 2
    if degenerate:
        summa_bytes = ring_bytes
    else:
        summa_bytes = (8.0 * n * (a.k * (pc - 1) + b.k * (pr - 1)) / n_dev
                       + exchange)
    est = dict(base.est)
    est.update({"ring_comm_bytes": ring_bytes,
                "cstat_comm_bytes": cstat_bytes,
                "summa_comm_bytes": summa_bytes,
                "summa_pr": float(pr), "summa_pc": float(pc),
                "nnz_c": float(nnz_c), "flops": float(flops)})
    if schedule is None:
        schedule = "cstat" if cstat_bytes < ring_bytes else "ring"
        if not degenerate and summa_bytes < est[f"{schedule}_comm_bytes"]:
            schedule = "summa"
    if _obs.is_enabled():
        _obs.instant("plan.dist_decision", schedule=schedule, n_dev=n_dev,
                     pr=pr, pc=pc, ring_comm_bytes=ring_bytes,
                     cstat_comm_bytes=cstat_bytes,
                     summa_comm_bytes=summa_bytes)
    return DistPlan(schedule=schedule, n_dev=n_dev, rows_per_dev=rpd,
                    local_cap=local_cap, bin_cap=bin_cap, block_cap=block_cap,
                    out_cap=base.out_cap, base=base, fp=base.fp,
                    pr=pr, pc=pc, est=est)


def plan_spmm_format(w, candidates=None):
    """Route a pruned dense ``(d_in, d_out)`` weight to its SpMM format:
    ``("nm", (n, m))`` when some candidate N:M window balances every
    column's reduction windows (the ``kernels/nm_spmm.py`` route),
    ``("ellpack", None)`` otherwise (``spmm_dense_ell``, any pattern at
    worst-row slab width). Results are bit-identical either way;
    ``models.sparse.SparseLinear`` consumes the decision."""
    from ..core.nm import NM_CANDIDATES, detect_nm
    shape = detect_nm(w, NM_CANDIDATES if candidates is None else candidates)
    if _obs.is_enabled():
        _obs.instant("plan.spmm_format",
                     fmt="nm" if shape else "ellpack",
                     nm=str(shape) if shape else "")
    if shape is not None:
        return ("nm", shape)
    return ("ellpack", None)
