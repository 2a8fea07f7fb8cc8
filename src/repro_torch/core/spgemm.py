"""End-to-end SPLIM SpGEMM: SCCP multiply → in-situ-search-style accumulate,
mirroring the single-device subset of ``src/repro/core/spgemm.py``.

  * ``spgemm_coo``       — C = A·B as sorted COO. Six accumulation backends:
                           ``'sort'`` (the default, a two-key sort),
                           ``'tiled'`` (the bitonic merge tree,
                           kernels.ops.sort_merge), ``'bucket'`` (propagation
                           blocking, kernels.radix_bucket), ``'hash'``
                           (per-row-block open addressing,
                           kernels.hash_accum), ``'stream'`` (slab-group
                           multiply → sort → compact → merge,
                           core.streaming, the only one that never
                           materializes the (k_a, n, k_b) product stream) and
                           ``'search'`` (the paper's own Alg. 1 / Fig. 11,
                           kernels.insitu_search); ``out_cap='auto'`` sizes
                           the output symbolically, ``accumulator='auto'``
                           lets ``plan.make_plan`` choose the backend, a
                           ``plan`` supplies the cap, the backend and the
                           blocking sizes, ``check=True`` raises on
                           truncation or a backend drop.
  * ``spgemm_coo_numeric`` / ``_numeric_batched`` — the warm numeric phase
                           on a precomputed ``plan.make_structure``: multiply
                           and one slot sum, no planning, no sort.
  * ``spgemm_dense``     — C dense via the same structured multiply.
  * ``spgemm_streaming`` — loop over A slabs, scatter-accumulating dense C.
  * ``spgemm_coo_batched`` / ``spgemm_dense_batched`` — a loop over a
                           leading batch axis of both ELLPACK operands.
  * ``spmm_ell_dense`` / ``spmm_dense_ell`` — ELLPACK × dense.

The entry points report through ``repro_torch.obs`` (spans
``spgemm.multiply``, ``spgemm.accumulate``, ``spgemm.numeric``; the
``spgemm.poison`` event), which costs one flag test while disabled. The
sharded paths are ``core.distributed``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels import ops
from ..kernels.insitu_search import KEY_INVALID, align_keys
from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs
from .accumulate import accumulate, check_no_overflow, scatter_dense
from .formats import (INVALID, Coo, EllCols, EllRows, ell_cols_from_dense,
                      ell_rows_from_dense)
from .sccp import sccp_multiply, sccp_multiply_slab
from .streaming import (_slab_groups, accumulate_products_stream,
                        spgemm_coo_stream)

KEY_SPACE = 2 ** 31 - 1     # packed int32 keys span n_rows·n_cols below this
BACKENDS = ("sort", "tiled", "bucket", "hash", "stream", "search")
def _plan_key(plan, n_rows: int, n_cols: int) -> str:
    """Metrics-ledger key for est-vs-measured joins: the plan fingerprint
    when there is one, else a shape tag."""
    fp = getattr(plan, "fp", None)
    return fp[:12] if fp else f"shape:{n_rows}x{n_cols}"


def _poison_overflow(coo: Coo, dropped: torch.Tensor) -> Coo:
    """Fold a backend's dropped-product count into the overflow contract:
    any drop pushes ``ngroups`` past ``cap`` so ``overflowed()`` flags it
    and ``check_no_overflow`` raises."""
    ng = coo.ngroups + torch.where(dropped > 0, coo.row.shape[-1] + 1, 0).to(
        coo.ngroups.dtype)
    return Coo(row=coo.row, col=coo.col, val=coo.val, shape=coo.shape,
               ngroups=ng)


def _coo_from_merged(key: torch.Tensor, tot: torch.Tensor, out_cap: int,
                     n_rows: int, n_cols: int) -> Coo:
    """Compact a merged stream (sorted keys, run-tail totals) to COO.

    The tails are already in ascending key order, so a cumsum gives each its
    output slot directly (no re-sort). Non-tail lanes and groups past
    ``out_cap`` park in a discarded dump slot; the last lane's successor is
    the run-tail sentinel KEY_INVALID−1, so a valid last lane is a tail."""
    nxt = torch.cat([key[1:], key.new_full((1,), KEY_INVALID - 1)])
    tail = (key != nxt) & (key != KEY_INVALID)
    dst = torch.where(tail, torch.cumsum(tail, 0) - 1, out_cap)
    dst = torch.clamp(dst, max=out_cap)

    def scatter(src, fill):
        out = src.new_full((out_cap + 1,), fill)
        return out.scatter_(0, dst, src)[:out_cap]

    return Coo(row=scatter((key // n_cols).to(torch.int32), INVALID),
               col=scatter((key % n_cols).to(torch.int32), INVALID),
               val=scatter(tot, 0), shape=(n_rows, n_cols),
               ngroups=tail.sum(dtype=torch.int32))


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
                      backend: str = "sort", tile: int = 4096,
                      plan=None) -> Coo:
    """Run one accumulation backend over a raw product stream → sorted COO
    (the backend-dispatch half of ``spgemm_coo``). ``plan`` supplies the
    bucket and table sizes; products a backend drops poison
    ``Coo.ngroups``.

    Traced (``repro_torch.obs``), it runs in a ``spgemm.accumulate`` span
    that ends in a device sync, and its µs feed the planner's
    est-vs-measured ledger; a drop is one ``spgemm.poison`` event."""
    if not _obs.is_enabled():
        return _accumulate_impl(row, col, val, out_cap, n_rows, n_cols,
                                backend=backend, tile=tile, plan=plan)
    with _obs.span("spgemm.accumulate", backend=backend, lanes=row.numel(),
                   out_cap=int(out_cap)) as sp:
        coo = _obs.sync(_accumulate_impl(row, col, val, out_cap, n_rows,
                                         n_cols, backend=backend, tile=tile,
                                         plan=plan))
        ng = int(coo.ngroups)
        sp.set(nnz=ng)
        if ng > out_cap and backend in ("bucket", "hash"):
            # a backend drop: _poison_overflow stamped ngroups past the cap
            _obs_metrics.inc("spgemm.poison_events")
            _obs.instant("spgemm.poison", backend=backend, ngroups=ng,
                         cap=int(out_cap))
    _obs_metrics.record_backend_us(_plan_key(plan, n_rows, n_cols), backend,
                                   sp.dur_us)
    return coo


def _accumulate_impl(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                     out_cap: int, n_rows: int, n_cols: int, *,
                     backend: str, tile: int, plan) -> Coo:
    if backend == "sort":
        return accumulate(row, col, val, out_cap, n_rows, n_cols)
    if backend == "stream":
        scap = plan.stream_cap if plan is not None else None
        grp = plan.stream_group if plan is not None else 1
        return accumulate_products_stream(row, col, val, out_cap, n_rows,
                                          n_cols, chunk=tile,
                                          stream_cap=scap, group=grp)
    if backend == "tiled":
        key, tot = ops.sort_merge(row, col, val, n_rows, n_cols, tile=tile)
        return _coo_from_merged(key, tot, out_cap, n_rows, n_cols)
    if backend == "search":
        # Paper Alg. 1 / Fig. 11: emit the sorted unique keys, align every
        # product against them — values are never sorted. Truncation keeps
        # the first out_cap unique keys and flags via nnz > out_cap.
        uk, sums, nnz = ops.search_merge(row, col, val, n_rows, n_cols,
                                         out_cap=out_cap)
        return _coo_from_slots(uk, sums, nnz, out_cap=out_cap,
                               n_rows=n_rows, n_cols=n_cols)
    if backend == "bucket":
        kw = dict(n_buckets=plan.n_buckets, bucket_cap=plan.bucket_cap) \
            if plan is not None else {}
        key, tot, dropped = ops.bucket_merge(row, col, val, n_rows, n_cols,
                                             **kw)
        return _poison_overflow(
            _coo_from_merged(key, tot, out_cap, n_rows, n_cols), dropped)
    if backend == "hash":
        kw = dict(n_blocks=plan.n_blocks, block_cap=plan.block_cap,
                  max_probes=plan.max_probes) if plan is not None else {}
        key, tot, dropped = ops.hash_merge(row, col, val, n_rows, n_cols,
                                           **kw)
        return _poison_overflow(
            _coo_from_merged(key, tot, out_cap, n_rows, n_cols), dropped)
    raise ValueError(f"unknown accumulator {backend!r}")


def _validate_plan_fp(plan, a: EllRows, b: EllCols) -> None:
    """Raise on a stale plan: its sparsity fingerprint must match the
    operands'. Skipped for ``fp=None`` (deliberate reuse, and the batched
    path's representative-slice plan)."""
    fp = getattr(plan, "fp", None)
    if fp is None:
        return
    from ..plan.structure import fingerprint
    got = fingerprint(a, b)
    if got != fp:
        raise ValueError(
            f"stale plan: operands' sparsity fingerprint {got[:12]}… differs "
            f"from the plan's {fp[:12]}… — the pattern the plan's capacities "
            "were sized for changed, which silently truncates or poisons the "
            "output. Rebuild with plan.make_plan on the new operands, or opt "
            "out for deliberate cross-pattern reuse with "
            "dataclasses.replace(plan, fp=None) (size slack accordingly)")


def spgemm_coo(a: EllRows, b: EllCols, out_cap="auto", *,
               accumulator: str | None = None, tile: int | None = None,
               check: bool = False, plan=None) -> Coo:
    """Sorted-COO SpGEMM (paper Fig. 7-11 pipeline, single device).

    Prefer ``repro_torch.spgemm(a, b, ...)``. ``out_cap`` is the static
    output capacity, or ``'auto'`` to size it with the exact symbolic pass.
    ``accumulator`` is ``'sort'`` (``None`` defaults to it), ``'tiled'``,
    ``'bucket'``, ``'hash'``, ``'stream'`` or ``'search'``, or ``'auto'``:
    ``plan.make_plan`` chooses the backend and sizes it (on CUDA operands it
    then runs that backend's kernels). A ``plan`` (``plan.make_plan``, of
    either package) supplies ``out_cap``, the backend, ``tile`` and the
    blocking sizes, explicit arguments winning; it must have been sized for
    these operands' pattern. Without a plan,
    ``'bucket'``, ``'hash'`` and ``'stream'`` with ``out_cap='auto'`` plan
    their sizes in the same symbolic pass; with an int ``out_cap`` they take
    one stream-sized bucket or table, or one-slab stream steps compacted at
    the full tile width. ``'stream'`` never forms the whole product stream
    (``core.streaming.spgemm_coo_stream``). Output
    spaces with ``n_rows·n_cols ≥ 2³¹−1`` reroute to ``'sort'``, whose
    two-key sort is the only lossless realization there. ``check=True``
    raises ``AccumulatorOverflow`` on truncation or a backend drop.
    """
    if plan is not None:
        _validate_plan_fp(plan, a, b)
    elif accumulator == "auto":
        from ..plan.planner import make_plan
        # an oversized space takes the unpacked 'sort' path below: ask the
        # planner only for its sizes, as the reference does
        plan = make_plan(a, b, out_cap=None if out_cap == "auto" else out_cap,
                         backend="sort" if a.n_rows * b.n_cols >= KEY_SPACE
                         else None)
    if plan is not None:
        out_cap = plan.out_cap if out_cap == "auto" else out_cap
        accumulator = plan.backend if accumulator in (None, "auto") \
            else accumulator
        tile = plan.tile if tile is None else tile
    accumulator = accumulator or "sort"
    tile = tile or 4096
    if accumulator not in BACKENDS:
        raise ValueError(f"unknown accumulator {accumulator!r}")
    if a.n_rows * b.n_cols >= KEY_SPACE:
        accumulator = "sort"
    if out_cap == "auto":
        if accumulator in ("bucket", "hash", "stream"):
            from ..plan.planner import make_plan
            plan = make_plan(a, b, backend=accumulator)
            out_cap = plan.out_cap
        else:
            from ..plan.symbolic import out_cap_auto
            out_cap = out_cap_auto(a, b, exact=True)
    if accumulator == "stream":
        # the point of this backend: the (k_a, n, k_b) stream never exists
        with _obs.span("spgemm.accumulate", backend="stream",
                       lanes=a.k * a.n_cols * b.k, out_cap=int(out_cap)) as sp:
            coo = _obs.sync(spgemm_coo_stream(
                a, b, out_cap,
                stream_cap=plan.stream_cap if plan is not None else None,
                group=plan.stream_group if plan is not None else 1))
        if sp.dur_us is not None:
            _obs_metrics.record_backend_us(
                _plan_key(plan, a.n_rows, b.n_cols), "stream", sp.dur_us)
    else:
        with _obs.span("spgemm.multiply", backend=accumulator, k_a=a.k,
                       k_b=b.k, n=a.n_cols):
            val, row, col = _obs.sync(sccp_multiply(a, b))
        coo = accumulate_stream(row, col, val, out_cap, a.n_rows, b.n_cols,
                                backend=accumulator, tile=tile, plan=plan)
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


def _stack(coos, n_rows: int, n_cols: int) -> Coo:
    """One batched ``Coo`` of per-element results, batch axis first."""
    return Coo(row=torch.stack([c.row for c in coos]),
               col=torch.stack([c.col for c in coos]),
               val=torch.stack([c.val for c in coos]), shape=(n_rows, n_cols),
               ngroups=torch.stack([c.ngroups for c in coos]))


def spgemm_coo_batched(a: EllRows, b: EllCols, out_cap="auto", *,
                       accumulator: str | None = None,
                       tile: int | None = None, check: bool = False,
                       plan=None) -> Coo:
    """Batched C[i] = A[i]·B[i] over a leading batch axis of the ELLPACK
    planes (shared n_rows/n_cols/k/caps). Every leaf of the result,
    ``ngroups`` included, has the batch as its leading axis. Needs a
    concrete ``out_cap`` and backend, or a ``plan`` built with
    ``plan.make_plan`` on a representative slice (its fingerprint is not
    checked against the batch); ``check`` runs once on the batch."""
    if plan is None and (accumulator == "auto" or out_cap == "auto"):
        raise ValueError("batched spgemm needs a concrete out_cap/backend: "
                         "build one with plan.make_plan on a representative "
                         "slice and pass plan=")
    if plan is not None:
        plan = dataclasses.replace(plan, fp=None)
    coos = [spgemm_coo(ai, bi, out_cap, accumulator=accumulator, tile=tile,
                       plan=plan)
            for ai, bi in _slices(a, b)]
    coo = _stack(coos, a.n_rows, b.n_cols)
    if check:
        coo = check_no_overflow(coo)
    return coo


# Dead and missing lanes are summed into this many discarded slots past
# ``out_cap``, one by lane index, so that their atomic adds do not all land
# on one address (most of a product stream's lanes are dead).
DUMP_SLOTS = 1 << 16


def _slot_sums_init(out_cap: int, dtype, device) -> torch.Tensor:
    """Zeroed slot sums: ``out_cap`` output slots, then ``DUMP_SLOTS``."""
    return torch.zeros(out_cap + DUMP_SLOTS, dtype=dtype, device=device)


def _product_keys(row: torch.Tensor, col: torch.Tensor, n_cols: int):
    """``(valid, pk)`` of a product stream, flattened: which lanes hold a
    product, and each lane's packed int32 key (0 on dead lanes)."""
    row, col = row.reshape(-1), col.reshape(-1)
    valid = (row >= 0) & (col >= 0)
    return valid, torch.where(valid, row * n_cols + col, 0).to(torch.int32)


def _slot_index(slot: torch.Tensor, hit: torch.Tensor,
                out_cap: int) -> torch.Tensor:
    """Each lane's index into the slot sums: its output slot where ``hit``,
    else one of the dump slots, chosen by the lane's position."""
    lane = torch.arange(slot.numel(), dtype=torch.int32, device=slot.device)
    return torch.where(hit, slot, out_cap + (lane & (DUMP_SLOTS - 1)))


def _slot_sums(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
               key: torch.Tensor, n_rows: int, n_cols: int, out_cap: int,
               sums: torch.Tensor, *, grouped: bool = True):
    """Add every product's value into its output slot of ``sums``
    (``_slot_sums_init``). The slot is K3 against the structure's sorted
    keys (``#{key < pk}``, the reference's ``searchsorted``): grouped by row
    of C (``ops.align_products``), or the flat ``align_keys`` where
    ``grouped`` is False (a streaming step, under one slab a row); dead
    lanes, and valid products whose key is not there (a stale structure),
    go to the dump slots. Returns the count of such misses."""
    valid, pk = _product_keys(row, col, n_cols)
    slot, hit = (ops.align_products(pk, key, row, n_rows, n_cols) if grouped
                 else align_keys(pk, key))
    hit &= valid                                   # dead lanes never count
    sums.index_add_(0, _slot_index(slot, hit, out_cap),
                    torch.where(valid, val.reshape(-1), 0))
    return (valid & ~hit).sum(dtype=torch.int32)


def _numeric_scatter(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                     key: torch.Tensor, nnz: torch.Tensor, *, out_cap: int,
                     n_rows: int, n_cols: int) -> Coo:
    """Numeric-phase core: locate each product's packed key in the
    structure's sorted unique keys, one segment-sum into the slots. No
    planning, no coordinate sort. A valid product missing from the structure
    (a stale one used with ``validate=False``) loses its value to a dump
    slot and poisons ``Coo.ngroups`` past ``out_cap``, like a backend
    drop."""
    sums = _slot_sums_init(out_cap, val.dtype, val.device)
    n_miss = _slot_sums(row, col, val, key, n_rows, n_cols, out_cap, sums)
    coo = _coo_from_slots(key, sums[:out_cap], nnz, out_cap=out_cap,
                          n_rows=n_rows, n_cols=n_cols)
    return _poison_overflow(coo, n_miss)


def _numeric_stream(a: EllRows, b: EllCols, key: torch.Tensor,
                    nnz: torch.Tensor, *, out_cap: int, n_rows: int,
                    n_cols: int, group: int) -> Coo:
    """Numeric phase for stream-planned structures: a loop over A slab
    groups, each group's (group, n, k_b) products (K1) located and summed
    into the slots. The whole product stream never exists: the working set
    is O(group·n·k_b + out_cap), the cold stream path's, without its
    compaction and merge."""
    a_val, a_idx, n_groups = _slab_groups(a, group)
    sums = _slot_sums_init(out_cap, torch.result_type(a.val, b.val),
                           a.val.device)
    n_miss = torch.zeros((), dtype=torch.int32, device=a.val.device)
    for g in range(n_groups):
        sl = slice(g * group, (g + 1) * group)
        val, row, col = sccp_multiply(
            EllRows(val=a_val[sl], idx=a_idx[sl], n_rows=a.n_rows), b)
        n_miss += _slot_sums(row, col, val, key, n_rows, n_cols, out_cap,
                             sums, grouped=False)
    coo = _coo_from_slots(key, sums[:out_cap], nnz, out_cap=out_cap,
                          n_rows=n_rows, n_cols=n_cols)
    return _poison_overflow(coo, n_miss)


def spgemm_coo_numeric(a: EllRows, b: EllCols, structure, *,
                       check: bool = False, validate: bool = True) -> Coo:
    """Numeric phase of the two-phase SpGEMM: multiply + scatter into a
    precomputed ``SpgemmStructure`` (``plan.make_structure``), no planning
    and no coordinate sort. Prefer ``repro_torch.spgemm(a, b,
    structure=st)``.

    On integer-valued operands the result is bit-identical to the cold
    ``spgemm_coo`` on the operands the structure was built from (float
    operands differ only in summation order): one symbolic call, then any
    number of numeric calls on new values. Structures from stream-planned
    plans go by slab groups (``_numeric_stream``), so the product stream is
    never materialized. ``validate=False`` skips the fingerprint check; a
    stale structure then sends unknown keys to the discarded dump slot AND
    poisons ``Coo.ngroups`` past ``out_cap``, so ``check=True`` raises."""
    if validate:
        structure.validate(a, b)
    if a.val.dim() != 2:
        raise ValueError("batched operands: use spgemm_coo_numeric_batched "
                         "with a structure from make_structure_batched")
    st = structure
    backend = st.plan.backend if st.plan is not None else "sort"
    with _obs.span("spgemm.numeric", backend=backend, out_cap=st.out_cap,
                   n_rows=st.n_rows, n_cols=st.n_cols) as sp:
        if backend == "stream":
            coo = _numeric_stream(a, b, st.key, st.nnz, out_cap=st.out_cap,
                                  n_rows=st.n_rows, n_cols=st.n_cols,
                                  group=max(1, min(st.plan.stream_group,
                                                   a.k)))
        else:
            val, row, col = sccp_multiply(a, b)
            coo = _numeric_scatter(row, col, val, st.key, st.nnz,
                                   out_cap=st.out_cap, n_rows=st.n_rows,
                                   n_cols=st.n_cols)
        if _obs.is_enabled():
            _obs.sync(coo)
            ng = int(coo.ngroups)
            sp.set(nnz=ng)
            if ng > st.out_cap:
                # a structure miss: _poison_overflow stamped ngroups
                _obs_metrics.inc("spgemm.poison_events")
                _obs.instant("spgemm.poison", backend=backend, ngroups=ng,
                             cap=int(st.out_cap))
    if sp.dur_us is not None:
        _obs_metrics.observe(f"numeric_us.{backend}", sp.dur_us)
    if check:
        coo = check_no_overflow(coo)
    return coo


def spgemm_coo_numeric_batched(a: EllRows, b: EllCols, structure, *,
                               check: bool = False,
                               validate: bool = True) -> Coo:
    """Batched numeric phase: the slot scatter per element of the leading
    batch axis of both operands and of the structure's keys/nnz
    (``plan.make_structure_batched``); ``spgemm_coo_numeric``'s contract,
    ``check`` once on the batched result."""
    if validate:
        structure.validate(a, b)
    if not structure.batched:
        raise ValueError("structure is unbatched — build one with "
                         "plan.make_structure_batched for batched operands")
    st = structure
    coos = []
    for i, (ai, bi) in enumerate(_slices(a, b)):
        val, row, col = sccp_multiply(ai, bi)
        coos.append(_numeric_scatter(row, col, val, st.key[i], st.nnz[i],
                                     out_cap=st.out_cap, n_rows=st.n_rows,
                                     n_cols=st.n_cols))
    coo = _stack(coos, a.n_rows, b.n_cols)
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
