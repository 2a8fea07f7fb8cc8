"""Streaming SpGEMM accumulation: slab-group multiply → sort → compact →
merge, mirroring ``src/repro/core/streaming.py``.

The paper's BSS memory argument (§III-A, Fig. 8) is that slab products are
streamed into accumulation: the device never holds the whole product stream,
only the tile of the current step. The materialized backends hold the
(k_a, n, k_b) stream (12 B a lane) and sort all of it; this engine's working
set is one slab-group tile plus the running output buffer,
O(group·n·k_b + out_cap), whatever ``k_a``.

One step per group of ``group`` A slabs, a Python loop (the reference's
``lax.scan``); ``count`` and ``dropped`` stay device tensors, so nothing in
the loop waits for the host:

  1. **multiply + sort** — the group's (group, n, k_b) products are formed,
     packed to int32 coordinate keys and sorted with run-tail totals by one
     fused kernel (K8, ``kernels.ops.fused_slab_sort``), so unsorted products
     never reach device memory. A stream that is already materialized
     (``accumulate_products_stream``) is packed and sorted by K5 instead.
  2. **compact** — the tile's run tails (its unique coordinates with their
     totals) go to the front of a ``stream_cap``-lane tile: cumsum +
     ``searchsorted`` + two gathers, no scatter. Padding lanes die here.
  3. **merge** — the compacted tile, padded to the buffer width, is merged
     into the running sorted, coalesced buffer and compacted back to the
     buffer width in one pass (``bitonic_merge.merge_compact_pair``: K6's
     merge-path grids, which also place each unique at its compacted lane
     and read both lists' valid counts on the device). Both lists are
     duplicate-free, so a key has at most two lanes, one in each.

``StreamState.dropped`` counts every unique coordinate lost to an undersized
``stream_cap`` or buffer; any drop poisons ``Coo.ngroups`` past the cap, so
``check_no_overflow`` raises. Planner-sized runs (``plan.make_plan``:
``stream_cap``/``stream_group`` from the exact per-slab product histogram,
``out_cap`` from the symbolic phase) never drop.

Packed int32 keys need ``n_rows·n_cols < 2³¹−1``; ``spgemm_coo`` reroutes
larger spaces to the unpacked two-key ``'sort'`` before reaching here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import ops
from ..kernels.bitonic_merge import bitonic_merge, merge_compact_pair
from ..kernels.bitonic_merge import coalesce_compact as _coalesce_compact
from ..kernels.insitu_search import KEY_INVALID, next_pot
from ..obs import trace as _obs
from .formats import INVALID, Coo, EllCols, EllRows


class StreamState(NamedTuple):
    """The running sorted, coalesced output buffer.

    ``key``/``tot``: (buf_cap,) ascending unique packed coordinates with
    their running totals, KEY_INVALID/0 after the first ``count`` lanes.
    ``dropped`` counts unique coordinates lost to undersized caps; any
    non-zero poisons the final ``ngroups``.
    """

    key: torch.Tensor      # (buf_cap,) int32
    tot: torch.Tensor      # (buf_cap,) values
    count: torch.Tensor    # () int32: valid unique lanes in the buffer
    dropped: torch.Tensor  # () int32: uniques lost to stream_cap/buffer


def stream_init(buf_cap: int, dtype=torch.float32, device=None) -> StreamState:
    """Empty state; ``buf_cap`` must be a power of two (the merge width)."""
    if buf_cap < 1 or buf_cap & (buf_cap - 1):
        raise ValueError(f"buf_cap {buf_cap} must be a power of two")
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return StreamState(
        key=torch.full((buf_cap,), KEY_INVALID, dtype=torch.int32,
                       device=device),
        tot=torch.zeros(buf_cap, dtype=dtype, device=device),
        count=zero, dropped=zero)


def _compact_tile(key: torch.Tensor, tot: torch.Tensor, *, stream_cap: int,
                  buf_cap: int):
    """The first half of a step: one sorted run-tail-total tile compacted to
    its uniques at width ``min(stream_cap, buf_cap)`` (a tile never keeps
    more uniques than the buffer holds), padded to ``buf_cap`` lanes.
    Returns ``(key, tot, count, dropped)``, ``count`` its valid lanes."""
    cap = min(int(stream_cap), buf_cap)
    with _obs.span("stream.compact", cap=cap):
        k_t, v_t, count, drop_t = _obs.sync(_coalesce_compact(key, tot, cap))
    if cap < buf_cap:                      # the pad keeps the list ascending
        k_t = torch.cat([k_t, k_t.new_full((buf_cap - cap,), KEY_INVALID)])
        v_t = torch.cat([v_t, v_t.new_zeros(buf_cap - cap)])
    return k_t, v_t, count, drop_t


def _merge_tile(state: StreamState, key: torch.Tensor, tot: torch.Tensor,
                count: torch.Tensor, dropped: torch.Tensor) -> StreamState:
    """The second half of a step: a compacted tile (``_compact_tile``, its
    ``count`` valid lanes) merged into the buffer and compacted back to the
    buffer width in one ``merge_compact_pair``; ``dropped`` is the tile's
    own count of lost uniques."""
    with _obs.span("stream.merge", buf_cap=state.key.numel()):
        k_b, v_b, n_b, drop_m = _obs.sync(merge_compact_pair(
            state.key, state.tot, key, tot, cap=state.key.numel(),
            n_a=state.count, n_b=count))
    return StreamState(key=k_b, tot=v_b, count=n_b,
                       dropped=state.dropped + dropped + drop_m)


def absorb_sorted(state: StreamState, key: torch.Tensor, tot: torch.Tensor, *,
                  stream_cap: int) -> StreamState:
    """Compact one sorted run-tail-total tile and merge it into the buffer."""
    return _merge_tile(state, *_compact_tile(key, tot, stream_cap=stream_cap,
                                             buf_cap=state.key.numel()))


def _sort_tile(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
               n_cols: int):
    """Pack one raw product tile and sort it as one row with run-tail totals
    (K5 on CUDA), the contract ``ops.fused_slab_sort`` emits."""
    row, col, val = row.reshape(-1), col.reshape(-1), val.reshape(-1)
    pot = next_pot(row.numel())
    key = torch.where(row >= 0, row * n_cols + col,
                      KEY_INVALID).to(torch.int32)
    pad = pot - key.numel()
    if pad:
        key = torch.cat([key, key.new_full((pad,), KEY_INVALID)])
        val = torch.cat([val, val.new_zeros(pad)])
    return bitonic_merge(key, val.contiguous())


def absorb_products(state: StreamState, row: torch.Tensor, col: torch.Tensor,
                    val: torch.Tensor, *, n_cols: int,
                    stream_cap: int) -> StreamState:
    """Stream a block of raw product tiles through sort → compact → merge,
    one step per leading-axis tile of the 2-D ``(tiles, m)`` planes (a 1-D
    stream is one tile)."""
    if row.dim() == 1:
        row, col, val = row[None], col[None], val[None]
    for r, c, v in zip(row, col, val):
        key, tot = _sort_tile(r, c, v, n_cols)
        state = absorb_sorted(state, key, tot, stream_cap=stream_cap)
    return state


def finalize(state: StreamState, out_cap: int, n_rows: int,
             n_cols: int) -> Coo:
    """Unpack the buffer into ``Coo(out_cap)``. ``ngroups`` is the true unique
    count while nothing was dropped; any drop (or uniques beyond ``out_cap``
    in an oversized buffer) leaves it past the cap."""
    key, tot = state.key, state.tot
    if key.numel() < out_cap:
        pad = out_cap - key.numel()
        key = torch.cat([key, key.new_full((pad,), KEY_INVALID)])
        tot = torch.cat([tot, tot.new_zeros(pad)])
    key, tot = key[:out_cap], tot[:out_cap]
    valid = key != KEY_INVALID
    ngroups = state.count + torch.where(state.dropped > 0, out_cap + 1,
                                        0).to(torch.int32)
    return Coo(row=torch.where(valid, key // n_cols, INVALID).to(torch.int32),
               col=torch.where(valid, key % n_cols, INVALID).to(torch.int32),
               val=torch.where(valid, tot, 0), shape=(n_rows, n_cols),
               ngroups=ngroups.to(torch.int32))


def _check_packable(n_rows: int, n_cols: int):
    if n_rows * n_cols >= KEY_INVALID:
        raise ValueError(
            f"coordinate space {n_rows}x{n_cols} exceeds packed int32 keys; "
            "the streaming engine cannot span it — use the unpacked two-key "
            "path (spgemm_coo(accumulator='sort') routes automatically)")


def buffer_cap(out_cap: int, *, lane: int = 128) -> int:
    """Merge-buffer width for an output capacity: a power of two, at least
    one lane tile."""
    return next_pot(max(int(out_cap), lane))


def _slab_groups(a: EllRows, group: int):
    """A's planes padded to a multiple of ``group`` slabs, and the count of
    groups."""
    a_val = ops.pad_to(a.val, 0, group, 0)
    a_idx = ops.pad_to(a.idx, 0, group, INVALID)
    return a_val, a_idx, a_val.shape[0] // group


def spgemm_coo_stream(a: EllRows, b: EllCols, out_cap="auto", *,
                      stream_cap: Optional[int] = None,
                      group: Optional[int] = None) -> Coo:
    """C = A·B as sorted COO without materializing the product stream.

    Prefer ``repro_torch.spgemm(a, b, accumulator='stream')``. One step per
    group of ``group`` A slabs: K8 multiplies and sorts the (group, n, k_b)
    tile, which is compacted to its unique coordinates and merged into the
    running buffer. ``stream_cap`` defaults to the full group tile (never
    drops). ``out_cap='auto'`` runs ``plan.make_plan(backend='stream')``,
    whose ``stream_cap``/``stream_group`` then fill whichever of the two is
    None.
    """
    if a.n_cols != b.n_rows:
        raise ValueError(f"contraction mismatch: A has {a.n_cols} cols, "
                         f"B has {b.n_rows} rows")
    _check_packable(a.n_rows, b.n_cols)
    if out_cap == "auto":
        from ..plan.planner import make_plan
        plan = make_plan(a, b, backend="stream")
        out_cap = plan.out_cap
        stream_cap = plan.stream_cap if stream_cap is None else stream_cap
        group = plan.stream_group if group is None else group
    group = max(1, min(int(group or 1), a.k))
    a_val, a_idx, n_groups = _slab_groups(a, group)
    scap = int(stream_cap) if stream_cap else next_pot(group * a.n_cols * b.k)
    state = stream_init(buffer_cap(out_cap), a.val.dtype, a.val.device)
    for g in range(n_groups):
        sl = slice(g * group, (g + 1) * group)
        key, tot = ops.fused_slab_sort(a_val[sl], a_idx[sl], b.val, b.idx,
                                       n_cols=b.n_cols)
        state = absorb_sorted(state, key, tot, stream_cap=scap)
    return finalize(state, out_cap, a.n_rows, b.n_cols)


def spgemm_coo_stream_numeric(a: EllRows, b: EllCols, structure, *,
                              check: bool = False,
                              validate: bool = True) -> Coo:
    """The numeric phase by the slab-group scan whatever the structure's
    planned backend: ``core.spgemm._numeric_stream`` over ``structure``
    (``plan.make_structure``), the group from its plan. Same working set as
    ``spgemm_coo_stream``; ``repro_torch.spgemm(a, b, structure=st)`` takes
    this route by itself for stream-planned structures."""
    if validate:
        structure.validate(a, b)
    from .spgemm import _numeric_stream
    plan = structure.plan
    grp = 1 if plan is None else max(1, min(plan.stream_group, a.k))
    coo = _numeric_stream(a, b, structure.key, structure.nnz,
                          out_cap=structure.out_cap, n_rows=structure.n_rows,
                          n_cols=structure.n_cols, group=grp)
    if check:
        from .accumulate import check_no_overflow
        coo = check_no_overflow(coo)
    return coo


def accumulate_products_stream(row: torch.Tensor, col: torch.Tensor,
                               val: torch.Tensor, out_cap: int, n_rows: int,
                               n_cols: int, *, chunk: int = 4096,
                               stream_cap: Optional[int] = None,
                               group: int = 1) -> Coo:
    """Streaming accumulation of an already-materialized product stream (the
    ``accumulate_stream(backend='stream')`` realization): the sort's working
    set stays one tile. A 3-D ``(k_a, n, k_b)`` stream goes by groups of
    ``group`` slabs, the tiles ``spgemm_coo_stream`` forms, in the same order;
    a flat stream by ``chunk`` lanes, compacted at the full chunk width
    (``stream_cap`` bounds a slab group, not an arbitrary chunk)."""
    _check_packable(n_rows, n_cols)
    if row.dim() == 3:
        group = max(1, min(int(group), row.shape[0]))
        row = ops.pad_to(row, 0, group, INVALID)
        col = ops.pad_to(col, 0, group, INVALID)
        val = ops.pad_to(val, 0, group, 0)
        tiles = row.shape[0] // group
        row, col, val = (x.reshape(tiles, -1) for x in (row, col, val))
    else:
        row, col, val = row.reshape(-1), col.reshape(-1), val.reshape(-1)
        chunk = min(chunk, next_pot(row.numel()))
        row = ops.pad_to(row, 0, chunk, INVALID)
        col = ops.pad_to(col, 0, chunk, INVALID)
        val = ops.pad_to(val, 0, chunk, 0)
        row, col, val = (x.reshape(-1, chunk) for x in (row, col, val))
        stream_cap = None
    scap = int(stream_cap) if stream_cap else next_pot(row.shape[-1])
    state = stream_init(buffer_cap(out_cap), val.dtype, val.device)
    state = absorb_products(state, row, col, val, n_cols=n_cols,
                            stream_cap=scap)
    return finalize(state, out_cap, n_rows, n_cols)
