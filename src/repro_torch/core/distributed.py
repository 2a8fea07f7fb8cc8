"""Distributed SpGEMM: the sparse-native ring schedules of
``src/repro/core/distributed.py`` on an in-process device mesh.

Paper Fig. 6(c): B column-vectors rotate from array to array while A
row-vectors stay; every array multiplies its resident A slabs by the
visiting B slabs, and intermediate results never cross arrays (§VI-D). The
reference maps the arrays to a mesh axis under ``shard_map``; here one host
program drives every shard along one named axis of a ``parallel.mesh.Mesh``
(any number of axes: the group at index 0 of the others runs, the other
axes replicate, as ``shard_map`` over one axis computes the same result in
every group): a shard is a
tensor on its device, a rotation is ``mesh.ppermute`` (a fresh copy on the
destination, so shards never alias, even all on ``cuda:0``), and a step is
a loop over the shards. Every shard's products are K1
(``kernels/sccp_multiply.py``) on its device; partials are accumulated
there, sparsely, by the plan's backend on the kernels that backend
launches, and only COO triples binned by output-row owner cross the mesh.

Three schedules (chosen by ``plan.make_dist_plan``):

  * ``'ring'``  — B-stationary: A slabs stay split, B slabs rotate; each
    device accumulates its steps' product stream into a local sorted COO,
    then ``mesh.ring_all_to_all`` exchanges the partials binned by row-block
    owner, who merges them.
  * ``'cstat'`` — C-stationary: every device masks the whole of A to the
    rows it owns and merges each visiting B slab's products straight into
    its block of C; intermediates never cross the mesh, at the price of
    replicating A.
  * ``'summa'`` — 2-D: the axis is a ``pr × pc`` grid; a device gathers its
    grid row's A panel over ``pc − 1`` hops, then B panels rotate ``pr − 1``
    hops along the grid column; the same exchange as ``'ring'`` ends it.

``overlap=True`` copies the next panel on a side stream
(``mesh.ppermute_start``) while the current panel's products are formed
and accumulated, and joins before the next step; the result is the same bits
with ``overlap=False``. ``ngroups`` carries every shard's drops (local-cap
truncation, full exchange bins, block-cap truncation) summed over the mesh,
so ``check_no_overflow`` sees them. The result is one ``Coo`` on the mesh's
first device, equal to the single-device ``spgemm_coo``'s.

``ring_spgemm`` keeps a dense C a shard and sums them: the dense baseline
the sparse path replaces.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..kernels.insitu_search import next_pot
from ..kernels.ops import pad_to
from ..kernels.sccp_multiply import sccp_multiply
from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs
from ..parallel import mesh as _mesh
from ..parallel.mesh import ring_all_to_all
from ..parallel.sharding import (ShardedEll, spec_dim, split_operand,
                                 spgemm_operand_specs)
from . import streaming
from .accumulate import accumulate, check_no_overflow, scatter_dense
from .formats import INVALID, Coo, EllCols, EllRows


# ---------------------------------------------------------------------------
# Slab padding
# ---------------------------------------------------------------------------

def pad_slabs_a(a: EllRows, mult: int) -> EllRows:
    """A's slab axis padded to a multiple of ``mult`` with dead lanes
    (``idx = -1``, ``val = 0``), which form no products."""
    if a.val.shape[-2] % mult == 0:
        return a
    return EllRows(val=pad_to(a.val, -2, mult, 0),
                   idx=pad_to(a.idx, -2, mult, INVALID), n_rows=a.n_rows)


def pad_slabs_b(b: EllCols, mult: int) -> EllCols:
    """B's slab axis padded to a multiple of ``mult`` with dead lanes."""
    if b.val.shape[-1] % mult == 0:
        return b
    return EllCols(val=pad_to(b.val, -1, mult, 0),
                   idx=pad_to(b.idx, -1, mult, INVALID), n_cols=b.n_cols)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _bin_by_owner(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                  n_dev: int, rows_per_dev: int, bin_cap: int):
    """A row-sorted local COO (dead lanes last) scattered into per-owner
    exchange bins: each owner's entries are one contiguous run, so an
    entry's rank in its bin is its position less the run's start. Returns
    ``(n_dev, bin_cap)`` row/col/val planes and the count of entries lost
    to full bins (0 under a ``make_dist_plan`` sizing)."""
    cap = row.shape[0]
    valid = row >= 0
    owner = torch.where(valid, torch.div(row, rows_per_dev,
                                         rounding_mode="floor"),
                        n_dev).long()
    counts = torch.bincount(owner, minlength=n_dev + 1)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(cap, device=row.device) - start[owner]
    keep = valid & (rank < bin_cap)
    dropped = (valid & ~keep).sum(dtype=torch.int32)
    slot = torch.where(keep, owner * bin_cap + rank, n_dev * bin_cap)

    def scatter(src, fill):
        buf = src.new_full(((n_dev + 1) * bin_cap,), fill)
        buf[slot] = torch.where(keep, src, fill)
        return buf[: n_dev * bin_cap].view(n_dev, bin_cap)

    return scatter(row, INVALID), scatter(col, INVALID), scatter(val, 0), \
        dropped


def _compact_sorted(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                    out_cap: int, shape, ngroups: torch.Tensor) -> Coo:
    """A globally sorted, gappy COO stream packed into ``Coo(out_cap)`` by a
    cumsum scatter (no sort): the owners' blocks arrive in ascending row
    ranges, each sorted. Entries past ``out_cap`` land in a discarded dump
    slot; ``ngroups`` (the true global count, maybe poisoned) flags it."""
    valid = row >= 0
    dst = torch.where(valid, torch.cumsum(valid, 0) - 1, out_cap)
    dst = torch.clamp(dst, max=out_cap)

    def scatter(src, fill):
        out = src.new_full((out_cap + 1,), fill)
        return out.scatter_(0, dst, torch.where(valid, src, fill))[:out_cap]

    return Coo(row=scatter(row, INVALID), col=scatter(col, INVALID),
               val=scatter(val, 0), shape=shape,
               ngroups=ngroups.to(torch.int32))


def _rotate(bv: List[torch.Tensor], bi: List[torch.Tensor], perm):
    return _mesh.ppermute(bv, perm), _mesh.ppermute(bi, perm)


class _Panels:
    """The visiting operand panels of a rotation: ``advance`` moves them one
    hop, its copies started ahead with ``overlap`` (``prefetch`` before the
    step's work, joined by ``advance``)."""

    def __init__(self, val, idx, perm, overlap: bool):
        self.val, self.idx = list(val), list(idx)
        self.perm, self.overlap = perm, overlap
        self._next = None

    def prefetch(self) -> None:
        if self.overlap:
            self._next = (_mesh.ppermute_start(self.val, self.perm),
                          _mesh.ppermute_start(self.idx, self.perm))

    def advance(self) -> None:
        if self._next is not None:
            self.val, self.idx = (p.wait() for p in self._next)
            self._next = None
        else:
            self.val, self.idx = _rotate(self.val, self.idx, self.perm)


def _grid_perms(pr: int, pc: int):
    """The 'summa' grid's row ring and column ring over the flat axis:
    device ``d = r·pc + c``."""
    row_perm = [(q * pc + j, q * pc + (j + 1) % pc)
                for q in range(pr) for j in range(pc)]
    col_perm = [(q * pc + j, ((q + 1) % pr) * pc + j)
                for q in range(pr) for j in range(pc)]
    return row_perm, col_perm


def _row_panels(av, ai, pr: int, pc: int):
    """Each device's grid-row A panel: its own slabs, then ``pc − 1`` hops
    along the row ring, concatenated on the slab axis (order is free:
    coordinates are absolute and accumulation sorts)."""
    row_perm, _ = _grid_perms(pr, pc)
    vals, idxs = [[v] for v in av], [[i] for i in ai]
    for _ in range(pc - 1):
        av, ai = _rotate(av, ai, row_perm)
        for d in range(len(av)):
            vals[d].append(av[d])
            idxs[d].append(ai[d])
    return ([torch.cat(v, dim=0) for v in vals],
            [torch.cat(i, dim=0) for i in idxs])


def _resolve_mesh(mesh, axis: str):
    if not isinstance(mesh, _mesh.Mesh):
        raise TypeError("mesh= takes a repro_torch.parallel.Mesh (from "
                        f"parallel.make_mesh), got {type(mesh).__name__}")
    return mesh.axis_devices(axis)


def _whole(x):
    return x.whole() if isinstance(x, ShardedEll) else x


def _ndim(x) -> int:
    return x.ndim if isinstance(x, ShardedEll) else x.val.dim()


def _pads(x, n_dev: int, a_side: bool):
    """``x`` with its slab axis padded to a multiple of ``n_dev``; a sharded
    operand is taken as placed (``put_spgemm_operands`` padded it)."""
    if isinstance(x, ShardedEll):
        return x
    return pad_slabs_a(x, n_dev) if a_side else pad_slabs_b(x, n_dev)


def _element(s: ShardedEll, i: int) -> ShardedEll:
    """Batch element ``i`` of a batched sharded operand."""
    return dataclasses.replace(
        s, val=tuple(v[i] for v in s.val), idx=tuple(x[i] for x in s.idx),
        dim=None if s.dim is None else s.dim - 1)


# ---------------------------------------------------------------------------
# Sparse-native distributed SpGEMM
# ---------------------------------------------------------------------------

def spgemm_coo_sharded(a, b, mesh, axis: str, out_cap="auto", *,
                       accumulator: str = "auto", schedule: str = "auto",
                       dist_plan=None, structure=None, overlap: bool = True,
                       check: bool = False) -> Coo:
    """C = A·B as sorted COO with the slabs sharded over mesh axis ``axis``.

    Prefer ``repro_torch.spgemm(a, b, mesh=mesh, axis=axis, ...)``. ``a``
    and ``b`` are the whole operands or ``parallel.put_spgemm_operands``'s
    pair. The result is bit-compatible with the single-device
    ``spgemm_coo``: the same sorted coordinates, padding and true
    ``ngroups``, with any shard's drops poisoning it past ``out_cap``.

    ``out_cap``/``accumulator``/``schedule`` take ``'auto'`` (planned on
    the operands); a ``dist_plan`` (``plan.make_dist_plan``, of either
    package) supplies every capacity, and a ``structure`` built with
    ``n_dev=`` its cached one. A given plan's fingerprint is checked against
    unbatched operands. Batched operands (a leading batch axis on every
    plane) need a ``dist_plan`` built on one element. ``check=True`` raises
    ``AccumulatorOverflow`` on any drop. Output spaces of 2³¹−1 coordinates
    or more accumulate by the unpacked ``'sort'``, whatever the backend.

    ``accumulator='stream'`` accumulates inside the rotation: each step's
    products are sorted, compacted and merged into the device's running
    buffer (``streaming.absorb_products``), so a device holds one step's
    tile and the buffer; the other backends keep a device's steps' products
    and accumulate them after the rotation, one device at a time."""
    devices = _resolve_mesh(mesh, axis)
    n_dev = len(devices)
    batched = _ndim(a) == 3
    if dist_plan is None and structure is not None:
        dist_plan = structure.dist_plan(
            None if schedule == "auto" else schedule)
        if out_cap == "auto":
            out_cap = structure.out_cap
    if dist_plan is None:
        if batched:
            raise ValueError(
                "spgemm_coo_sharded needs a dist_plan with batched operands "
                "— build one with plan.make_dist_plan on one (unbatched) "
                "element and pass dist_plan=")
        from ..plan.planner import make_dist_plan
        dist_plan = make_dist_plan(
            _whole(a), _whole(b), n_dev=n_dev,
            out_cap=None if out_cap == "auto" else int(out_cap),
            backend=None if accumulator == "auto" else accumulator,
            schedule=None if schedule == "auto" else schedule)
    dp = dist_plan
    if dp.n_dev != n_dev:
        raise ValueError(f"dist_plan built for {dp.n_dev} devices but mesh "
                         f"axis {axis!r} has {n_dev}")
    if not batched:
        from .spgemm import _validate_plan_fp
        _validate_plan_fp(dp, _whole(a), _whole(b))
    out_cap = dp.out_cap if out_cap == "auto" else int(out_cap)
    sched = dp.schedule if schedule == "auto" else schedule
    if sched not in ("ring", "cstat", "summa"):
        raise ValueError(f"unknown schedule {sched!r}")
    pr, pc = dp.pr, dp.pc
    if sched == "summa" and pr * pc != n_dev:
        # a hand-built plan: factor the axis here (local_cap covers every
        # grid under make_dist_plan; hand caps are the caller's contract)
        from ..plan.planner import best_grid
        pr, pc = best_grid(n_dev, a.k, b.k, allow_degenerate=True)
    backend = dp.base.backend if accumulator == "auto" else accumulator
    n_rows, n_cols = a.n_rows, b.n_cols
    if n_rows * n_cols >= 2 ** 31 - 1:
        backend = "sort"                     # only unpacked keys span this
    a, b = _pads(a, n_dev, True), _pads(b, n_dev, False)
    spec_a, spec_b = spgemm_operand_specs(axis, schedule=sched,
                                          batched=batched)
    with _obs.span("dist.place", schedule=sched):
        sa = _obs.sync(split_operand(a, devices, spec_dim(spec_a, axis)))
        sb = _obs.sync(split_operand(b, devices, spec_dim(spec_b, axis)))
    run = dict(dp=dp, sched=sched, pr=pr, pc=pc, backend=backend,
               out_cap=out_cap, n_rows=n_rows, n_cols=n_cols,
               overlap=overlap)

    def body():
        if not batched:
            return _sharded(sa, sb, **run)
        coos = [_sharded(_element(sa, i), _element(sb, i), **run)
                for i in range(sa.val[0].shape[0])]
        from .spgemm import _stack
        return _stack(coos, n_rows, n_cols)

    if _obs.is_enabled():
        # the exchange is observed at the call's boundary, with the plan's
        # modeled bytes a device attached
        comm = float(dp.est.get(f"{sched}_comm_bytes", 0.0))
        steps = (pc - 1) + pr if sched == "summa" else n_dev
        span_kw = dict(schedule=sched, backend=backend, n_dev=n_dev,
                       steps=steps, overlap=overlap,
                       comm_bytes_per_dev=comm)
        if sched == "summa":
            span_kw["grid"] = f"{pr}x{pc}"
        with _obs.span("dist.exchange", **span_kw):
            coo = _obs.sync(body())
        _obs_metrics.inc(f"dist.comm_bytes.{sched}", comm * n_dev)
        _obs_metrics.inc("dist.calls")
        if overlap:
            # the modeled share of the rotation's bytes that fits under the
            # local accumulation (12 B a product read and written)
            work = 12.0 * float(dp.est.get("flops", 0.0)) / max(1, n_dev)
            _obs_metrics.gauge("dist.overlap_efficiency",
                               1.0 if comm <= 0 else min(1.0, work / comm))
    else:
        coo = body()
    if check:
        coo = check_no_overflow(coo)
    return coo


def _sharded(sa: ShardedEll, sb: ShardedEll, *, dp, sched: str, pr: int,
             pc: int, backend: str, out_cap: int, n_rows: int, n_cols: int,
             overlap: bool) -> Coo:
    """One unbatched sharded product on the placed operands (see
    ``spgemm_coo_sharded``)."""
    n_dev = len(sa.val)
    if sched == "cstat":
        rows, cols, vals, ngs, poison = _cstat(
            sa, sb, dp=dp, backend=backend, n_rows=n_rows, n_cols=n_cols,
            overlap=overlap)
    else:
        if sched == "summa":
            av, ai = _row_panels(list(sa.val), list(sa.idx), pr, pc)
            perm, steps = _grid_perms(pr, pc)[1], pr
        else:
            av, ai = list(sa.val), list(sa.idx)
            perm, steps = _mesh.ring_perm(n_dev), n_dev
        local = _rotating_products(av, ai, sb, perm, steps, dp=dp,
                                   backend=backend, n_rows=n_rows,
                                   n_cols=n_cols, overlap=overlap)
        rows, cols, vals, ngs, poison = _exchange_tail(
            local, dp=dp, n_rows=n_rows, n_cols=n_cols)
    with _obs.span("dist.compact", out_cap=out_cap):
        ng = _mesh.psum(ngs)
        ng = ng + torch.where(_mesh.psum(poison) > 0, out_cap + 1, 0).to(
            ng.dtype)
        home = ng.device
        return _obs.sync(_compact_sorted(
            torch.cat([r.to(home) for r in rows]),
            torch.cat([c.to(home) for c in cols]),
            torch.cat([v.to(home) for v in vals]),
            out_cap, (n_rows, n_cols), ng))


def _rotating_products(av, ai, sb: ShardedEll, perm, steps: int, *, dp,
                       backend: str, n_rows: int, n_cols: int,
                       overlap: bool) -> List[Coo]:
    """``steps`` rotation stages of the resident panels (``av``, ``ai``)
    times the visiting B panels; returns each device's local sorted COO
    (``dp.local_cap``). Traced, the rotation is the ``dist.multiply`` span
    (under ``'stream'`` the steps' merges too) and the accumulation after
    it ``dist.local_accumulate``."""
    n_dev = len(av)
    panels = _Panels(sb.val, sb.idx, perm, overlap)
    base, local_cap = dp.base, dp.local_cap
    if backend == "stream":
        states = [streaming.stream_init(streaming.buffer_cap(local_cap),
                                        av[d].dtype, av[d].device)
                  for d in range(n_dev)]
    else:
        parts = [[] for _ in range(n_dev)]
    with _obs.span("dist.multiply", steps=steps, backend=backend):
        for step in range(steps):
            last = step == steps - 1
            if not last:
                panels.prefetch()
            for d in range(n_dev):
                v, r, c = sccp_multiply(av[d], ai[d], panels.val[d],
                                         panels.idx[d])
                if backend == "stream":
                    states[d] = streaming.absorb_products(
                        states[d], r.reshape(-1), c.reshape(-1),
                        v.reshape(-1), n_cols=n_cols,
                        stream_cap=next_pot(r.numel()))
                else:
                    parts[d].append((r.reshape(-1), c.reshape(-1),
                                     v.reshape(-1)))
            if not last:
                panels.advance()
        _obs.sync(states if backend == "stream" else parts)
    with _obs.span("dist.local_accumulate", backend=backend):
        if backend == "stream":
            return _obs.sync([streaming.finalize(st, local_cap, n_rows,
                                                 n_cols) for st in states])
        from .spgemm import accumulate_stream
        local = []
        for d in range(n_dev):
            # one device's steps at a time, freed before the next device's
            r, c, v = (torch.cat(x) for x in zip(*parts[d]))
            parts[d] = None
            local.append(accumulate_stream(r, c, v, local_cap, n_rows,
                                           n_cols, backend=backend,
                                           tile=base.tile, plan=base))
            del r, c, v
        return _obs.sync(local)


def _exchange_tail(local: List[Coo], *, dp, n_rows: int, n_cols: int):
    """The owner-binned COO exchange and each owner's block merge, shared by
    ``'ring'`` and ``'summa'`` (owners are flat device ids either way).
    Returns each device's block planes, its group count and its drops.
    Traced: the ``dist.bin``, ``dist.all_to_all`` and ``dist.block_merge``
    spans."""
    n_dev = len(local)
    rpd, bin_cap, block_cap = dp.rows_per_dev, dp.bin_cap, dp.block_cap
    poison, coords, vals = [], [], []
    with _obs.span("dist.bin", bin_cap=bin_cap):
        for d, loc in enumerate(local):
            br, bc, bv, dropped = _bin_by_owner(loc.row, loc.col, loc.val,
                                                n_dev, rpd, bin_cap)
            poison.append((loc.ngroups > dp.local_cap).to(torch.int32)
                          + (dropped > 0).to(torch.int32))
            coords.append(torch.stack([br, bc], dim=-1))
            vals.append(bv)
            local[d] = None
        _obs.sync(vals)
    with _obs.span("dist.all_to_all", n_dev=n_dev):
        got_i = ring_all_to_all(coords)
        del coords
        got_v = _obs.sync(ring_all_to_all(vals))
        del vals
    rows, cols, blk_vals, ngs = [], [], [], []
    with _obs.span("dist.block_merge", block_cap=block_cap):
        for d in range(n_dev):
            gi, gv = got_i[d], got_v[d]
            got_i[d] = got_v[d] = None
            blk = accumulate(gi[..., 0].reshape(-1), gi[..., 1].reshape(-1),
                             gv.reshape(-1), block_cap, n_rows, n_cols)
            del gi, gv
            poison[d] = poison[d] + (blk.ngroups > block_cap).to(torch.int32)
            rows.append(blk.row)
            cols.append(blk.col)
            blk_vals.append(blk.val)
            ngs.append(blk.ngroups)
        _obs.sync(blk_vals)
    return rows, cols, blk_vals, ngs, poison


def _cstat(sa: ShardedEll, sb: ShardedEll, *, dp, backend: str,
           n_rows: int, n_cols: int, overlap: bool):
    """C-stationary: device ``d`` masks the whole of A to its rows
    ``[d·rpd, (d+1)·rpd)`` and merges each visiting B panel's products into
    its block of C. Returns each device's block planes, its group count and
    its drops. Traced: the ``dist.multiply_merge`` span."""
    n_dev = len(sa.val)
    rpd, block_cap = dp.rows_per_dev, dp.block_cap
    av, ai = [], []
    for d in range(n_dev):
        lo = d * rpd
        own = (sa.idx[d] >= lo) & (sa.idx[d] < lo + rpd)
        av.append(torch.where(own, sa.val[d], 0))
        ai.append(torch.where(own, sa.idx[d], INVALID))
    panels = _Panels(sb.val, sb.idx, _mesh.ring_perm(n_dev), overlap)
    use_stream = backend == "stream"
    blocks, poison = [], []
    for d in range(n_dev):
        dev = av[d].device
        if use_stream:
            blocks.append(streaming.stream_init(
                streaming.buffer_cap(block_cap), av[d].dtype, dev))
        else:
            empty = torch.full((block_cap,), INVALID, dtype=torch.int32,
                               device=dev)
            blocks.append(Coo(row=empty, col=empty.clone(),
                              val=torch.zeros(block_cap, dtype=av[d].dtype,
                                              device=dev),
                              shape=(n_rows, n_cols),
                              ngroups=torch.zeros((), dtype=torch.int32,
                                                  device=dev)))
        poison.append(torch.zeros((), dtype=torch.int32, device=dev))
    from .spgemm import accumulate_stream
    with _obs.span("dist.multiply_merge", steps=n_dev, backend=backend):
        for step in range(n_dev):
            last = step == n_dev - 1
            if not last:
                panels.prefetch()
            for d in range(n_dev):
                v, r, c = sccp_multiply(av[d], ai[d], panels.val[d],
                                         panels.idx[d])
                r, c, v = r.reshape(-1), c.reshape(-1), v.reshape(-1)
                if use_stream:
                    blocks[d] = streaming.absorb_products(
                        blocks[d], r, c, v, n_cols=n_cols,
                        stream_cap=next_pot(r.numel()))
                    continue
                blk = blocks[d]
                blk = accumulate_stream(
                    torch.cat([blk.row, r]), torch.cat([blk.col, c]),
                    torch.cat([blk.val, v]), block_cap, n_rows, n_cols,
                    backend=backend, tile=dp.base.tile, plan=None)
                poison[d] = poison[d] + (blk.ngroups > block_cap).to(
                    torch.int32)
                blocks[d] = blk
                del v, r, c
            if not last:
                panels.advance()
        if use_stream:
            blocks = [streaming.finalize(st, block_cap, n_rows, n_cols)
                      for st in blocks]
            poison = [(blk.ngroups > block_cap).to(torch.int32)
                      for blk in blocks]
        _obs.sync(blocks)
    return ([blk.row for blk in blocks], [blk.col for blk in blocks],
            [blk.val for blk in blocks], [blk.ngroups for blk in blocks],
            poison)


def spgemm_coo_sharded_batched(a, b, mesh, axis: str, *, dist_plan,
                               schedule: str = "auto", overlap: bool = True,
                               check: bool = False) -> Coo:
    """Batched sharded SpGEMM: every ELLPACK plane carries a leading batch
    axis (shapes and caps shared). Prefer ``repro_torch.spgemm(a, b,
    mesh=mesh, axis=axis, dist_plan=dp)``. ``dist_plan`` comes from
    ``plan.make_dist_plan`` on one element. Every leaf of the result,
    ``ngroups`` included, leads with the batch axis."""
    if _ndim(a) != 3 or _ndim(b) != 3:
        raise ValueError("batched operands need a leading batch axis on all "
                         f"ELLPACK planes; got A {_ndim(a)}D, "
                         f"B {_ndim(b)}D")
    return spgemm_coo_sharded(a, b, mesh, axis, dist_plan=dist_plan,
                              schedule=schedule, overlap=overlap,
                              check=check)


def spgemm_coo_sharded_numeric(a, b, mesh, axis: str, structure, *,
                               schedule: str = "auto", overlap: bool = True,
                               check: bool = False,
                               validate: bool = True) -> Coo:
    """The distributed numeric phase: B slabs rotate (the 1-D ring, or the
    ``'summa'`` grid's column ring after the A row panels gather), each
    step's products (K1) find their slots in the structure's keys (K3, the
    warm phase's ``_slot_sums``, dead and missing lanes spread over the dump
    slots), and one sum over the mesh adds the devices' slot sums. Prefer
    ``repro_torch.spgemm(a, b, mesh=mesh, axis=axis, structure=st)``.

    No planning, no local sort, no exchange. ``schedule`` is ``'auto'`` (the
    structure's cached ``'summa'`` pick, else ``'ring'``), ``'ring'`` or
    ``'summa'``; ``'cstat'`` has no resident block here and raises
    ``ValueError``. The structure (``plan.make_structure`` on the whole
    operands) needs no ``n_dev``. Valid products missing from it (a stale
    structure with ``validate=False``) are counted over the mesh and poison
    ``ngroups``."""
    from .spgemm import (_coo_from_slots, _poison_overflow, _slot_sums,
                         _slot_sums_init)
    devices = _resolve_mesh(mesh, axis)
    n_dev = len(devices)
    if validate:
        structure.validate(_whole(a), _whole(b))
    if _ndim(a) != 2:
        raise ValueError("spgemm_coo_sharded_numeric is unbatched — use "
                         "spgemm_coo_numeric_batched for batched operands")
    st = structure
    if schedule not in ("auto", "ring", "summa"):
        raise ValueError(
            f"unknown numeric-path schedule {schedule!r} — the warm numeric "
            "phase supports 'auto', 'ring', or 'summa' (no resident C block, "
            "so 'cstat' does not apply)")
    sched, pr, pc = schedule, 1, 1
    cached = None
    if st.dist_plans:
        dp = st.dist_plan(None)
        if dp.n_dev == n_dev:
            cached = dp
    if sched == "auto":
        sched = ("summa" if cached is not None and cached.schedule == "summa"
                 else "ring")
    if sched == "summa":
        if cached is not None and cached.pr * cached.pc == n_dev:
            pr, pc = cached.pr, cached.pc
        else:
            from ..plan.planner import best_grid
            pr, pc = best_grid(n_dev, a.k, b.k, allow_degenerate=True)
    a, b = _pads(a, n_dev, True), _pads(b, n_dev, False)
    sa = split_operand(a, devices, 0)
    sb = split_operand(b, devices, 1)
    n_rows, n_cols, out_cap = st.n_rows, st.n_cols, st.out_cap
    if sched == "summa":
        av, ai = _row_panels(list(sa.val), list(sa.idx), pr, pc)
        perm, steps = _grid_perms(pr, pc)[1], pr
    else:
        av, ai = list(sa.val), list(sa.idx)
        perm, steps = _mesh.ring_perm(n_dev), n_dev
    dtype = torch.result_type(av[0], sb.val[0])
    keys = [st.key.to(dev) for dev in devices]
    sums = [_slot_sums_init(out_cap, dtype, dev) for dev in devices]
    miss = [torch.zeros((), dtype=torch.int32, device=dev)
            for dev in devices]
    panels = _Panels(sb.val, sb.idx, perm, overlap)
    with _obs.span("dist.multiply_slots", schedule=sched, steps=steps):
        for step in range(steps):
            last = step == steps - 1
            if not last:
                panels.prefetch()
            for d in range(n_dev):
                v, r, c = sccp_multiply(av[d], ai[d], panels.val[d],
                                         panels.idx[d])
                miss[d] = miss[d] + _slot_sums(r, c, v, keys[d], n_rows,
                                               n_cols, out_cap, sums[d])
                del v, r, c
            if not last:
                panels.advance()
        _obs.sync(sums)
    with _obs.span("dist.psum", out_cap=out_cap):
        total = _obs.sync(_mesh.psum([s[:out_cap] for s in sums]))
        n_miss = _mesh.psum(miss)
    coo = _coo_from_slots(st.key.to(total.device), total,
                          st.nnz.to(total.device), out_cap=out_cap,
                          n_rows=n_rows, n_cols=n_cols)
    coo = _poison_overflow(coo, n_miss)
    if check:
        coo = check_no_overflow(coo)
    return coo


# ---------------------------------------------------------------------------
# The dense baseline
# ---------------------------------------------------------------------------

def ring_spgemm(a: EllRows, b: EllCols, mesh, axis: str) -> torch.Tensor:
    """C = A·B dense, with the slabs sharded over ``axis`` and the B slabs
    rotating: each device scatters its products into a dense C of its own
    and a final sum adds them. A device holds O(n_rows·n_cols) whatever the
    sparsity, which is what ``spgemm_coo_sharded`` avoids; kept as the
    dense baseline. Slab counts that ``axis`` does not divide are padded."""
    devices = _resolve_mesh(mesh, axis)
    n_dev = len(devices)
    a, b = pad_slabs_a(a, n_dev), pad_slabs_b(b, n_dev)
    n_rows, n_cols = a.n_rows, b.n_cols
    sa = split_operand(a, devices, 0)
    sb = split_operand(b, devices, 1)
    c = [torch.zeros((n_rows, n_cols), dtype=sa.val[d].dtype,
                     device=devices[d]) for d in range(n_dev)]
    bv, bi = list(sb.val), list(sb.idx)
    perm = _mesh.ring_perm(n_dev)
    for step in range(n_dev):
        for d in range(n_dev):
            v, r, col = sccp_multiply(sa.val[d], sa.idx[d], bv[d], bi[d])
            c[d] += scatter_dense(r, col, v, n_rows, n_cols)
            del v, r, col
        if step < n_dev - 1:
            bv, bi = _rotate(bv, bi, perm)
    return _mesh.psum(c)



__all__ = ["pad_slabs_a", "pad_slabs_b", "ring_all_to_all",
           "ring_spgemm", "spgemm_coo_sharded", "spgemm_coo_sharded_batched",
           "spgemm_coo_sharded_numeric"]
