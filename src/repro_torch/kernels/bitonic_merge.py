"""The (key, value) row sort, the merge-tree level and the streaming
engine's merge-and-compact step on Hopper, with the run-tail totals.

Mirrors ``src/repro/kernels/bitonic_merge.py``. Two kernels, each with a
plain torch twin here and a launch counter on its wrapper (one per grid):

* ``sort_tiles`` (K5) replaces ``_make_sort_kernel``: every power-of-two row
  of ``tile`` (int32 key, float32 value) pairs sorted ascending, then each
  run of equal keys leaves its value total on its last lane and 0
  elsewhere. Row tails are row-local: a row's last lane is a tail even when
  the next row starts with the same key. Bound by bytes. The TPU's bitonic
  network made one pass over device memory for every stride at or above a
  shared tile (66 at a 2²² row); the port sorts every row with the LSD
  radix sort of ``csrc/radix_sort.cuh`` (``radix_sort.sort_rows``): four
  8-bit digit passes, the value carried beside its key, histograms and
  offsets per (row, digit), so 13 grids for rows above one 4,096-lane tile
  whatever the row's length, and 2 for rows of at most one tile, which a
  block sorts in shared memory a tile of whole rows at a time. The last
  grid is the totals, in which each run's tail walks back over its run.
  Plain twin: ``torch.sort(stable=True)`` on the ``(n/tile, tile)`` view,
  then the segmented total (``sort_tiles_xla``).
* ``merge_runs`` (K6) replaces ``_make_merge_kernel``: adjacent ascending
  coalesced runs of ``run`` lanes merged into rows of ``2·run`` with their
  run-tail totals. Bound by bytes. The TPU's bitonic merge network made one
  pass over device memory a stride above a shared tile; the port merges by
  merge path (``csrc/bitonic_merge.cu``): a partition grid finds each
  4,096-lane output window's co-rank by binary search, a merge grid stages
  the window's two spans in shared memory and merges them, each thread 16
  lanes from its own co-rank, and writes every lane once, the totals fused
  (a group's total is the two runs' tails, since the inputs are coalesced).
  Rows of at most one window take the merge grid alone, whole rows a block.
  Plain twin: ``torch.sort`` on the ``(n/2run, 2run)`` view, then the
  segmented total. ``merge_coalesce_pair`` is one such level over two
  lists. ``merge_compact_pair``, the streaming engine's step, merges two
  duplicate-free lists and compacts the result in the same pass (four
  grids, counted on ``merge_runs.launches``): every key of the union once,
  with ``count`` and ``dropped`` as device scalars; its plain twin is
  ``merge_coalesce_pair``'s followed by ``coalesce_compact``.

Each wrapper launches its kernels for CUDA tensors and runs the plain twin
only for tensors the caller put on the CPU.

Keys are KEY_INVALID on dead lanes, which sort last and carry total 0. On
integer-valued inputs every total is exact, so the kernel and the plain twin
agree bit for bit; on float inputs K5 sums a run in another order, while
K6's totals, two terms, agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, radix_sort
from .insitu_search import KEY_INVALID, next_pot

_KEY_FILL = -2            # never a packed coordinate (>= 0) nor KEY_INVALID
_LIB = "bitonic_merge"


def _shift_right(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    pad = x.new_full(x.shape[:-1] + (d,), fill)
    return torch.cat([pad, x[..., :-d]], dim=-1)


def _segmented_total_rows(key: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Along the last (power-of-two) axis: the inclusive log-step segmented
    scan, then each run's total kept on its tail lane, 0 elsewhere. Tails
    are row-local and KEY_INVALID lanes get 0."""
    for p in range(key.shape[-1].bit_length() - 1):
        d = 1 << p
        same = _shift_right(key, d, _KEY_FILL) == key
        val = val + torch.where(same, _shift_right(val, d, 0), 0)
    nxt = torch.cat([key[..., 1:],
                     key.new_full(key.shape[:-1] + (1,), KEY_INVALID - 1)],
                    dim=-1)
    return torch.where((key != nxt) & (key != KEY_INVALID), val, 0)


def _sort_rows_plain(key: torch.Tensor, val: torch.Tensor, row: int):
    k2, order = torch.sort(key.reshape(-1, row), dim=1, stable=True)
    v2 = torch.gather(val.reshape(-1, row), 1, order)
    return k2.reshape(-1), _segmented_total_rows(k2, v2).reshape(-1)


def sort_tiles_plain(key: torch.Tensor, val: torch.Tensor, *, tile: int):
    return _sort_rows_plain(key, val, tile)


def merge_runs_plain(key: torch.Tensor, val: torch.Tensor, *, run: int):
    return _sort_rows_plain(key, val, 2 * run)


def _rows(name: str, key: torch.Tensor, val: torch.Tensor, row: int) -> bool:
    """Check the shapes; True for CUDA operands (kernel), False for CPU ones
    (plain twin). Raises on anything the kernel does not take."""
    n = key.numel()
    if key.shape != val.shape or key.dim() != 1:
        raise ValueError(f"{name}: key {tuple(key.shape)} and value "
                         f"{tuple(val.shape)} must be one 1-D length")
    if row < 1 or row & (row - 1) or n % row:
        raise ValueError(f"{name}: rows of {row} must be a power of two "
                         f"dividing the stream length {n}")
    if key.device != val.device:
        raise ValueError(f"{name}: operands on {key.device} and {val.device}")
    if key.device.type == "cpu":
        return False
    if key.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {key.device}")
    if key.dtype != torch.int32 or val.dtype != torch.float32 \
            or not key.is_contiguous() or not val.is_contiguous():
        raise TypeError(f"{name} kernel takes contiguous int32 keys and "
                        f"float32 values, got {key.dtype}/{val.dtype}")
    return True


def sort_tiles(key: torch.Tensor, val: torch.Tensor, *, tile: int):
    """Sort every length-``tile`` row of (key, val) ascending and coalesce:
    returns ``(key_sorted, totals)``, run tails carrying totals, rest 0.
    On CUDA: the radix sort's grids (``tot`` is their value scratch until
    the totals, the last grid, write it), then the totals."""
    if not _rows("sort_tiles", key, val, tile):
        return sort_tiles_plain(key, val, tile=tile)
    k_out = torch.empty_like(key)
    v_sorted = torch.empty_like(val)
    tot = torch.empty_like(val)
    radix_sort.sort_rows(sort_tiles, key, val, k_out, v_sorted, tile,
                         v_scratch=tot)
    seg_totals(sort_tiles, k_out, v_sorted, tot, tile)
    return k_out, tot


sort_tiles.launches = 0


def seg_totals(wrapper, key: torch.Tensor, val: torch.Tensor,
               tot: torch.Tensor, row: int) -> None:
    """The run-tail totals of ``key``'s sorted rows of ``row`` lanes into
    ``tot`` (one grid, ``seg_totals_f32``, added to ``wrapper.launches``):
    the last grid of K5 and of K8's step. ``val`` is read only on lanes
    whose key is not KEY_INVALID."""
    lib, fns = _build.bind(_LIB, {"seg_totals_f32": (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])})
    fn = fns["seg_totals_f32"]
    with torch.cuda.device(key.device):
        err = fn(key.data_ptr(), val.data_ptr(), tot.data_ptr(), key.numel(),
                 row, torch.cuda.current_stream(key.device).cuda_stream)
    _build.check(lib, _LIB, err)
    wrapper.launches += 1


WINDOW = 4096             # merged lanes a block of csrc/bitonic_merge.cu


def merge_scratch(n: int, run: int) -> int:
    """int64 entries of ``merge_runs``'s partition: for rows of ``2·run``
    above a window, the co-rank of every window's first lane and each row's
    end; none for shorter rows."""
    row = 2 * run
    return 0 if row <= WINDOW else n // row * (row // WINDOW + 1)


def compact_scratch(length: int) -> int:
    """int64 entries of ``merge_compact_pair``'s scratch for two lists of
    ``length`` lanes: the windows' co-ranks, counts and offsets, and the
    uniques' total."""
    return 3 * (-(-2 * length // WINDOW) + 1) + 1


def merge_runs(key: torch.Tensor, val: torch.Tensor, *, run: int):
    """One merge-tree level: adjacent sorted, coalesced runs of ``run``
    lanes → sorted, coalesced runs of ``2·run``. On CUDA: one grid for rows
    of at most a window, else the partition grid and the merge grid."""
    if not _rows("merge_runs", key, val, 2 * run):
        return merge_runs_plain(key, val, run=run)
    lib, fns = _build.bind(_LIB, {"merge_runs_f32": (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])})
    fn = fns["merge_runs_f32"]
    k_out = torch.empty_like(key)
    tot = torch.empty_like(val)
    part = torch.empty(merge_scratch(key.numel(), run), dtype=torch.int64,
                       device=key.device)
    grids = ctypes.c_int(0)
    with torch.cuda.device(key.device):
        err = fn(key.data_ptr(), val.data_ptr(), k_out.data_ptr(),
                 tot.data_ptr(), part.data_ptr(), part.numel(), key.numel(),
                 run, ctypes.byref(grids),
                 torch.cuda.current_stream(key.device).cuda_stream)
    merge_runs.launches += grids.value
    _build.check(lib, _LIB, err)
    return k_out, tot


merge_runs.launches = 0


def merge_coalesce_pair(key_a: torch.Tensor, val_a: torch.Tensor,
                        key_b: torch.Tensor, val_b: torch.Tensor):
    """Two equal-length ascending streams → one ascending stream of twice
    the length with run-tail totals: one ``merge_runs`` level over the
    concatenated pair. Each input follows the stream contract (KEY_INVALID
    padding at the tail, every valid lane carrying a total), so a key in
    both inputs ends with the grand total on its tail."""
    return merge_runs(torch.cat([key_a, key_b]), torch.cat([val_a, val_b]),
                      run=key_a.numel())


def coalesce_compact(key: torch.Tensor, tot: torch.Tensor, cap: int):
    """Pack a sorted run-tail-total stream's unique coordinates into ``cap``
    lanes (ascending, KEY_INVALID padding). The tails are in ascending key
    order, so ``searchsorted`` over the tail prefix sum maps output slot →
    source lane (two gathers, no scatter). Tails beyond ``cap`` are counted.
    Returns ``(key, tot, count, dropped)``; the streaming engine's
    compaction (``src/repro/core/streaming.py:_coalesce_compact``)."""
    nxt = torch.cat([key[1:], key.new_full((1,), KEY_INVALID - 1)])
    tail = (key != nxt) & (key != KEY_INVALID)
    csum = torch.cumsum(tail, 0, dtype=torch.int32)
    n_tail = csum[-1]
    want = torch.arange(1, cap + 1, dtype=torch.int32, device=key.device)
    src = torch.searchsorted(csum, want, out_int32=True)
    src = torch.clamp(src, max=key.numel() - 1)
    kept = torch.clamp(n_tail, max=cap)
    ok = torch.arange(cap, device=key.device) < kept
    return (torch.where(ok, key[src], KEY_INVALID),
            torch.where(ok, tot[src], 0), kept,
            torch.clamp(n_tail - cap, min=0))


def merge_compact_pair_plain(key_a: torch.Tensor, val_a: torch.Tensor,
                             key_b: torch.Tensor, val_b: torch.Tensor, *,
                             cap: int):
    """``merge_compact_pair``'s function in torch ops: the merged pair's
    uniques compacted into ``cap`` lanes."""
    mk, mt = merge_runs_plain(torch.cat([key_a, key_b]),
                              torch.cat([val_a, val_b]), run=key_a.numel())
    return coalesce_compact(mk, mt, cap)


def merge_compact_pair(key_a: torch.Tensor, val_a: torch.Tensor,
                       key_b: torch.Tensor, val_b: torch.Tensor, *, cap: int,
                       n_a=None, n_b=None):
    """The streaming engine's step: two equal-length ascending,
    duplicate-free lists (KEY_INVALID/0 after their valid lanes) merged and
    compacted into ``cap`` lanes. Returns ``(key, tot, count, dropped)``:
    every key of the union once, ascending, with its total (the sum of its
    two lanes), then KEY_INVALID/0; ``count = min(uniques, cap)`` and
    ``dropped = max(uniques − cap, 0)`` as int32 device scalars, the
    result of ``merge_coalesce_pair`` followed by ``coalesce_compact``.

    ``n_a``/``n_b`` (int32 scalars on the lists' device, optional) are the
    lists' valid-lane counts: on CUDA the kernel reads them on the device and
    touches no lane past them; without them it merges every lane. The CPU
    twin ignores them. On CUDA: the partition, count, scan and write grids
    of ``csrc/bitonic_merge.cu``, added to ``merge_runs.launches``; nothing
    waits for the host."""
    n = key_a.numel()
    if key_b.numel() != n or n < 1:
        raise ValueError(f"merge_compact_pair: lists of {n} and "
                         f"{key_b.numel()} lanes must be one length >= 1")
    cuda = _rows("merge_compact_pair", key_a, val_a, 1)
    if _rows("merge_compact_pair", key_b, val_b, 1) != cuda \
            or key_a.device != key_b.device:
        raise ValueError("merge_compact_pair: lists on "
                         f"{key_a.device} and {key_b.device}")
    if cap < 0:
        raise ValueError(f"merge_compact_pair: cap {cap} < 0")
    if not cuda:
        return merge_compact_pair_plain(key_a, val_a, key_b, val_b, cap=cap)
    dev = key_a.device
    counts = []
    for c in (n_a, n_b):
        if c is None:
            c = torch.full((), n, dtype=torch.int32, device=dev)
        if c.dtype != torch.int32 or c.numel() != 1 or c.device != dev:
            raise TypeError("merge_compact_pair: n_a/n_b must be int32 "
                            f"scalars on {dev}")
        counts.append(c)
    lib, fns = _build.bind(_LIB, {"merge_compact_f32": (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
        + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
        + [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.c_void_p])})
    k_out = torch.empty(cap, dtype=torch.int32, device=dev)
    v_out = torch.empty(cap, dtype=torch.float32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    dropped = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(compact_scratch(n), dtype=torch.int64, device=dev)
    grids = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = fns["merge_compact_f32"](
            key_a.data_ptr(), val_a.data_ptr(), key_b.data_ptr(),
            val_b.data_ptr(), counts[0].data_ptr(), counts[1].data_ptr(), n,
            n, k_out.data_ptr(), v_out.data_ptr(), cap, count.data_ptr(),
            dropped.data_ptr(), scratch.data_ptr(), scratch.numel(),
            ctypes.byref(grids),
            torch.cuda.current_stream(dev).cuda_stream)
    merge_runs.launches += grids.value
    _build.check(lib, _LIB, err)
    return k_out, v_out, count, dropped


def bitonic_merge(key: torch.Tensor, val: torch.Tensor):
    """Sort and coalesce one power-of-two stream as a single row."""
    return sort_tiles(key, val, tile=key.numel())


def sort_merge_tree(key: torch.Tensor, val: torch.Tensor, *,
                    tile: int = 4096):
    """Blocked sort + coalesce of a power-of-two stream: a stream of at most
    one ``tile`` is one row; a larger one is tile-sorted, then adjacent runs
    are merged up the tree, log₂(n/tile) levels. Output: globally sorted keys
    with run-tail totals."""
    n = key.numel()
    if n & (n - 1) or tile & (tile - 1):
        raise ValueError(f"sort_merge_tree: stream {n} and tile {tile} must "
                         "be powers of two")
    if n <= tile:
        return bitonic_merge(key, val)
    key, val = sort_tiles(key, val, tile=tile)
    run = tile
    while run < n:
        key, val = merge_runs(key, val, run=run)
        run *= 2
    return key, val


__all__ = ["KEY_INVALID", "bitonic_merge", "coalesce_compact",
           "merge_coalesce_pair", "merge_compact_pair",
           "merge_compact_pair_plain", "merge_runs", "merge_runs_plain",
           "next_pot", "sort_merge_tree", "sort_tiles", "sort_tiles_plain"]
