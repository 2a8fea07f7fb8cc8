"""Propagation-blocking accumulation on Hopper: bin the packed product stream
by output-row range, then sort and coalesce every bucket independently.

Mirrors ``src/repro/kernels/radix_bucket.py``. Buckets own contiguous row
ranges, so the sorted buckets, concatenated in bucket order, are globally
sorted, and a run of equal keys never straddles a bucket edge.

* ``bin_stream`` bins the stream with the CUDA kernels of
  ``csrc/radix_bucket.cu`` in one entry of three grids, reduce-then-scan
  over 4,096-lane tiles: each tile's count of every bucket (the bucket taken
  from the key in registers), an exclusive scan of each bucket's tile
  counts, then each lane's stable rank, and its key and value written
  straight to ``bucket · bucket_cap + rank``; the last blocks of that grid
  fill only each bucket's empty tail and count the drops. Bound by bytes: 8
  a lane read, 8 a slot written. Plain twin: ``bin_stream_plain`` (the
  reference's binning in torch ops, on ``bin_ranks_plain``).
* ``bin_ranks`` is the same device code with a rank-writing last grid: the
  stable rank of each lane within its bucket, ``rank[i] = #{j ≤ i : bid[j] =
  bid[i]} − 1``, and −1 where ``bid < 0`` or ``bid ≥ n_buckets``, the
  function of ``_make_rank_kernel``. Bound by bytes (8 a lane). Plain twin:
  ``bin_ranks_plain`` (a stable argsort, as ``bin_ranks_xla``).
* ``bucket_merge`` bins (``bin_stream``) and sorts every bucket with
  ``bitonic_merge.sort_tiles`` (one row a bucket). Products past a full
  bucket are dropped and counted; callers poison ``Coo.ngroups`` with the
  count, and the planner's ``bucket_cap`` from the exact histogram never
  drops.

Both entries count their grids on ``bin_ranks.launches``, K7's counter.
Counts and ranks are int32, so the kernels take streams of fewer than 2³¹
lanes (``MAX_LANES``); the wrappers raise a ``ValueError`` beyond it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .bitonic_merge import KEY_INVALID, sort_tiles

MAX_BUCKETS = 256          # the kernels' shared-memory counters
MAX_LANES = 2 ** 31 - 1    # int32 counts and ranks
_TILE = 4096               # lanes a tile, as the kernels' TILE
_LIB = "radix_bucket"
_P, _L = ctypes.c_void_p, ctypes.c_longlong


def _scratch(n: int, n_buckets: int, device) -> torch.Tensor:
    """The kernels' int32 tile counts and column totals: one column a bucket
    and one for lost keys, over at least one tile."""
    return torch.empty((n_buckets + 1) * (max(1, -(-n // _TILE)) + 1),
                       dtype=torch.int32, device=device)


def _check_sizes(name: str, n: int, n_buckets: int) -> None:
    if not 1 <= n_buckets <= MAX_BUCKETS:
        raise ValueError(f"{name} kernel takes 1 to {MAX_BUCKETS} buckets, "
                         f"got {n_buckets}")
    if n > MAX_LANES:
        raise ValueError(f"{name} kernel takes at most {MAX_LANES} lanes "
                         f"(int32 counts and ranks), got {n}")


def _launch(entry: str, argtypes: list, *args) -> None:
    """Run C entry ``entry`` of the library on the current stream of the
    first tensor's device; count its grids on ``bin_ranks.launches``."""
    lib, fns = _build.bind(_LIB, {entry: argtypes + [
        ctypes.POINTER(ctypes.c_int), _P]})
    dev = args[0].device
    grids = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = fns[entry](*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                           for a in args), ctypes.byref(grids),
                         torch.cuda.current_stream(dev).cuda_stream)
    bin_ranks.launches += grids.value
    _build.check(lib, _LIB, err)


def bin_ranks_plain(bid: torch.Tensor, *, n_buckets: int) -> torch.Tensor:
    """Stable rank within each bucket: a stable argsort groups equal ids,
    a lane's rank is its sorted position minus its group's first one."""
    n = bid.numel()
    ok = (bid >= 0) & (bid < n_buckets)
    sb, order = torch.sort(torch.where(ok, bid, -1), stable=True)
    first = torch.searchsorted(sb, sb, side="left", out_int32=True)
    rank = torch.empty(n, dtype=torch.int32, device=bid.device)
    rank[order] = torch.arange(n, dtype=torch.int32, device=bid.device) - first
    return torch.where(ok, rank, -1)


def bin_ranks(bid: torch.Tensor, *, n_buckets: int) -> torch.Tensor:
    """Stable-binning ranks of (n,) int32 bucket ids (−1 = dead lane). The
    kernel takes at most ``MAX_BUCKETS`` buckets (the planner uses ≤ 64)
    and ``MAX_LANES`` lanes."""
    if bid.dim() != 1:
        raise ValueError(f"bin_ranks: ids must be 1-D, got {tuple(bid.shape)}")
    if bid.device.type == "cpu":
        return bin_ranks_plain(bid, n_buckets=n_buckets)
    if bid.device.type != "cuda":
        raise ValueError(f"bin_ranks: no kernel for device {bid.device}")
    n = bid.numel()
    _check_sizes("bin_ranks", n, n_buckets)
    if bid.dtype != torch.int32 or not bid.is_contiguous():
        raise TypeError(f"bin_ranks kernel takes contiguous int32 ids, got "
                        f"{bid.dtype}")
    rank = torch.empty_like(bid)
    _launch("bin_ranks", [_P] * 3 + [_L, ctypes.c_int], bid, rank,
            _scratch(n, n_buckets, bid.device), n, n_buckets)
    return rank


bin_ranks.launches = 0


def bucket_bounds(n_rows: int, n_cols: int, n_buckets: int) -> int:
    """Keys a bucket spans: ``ceil(n_rows / n_buckets)`` contiguous output
    rows of ``n_cols`` packed keys each."""
    return -(-n_rows // n_buckets) * n_cols


def bin_stream_plain(key: torch.Tensor, val: torch.Tensor, *, n_buckets: int,
                     bucket_cap: int, keys_per_bucket: int):
    """The reference's binning in torch ops: bucket ids, their stable ranks
    (``bin_ranks_plain``), then two scatters through a dump slot."""
    valid = key != KEY_INVALID
    bid = torch.where(valid, torch.div(key, keys_per_bucket,
                                       rounding_mode="floor"), -1)
    bid = torch.clamp(bid, max=n_buckets - 1).to(torch.int32)  # ceil-split slack
    rank = bin_ranks_plain(bid, n_buckets=n_buckets)
    in_cap = (rank >= 0) & (rank < bucket_cap)
    dump = n_buckets * bucket_cap
    dst = torch.where(in_cap, bid.long() * bucket_cap + rank, dump)
    binned_key = torch.full((dump + 1,), KEY_INVALID, dtype=torch.int32,
                            device=key.device)
    binned_key.scatter_(0, dst, torch.where(in_cap, key, KEY_INVALID))
    binned_val = torch.zeros(dump + 1, dtype=val.dtype, device=val.device)
    binned_val.scatter_(0, dst, torch.where(in_cap, val, 0))
    dropped = (valid & ~in_cap).sum(dtype=torch.int32)
    return binned_key[:dump], binned_val[:dump], dropped


def bin_stream(key: torch.Tensor, val: torch.Tensor, *, n_buckets: int,
               bucket_cap: int, keys_per_bucket: int):
    """Stable binning: every product to ``(bucket, rank)`` of an
    ``(n_buckets · bucket_cap,)`` layout, KEY_INVALID / 0 in the empty
    slots. Returns ``(binned_key, binned_val, dropped)``, ``dropped`` the
    int32 count of valid products past a full bucket (or below bucket 0).
    The kernel takes int32 keys, float32 values, at most ``MAX_BUCKETS``
    buckets and ``MAX_LANES`` lanes."""
    if bucket_cap < 1 or bucket_cap & (bucket_cap - 1):
        raise ValueError(f"bucket_cap must be a power of two, got {bucket_cap}")
    if not 1 <= keys_per_bucket <= MAX_LANES:
        raise ValueError(f"bin_stream: keys_per_bucket {keys_per_bucket} is "
                         f"not an int32 span of packed keys")
    if key.dim() != 1 or val.shape != key.shape:
        raise ValueError(f"bin_stream: key {tuple(key.shape)} and val "
                         f"{tuple(val.shape)} must be one 1-D shape")
    if key.device != val.device:
        raise ValueError(f"bin_stream: key on {key.device}, val on "
                         f"{val.device}")
    if key.device.type == "cpu":
        return bin_stream_plain(key, val, n_buckets=n_buckets,
                                bucket_cap=bucket_cap,
                                keys_per_bucket=keys_per_bucket)
    if key.device.type != "cuda":
        raise ValueError(f"bin_stream: no kernel for device {key.device}")
    n = key.numel()
    _check_sizes("bin_stream", n, n_buckets)
    if key.dtype != torch.int32 or val.dtype != torch.float32 \
            or not key.is_contiguous() or not val.is_contiguous():
        raise TypeError(f"bin_stream kernel takes contiguous int32 keys and "
                        f"float32 values, got {key.dtype}/{val.dtype}")
    slots = n_buckets * bucket_cap
    binned_key = torch.empty(slots, dtype=torch.int32, device=key.device)
    binned_val = torch.empty(slots, dtype=torch.float32, device=key.device)
    dropped = torch.empty((), dtype=torch.int32, device=key.device)
    _launch("bin_stream", [_P] * 6 + [_L, ctypes.c_int, ctypes.c_int, _L],
            key, val, binned_key, binned_val, dropped,
            _scratch(n, n_buckets, key.device), n, n_buckets,
            int(bucket_cap).bit_length() - 1, int(keys_per_bucket))
    return binned_key, binned_val, dropped


def bucket_merge(key: torch.Tensor, val: torch.Tensor, *, n_buckets: int,
                 bucket_cap: int, keys_per_bucket: int):
    """Propagation-blocking sort + coalesce of a packed-key stream.

    ``key`` (n,) int32 (KEY_INVALID on dead lanes), ``val`` (n,) float.
    Returns ``(key_sorted, totals, dropped)``: the bucket-concatenated,
    globally sorted keys with run-tail totals (KEY_INVALID at each bucket's
    tail), and the int32 count of products dropped by full buckets.
    """
    binned_key, binned_val, dropped = bin_stream(
        key, val, n_buckets=n_buckets, bucket_cap=bucket_cap,
        keys_per_bucket=keys_per_bucket)
    key_s, tot = sort_tiles(binned_key, binned_val, tile=bucket_cap)
    return key_s, tot, dropped
