"""Propagation-blocking accumulation on Hopper: bin the packed product stream
by output-row range, then sort and coalesce every bucket independently.

Mirrors ``src/repro/kernels/radix_bucket.py``. Buckets own contiguous row
ranges, so the sorted buckets, concatenated in bucket order, are globally
sorted, and a run of equal keys never straddles a bucket edge.

* ``bin_ranks`` replaces ``_make_rank_kernel`` with the CUDA kernel of
  ``csrc/radix_bucket.cu``: the stable rank of each lane within its bucket,
  ``rank[i] = #{j ≤ i : bid[j] = bid[i]} − 1``, and −1 where ``bid < 0`` or
  ``bid ≥ n_buckets``. Bound by bytes (8 a lane); three grids (per-chunk
  histograms, an exclusive scan over chunks per bucket, the in-chunk rank).
  Plain twin: ``bin_ranks_plain`` (a stable argsort, as ``bin_ranks_xla``).
* ``bucket_merge`` bins (``bin_stream``: the ranks, then torch scatters)
  and sorts every bucket with ``bitonic_merge.sort_tiles`` (one row a
  bucket). Products past a full bucket are dropped and counted; callers
  poison ``Coo.ngroups`` with the count, and the planner's ``bucket_cap``
  from the exact histogram never drops.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .bitonic_merge import KEY_INVALID, sort_tiles

MAX_BUCKETS = 256          # the kernel's shared-memory counters
_CHUNK = 1024              # lanes a block, as the kernel's CHUNK
_LIB = "radix_bucket"


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
    kernel takes at most ``MAX_BUCKETS`` buckets (the planner uses ≤ 64)."""
    if bid.dim() != 1:
        raise ValueError(f"bin_ranks: ids must be 1-D, got {tuple(bid.shape)}")
    if bid.device.type == "cpu":
        return bin_ranks_plain(bid, n_buckets=n_buckets)
    if bid.device.type != "cuda":
        raise ValueError(f"bin_ranks: no kernel for device {bid.device}")
    if bid.dtype != torch.int32 or not bid.is_contiguous():
        raise TypeError(f"bin_ranks kernel takes contiguous int32 ids, got "
                        f"{bid.dtype}")
    if not 1 <= n_buckets <= MAX_BUCKETS:
        raise ValueError(f"bin_ranks kernel takes 1 to {MAX_BUCKETS} buckets, "
                         f"got {n_buckets}")
    n = bid.numel()
    rank = torch.empty_like(bid)
    counts = torch.empty(n_buckets * -(-n // _CHUNK), dtype=torch.int32,
                         device=bid.device)
    lib, fns = _build.bind(_LIB, {"bin_ranks": (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int),
                                 ctypes.c_void_p])})
    fn = fns["bin_ranks"]
    grids = ctypes.c_int(0)
    with torch.cuda.device(bid.device):
        err = fn(bid.data_ptr(), rank.data_ptr(), counts.data_ptr(), n,
                 n_buckets, ctypes.byref(grids),
                 torch.cuda.current_stream(bid.device).cuda_stream)
    bin_ranks.launches += grids.value
    _build.check(lib, _LIB, err)
    return rank


bin_ranks.launches = 0


def bucket_bounds(n_rows: int, n_cols: int, n_buckets: int) -> int:
    """Keys a bucket spans: ``ceil(n_rows / n_buckets)`` contiguous output
    rows of ``n_cols`` packed keys each."""
    return -(-n_rows // n_buckets) * n_cols


def bin_stream(key: torch.Tensor, val: torch.Tensor, *, n_buckets: int,
               bucket_cap: int, keys_per_bucket: int):
    """Stable binning: every product to ``(bucket, rank)`` of an
    ``(n_buckets · bucket_cap,)`` layout, KEY_INVALID / 0 in the empty
    slots. Returns ``(binned_key, binned_val, dropped)``, ``dropped`` the
    int32 count of valid products past a full bucket."""
    if bucket_cap & (bucket_cap - 1):
        raise ValueError(f"bucket_cap must be a power of two, got {bucket_cap}")
    valid = key != KEY_INVALID
    bid = torch.where(valid, torch.div(key, keys_per_bucket,
                                       rounding_mode="floor"), -1)
    bid = torch.clamp(bid, max=n_buckets - 1).to(torch.int32)  # ceil-split slack
    rank = bin_ranks(bid, n_buckets=n_buckets)
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
