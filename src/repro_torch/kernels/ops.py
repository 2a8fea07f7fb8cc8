"""Stream packing and the packed-key accumulations over the kernels.

Mirrors ``src/repro/kernels/ops.py``: ``pad_to`` aligns a tensor to a
multiple, ``_packed_stream`` flattens a product stream into packed int32
``row·n_cols + col`` keys padded to a power of two, ``fused_slab_sort`` forms
and sorts one streaming step's products without a raw stream (K8), and four
accumulations run over a packed stream:

  * ``sort_merge``   — the bitonic merge tree (``'tiled'``);
  * ``search_merge`` — the paper's in-situ search (emit the sorted unique
                       keys, align every product against them, one
                       segment-sum lands the values; ``'search'``);
  * ``bucket_merge`` — propagation blocking by row range (``'bucket'``);
  * ``hash_merge``   — per-row-block open-addressing tables (``'hash'``).

``ell_spmm`` is the ELLPACK × dense SpMM behind MoE's ``'spmm'`` dispatch
(K9).

Coordinate spaces with ``n_rows·n_cols ≥ 2³¹−1`` cannot pack and raise;
``spgemm_coo`` reroutes them to the unpacked two-key ``'sort'``.
"""
from __future__ import annotations

import torch

from . import (ell_spmm as _ell_spmm, fused_sccp_stream, hash_accum,
               insitu_search, radix_bucket)
from .bitonic_merge import sort_merge_tree
from .insitu_search import KEY_INVALID

INVALID = -1


def pad_to(x: torch.Tensor, axis: int, mult: int, fill) -> torch.Tensor:
    """Pad ``x`` along ``axis`` (negative ok) up to a multiple of ``mult``
    with ``fill``."""
    size = x.shape[axis]
    pad = (-size) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_full(shape, fill)], dim=axis)


def _packed_stream(row, col, val, n_rows: int, n_cols: int):
    """Flatten + pack coordinates to int32 keys, padded to a power of two
    with KEY_INVALID (values with 0). ``None`` when the coordinate space
    does not fit packed int32 keys (``n_rows·n_cols ≥ 2³¹−1``)."""
    if n_rows * n_cols >= KEY_INVALID:
        return None
    row = row.reshape(-1)
    col = col.reshape(-1)
    val = val.reshape(-1)
    pot = 1 << (row.shape[0] - 1).bit_length()
    key = torch.where(row >= 0, row * n_cols + col, KEY_INVALID).to(torch.int32)
    key = pad_to(key, 0, pot, KEY_INVALID)[:pot]
    val = pad_to(val, 0, pot, 0.0)[:pot]
    return key, val


def _unpackable(n_rows: int, n_cols: int):
    raise ValueError(
        f"coordinate space {n_rows}x{n_cols} exceeds packed int32 keys; "
        "use the unpacked two-key path (core.accumulate / "
        "spgemm_coo(accumulator='sort')) — spgemm_coo routes there "
        "automatically")


def _packed_or_raise(row, col, val, n_rows: int, n_cols: int):
    packed = _packed_stream(row, col, val, n_rows, n_cols)
    if packed is None:
        _unpackable(n_rows, n_cols)
    return packed


def fused_slab_sort(a_val, a_idx, b_val, b_idx, *, n_cols: int):
    """One streaming step: a block of A slabs times all of B → sorted packed
    keys + run-tail totals (K8, ``fused_sccp_stream.fused_slab_sort``; its
    plain twin for CPU operands). Coordinate spaces ≥ 2³¹−1 cannot pack;
    the streaming engine refuses them before it gets here."""
    return fused_sccp_stream.fused_slab_sort(a_val, a_idx, b_val, b_idx,
                                             n_cols=n_cols)


def sort_merge(row, col, val, n_rows: int, n_cols: int, *, tile: int = 4096):
    """Coalesce duplicate coordinates: sorted packed keys + run-tail totals.
    A stream of at most one ``tile`` is one bitonic network; a larger one is
    tile-sorted and merged up the tree (``bitonic_merge.sort_merge_tree``)."""
    key, val = _packed_or_raise(row, col, val, n_rows, n_cols)
    return sort_merge_tree(key, val, tile=tile)


def search_merge(row, col, val, n_rows: int, n_cols: int, *,
                 out_cap: int, faithful: bool = False):
    """The paper's in-situ-search accumulation (Alg. 1 / Fig. 11).

    ``insitu_search.emit_sorted_unique`` produces the sorted unique keys
    (the emission sort, or the literal iterated Alg. 1 scan with
    ``faithful=True``) and ``insitu_search.align_keys`` locates each
    product's slot in that list; the values are never sorted. Returns
    ``(uk, sums, nnz)``: the (out_cap,) sorted unique keys with KEY_INVALID
    padding, the per-slot value totals, and the TRUE unique count
    (``nnz > out_cap`` flags truncation; the kept slots are the first
    ``out_cap`` unique keys). Coordinate spaces ≥ 2³¹−1 raise.
    """
    key, v = _packed_or_raise(row, col, val, n_rows, n_cols)
    uk, nnz = insitu_search.emit_sorted_unique(key, out_cap, faithful=faithful)
    slot, hit = insitu_search.align_keys(key, uk)
    ok = (key != KEY_INVALID) & hit
    slot = torch.where(ok, slot, out_cap)
    sums = torch.zeros(out_cap + 1, dtype=v.dtype, device=v.device)
    sums.index_add_(0, slot, torch.where(ok, v, 0))
    return uk, sums[:out_cap], nnz


def bucket_merge(row, col, val, n_rows: int, n_cols: int, *,
                 n_buckets: int | None = None, bucket_cap: int | None = None):
    """Propagation-blocking coalesce: bin by row range, sort each bucket.

    Returns ``(key_sorted, totals, dropped)``: the ``sort_merge`` contract
    plus the count of products lost to full buckets (0 when ``bucket_cap``
    comes from ``plan.make_plan``). With neither size given the stream is
    ONE stream-sized bucket; ``n_buckets`` alone makes every bucket
    stream-sized (n_buckets× the stream), ``bucket_cap`` alone takes 8.
    """
    if n_buckets is None and bucket_cap is None:
        n_buckets = 1
    n_buckets = n_buckets or 8
    key, val = _packed_or_raise(row, col, val, n_rows, n_cols)
    return radix_bucket.bucket_merge(
        key, val, n_buckets=n_buckets, bucket_cap=bucket_cap or key.numel(),
        keys_per_bucket=radix_bucket.bucket_bounds(n_rows, n_cols, n_buckets))


def hash_merge(row, col, val, n_rows: int, n_cols: int, *,
               n_blocks: int | None = None, block_cap: int | None = None,
               max_probes: int | None = None):
    """Hash-accumulate into per-row-block open-addressing tables.

    Returns ``(key_sorted, totals, dropped)``: the sorted tables, not the
    stream, so the bitonic pass is table-sized; ``dropped`` counts probe or
    table exhaustion (0 with ``plan.make_plan``'s ``block_cap``). With
    neither size given the stream gets ONE stream-sized table; ``n_blocks``
    alone makes every table stream-sized, ``block_cap`` alone takes 8.
    """
    if n_blocks is None and block_cap is None:
        n_blocks = 1
    n_blocks = n_blocks or 8
    key, val = _packed_or_raise(row, col, val, n_rows, n_cols)
    return hash_accum.hash_merge(
        key, val, n_blocks=n_blocks, block_cap=block_cap or key.numel(),
        keys_per_block=radix_bucket.bucket_bounds(n_rows, n_cols, n_blocks),
        max_probes=max_probes)


def ell_spmm(a_val, a_idx, x, n_rows: int):
    """A (row-wise ELLPACK planes) @ X → (n_rows, d) in ``x.dtype`` (K9,
    ``ell_spmm.ell_spmm``; its plain twin for CPU operands). The kernel
    masks the ragged edges itself, so nothing is padded and X is not cut
    into the reference's 512-wide chunks."""
    return _ell_spmm.ell_spmm(a_val, a_idx, x, n_rows)
