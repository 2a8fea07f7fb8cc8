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
(K9), differentiable (``EllSpmm``).

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


def align_products(key, uk, row, n_rows: int, n_cols: int):
    """K3 on the packed keys ``key`` of a product stream: ``(slot, hit)``
    against the ascending unique keys ``uk``. Where ``row`` is SCCP's
    (k_a, n, k_b) row plane, ``insitu_search.align_product_keys`` groups the
    work by row of C, each (s, c) group's row being its lane t = 0 (its
    first B slot, valid first under ELLPACK; a group whose first lane is
    dead has row −1, and its lanes are searched in device memory, with the
    same answer). Any other stream, one without B slots, or one the grouped
    kernel does not take (``insitu_search.grouped_fits``: 2³¹ keys or
    unique keys or more) takes the flat ``align_keys``."""
    if row.dim() != 3 or row.shape[2] == 0 or not insitu_search.grouped_fits(
            key.numel(), uk.numel(), n_rows):
        return insitu_search.align_keys(key, uk)
    group_row = row[:, :, 0].contiguous().to(torch.int32)
    return insitu_search.align_product_keys(key, uk, group_row,
                                            k_b=row.shape[2], n_rows=n_rows,
                                            n_cols=n_cols)


def search_merge(row, col, val, n_rows: int, n_cols: int, *,
                 out_cap: int, faithful: bool = False):
    """The paper's in-situ-search accumulation (Alg. 1 / Fig. 11).

    ``insitu_search.emit_sorted_unique`` produces the sorted unique keys
    (the emission sort, or the literal iterated Alg. 1 scan with
    ``faithful=True``) and K3 (``align_products``) locates each product's
    slot in that list; the values are never sorted. Returns
    ``(uk, sums, nnz)``: the (out_cap,) sorted unique keys with KEY_INVALID
    padding, the per-slot value totals, and the TRUE unique count
    (``nnz > out_cap`` flags truncation; the kept slots are the first
    ``out_cap`` unique keys). Coordinate spaces ≥ 2³¹−1 raise.
    """
    key, v = _packed_or_raise(row, col, val, n_rows, n_cols)
    uk, nnz = insitu_search.emit_sorted_unique(key, out_cap, faithful=faithful)
    slot, hit = align_products(key, uk, row, n_rows, n_cols)
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


class EllSpmm(torch.autograd.Function):
    """``Y = A·X`` for row-wise ELLPACK planes under autograd. The forward is
    K9 on CUDA tensors and its plain twin on CPU tensors
    (``ell_spmm.ell_spmm``); the backward is written once in torch ops,
    as the reference leaves its gradient to XLA's autodiff of
    ``spmm_ell_dense``. With dead lanes (index < 0) adding nothing:

      dX[c]      = Σ_s val[s, c] · dY[idx[s, c]]
      dval[s, c] = ⟨dY[idx[s, c]], X[c]⟩

    and ``idx`` gets none. Both are computed in float32 (float64 stays
    float64), one slab ``s`` at a time in slab order, and returned in their
    input's dtype."""

    @staticmethod
    def forward(ctx, a_val, a_idx, x, n_rows: int):
        ctx.save_for_backward(a_val, a_idx, x)
        return _ell_spmm.ell_spmm(a_val, a_idx, x, n_rows)

    @staticmethod
    def backward(ctx, dy):
        a_val, a_idx, x = ctx.saved_tensors
        need_val, _, need_x, _ = ctx.needs_input_grad
        acc = torch.promote_types(torch.float32, x.dtype)
        dy = dy.to(acc)
        live = a_idx >= 0
        rows = torch.where(live, a_idx, 0).long()
        val = torch.where(live, a_val.to(acc), 0)
        dx = torch.zeros(x.shape, dtype=acc, device=x.device) \
            if need_x else None
        dval = torch.zeros(a_val.shape, dtype=acc, device=x.device) \
            if need_val else None
        xa = x.to(acc) if need_val else None
        for s in range(a_val.shape[0]):
            g = dy[rows[s]]                                   # (n, d)
            if need_x:
                dx += val[s, :, None] * g
            if need_val:
                dval[s] = torch.where(live[s], (g * xa).sum(-1), 0)
            del g
        return (None if dval is None else dval.to(a_val.dtype), None,
                None if dx is None else dx.to(x.dtype), None)


def ell_spmm(a_val, a_idx, x, n_rows: int):
    """A (row-wise ELLPACK planes) @ X → (n_rows, d) in ``x.dtype`` (K9,
    ``ell_spmm.ell_spmm``; its plain twin for CPU and meta operands), differentiable
    in ``a_val`` and ``x`` (``EllSpmm``). The kernel masks the ragged edges
    itself, so nothing is padded and X is not cut into the reference's
    512-wide chunks."""
    if torch.is_grad_enabled() and (a_val.requires_grad or x.requires_grad):
        return EllSpmm.apply(a_val, a_idx, x, n_rows)
    return _ell_spmm.ell_spmm(a_val, a_idx, x, n_rows)
