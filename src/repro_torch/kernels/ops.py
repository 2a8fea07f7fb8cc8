"""Stream packing and the ``'search'`` accumulation over the kernels.

Mirrors ``src/repro/kernels/ops.py``: ``pad_to`` aligns a tensor to a
multiple, ``_packed_stream`` flattens a product stream into packed int32
``row·n_cols + col`` keys padded to a power of two, and ``search_merge`` is
the paper's in-situ-search accumulation (emit the sorted unique keys, align
every product against them, one segment-sum lands the values).
"""
from __future__ import annotations

import torch

from . import insitu_search
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
    packed = _packed_stream(row, col, val, n_rows, n_cols)
    if packed is None:
        _unpackable(n_rows, n_cols)
    key, v = packed
    uk, nnz = insitu_search.emit_sorted_unique(key, out_cap, faithful=faithful)
    slot, hit = insitu_search.align_keys(key, uk)
    ok = (key != KEY_INVALID) & hit
    slot = torch.where(ok, slot, out_cap)
    sums = torch.zeros(out_cap + 1, dtype=v.dtype, device=v.device)
    sums.index_add_(0, slot, torch.where(ok, v, 0))
    return uk, sums[:out_cap], nnz
