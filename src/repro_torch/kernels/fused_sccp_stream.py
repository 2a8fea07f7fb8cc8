"""One streaming step on Hopper: fused SCCP multiply + (key, value) sort + run
totals (K8), beside its plain torch twin.

Mirrors ``src/repro/kernels/fused_sccp_stream.py``. ``fused_slab_sort``
replaces ``_make_fused_kernel`` (called by ``fused_slab_sort_pallas``): a
block of A slabs ``a`` (n,) or (group, n) times all B slabs ``b`` (n, k_b)
gives the products packed to int32 keys ``a_idx·n_cols + b_idx`` in the
reference's (group, n, k_b) lane order, padded with KEY_INVALID (value 0) to
the next power of two, sorted ascending as one row, and each run's value
total left on its last lane (0 elsewhere). A lane where either index is −1
is KEY_INVALID with value 0. At group 1 this is the reference's
``_pack_tile`` + sort; above it, the lanes its ``streaming._sort_tile``
sorts.

The CUDA kernel is ``csrc/fused_sccp_stream.cu``, a stable LSD radix sort
(``csrc/radix_sort.cuh``, four 8-bit digits) whose first digit forms the
lanes from the operands: above one 4,096-lane tile, the first digit's count
and scatter grids compute each lane's key and product where a sort would
read a stream, so unsorted products never reach device memory; digits 1–3
are the radix library's grids (``radix_sort.sort_rows(first_digit=)``) and
the totals ``bitonic_merge.seg_totals``, 13 grids a step. Only the real
lanes, rounded up to a tile, are sorted; the pad lanes up to ``pot`` are
KEY_INVALID and go straight to the tail. A step of at most one tile is one
grid that forms, sorts and totals it in shared memory. It is bound by
bytes: the operands in, 8 B a padded lane out. The sort is stable, so a
run's values keep their lane order; the totals sum each run from its tail
back, which agrees bit for bit with the plain twin's log-step scan on
integer-valued operands and on runs of at most three lanes (on longer float
runs the two orders round differently).

``fused_slab_sort`` launches the kernel for CUDA tensors (float32 values,
int32 indices) and raises on anything else the kernel does not take; it runs
``fused_slab_sort_plain`` (``_pack_tile`` + the row sort of
``bitonic_merge``) only for tensors the caller put on the CPU.
``fused_slab_sort.launches`` counts kernel grids. Keys must fit int32
(``n_rows·n_cols < 2³¹−1``); callers check that (``streaming._check_packable``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, radix_sort
from .bitonic_merge import _sort_rows_plain, seg_totals
from .insitu_search import KEY_INVALID, next_pot

_LIB = "fused_sccp_stream"
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SLAB = (_P, _P, _P, _P, _L, _L, _L, _L)     # the operands and their shape
_ARGS = {"fused_slab_rows": (_P, _P, _P, _P, _P, _P, _L, _L, _L, _L, _L, _P),
         "fused_slab_upsweep": _SLAB + (_P, _L, _I, _I, _I, _P, _L, _P),
         "fused_slab_downsweep": _SLAB + (_P, _P, _P, _L, _I, _I, _I, _P)}


def _pack_tile(a_val, a_idx, b_val, b_idx, n_cols: int, pot_len: int):
    """Slab products → packed int32 keys + values, flat, padded to
    ``pot_len``. ``a_val``/``a_idx``: (n,) or (group, n); ``b_val``/``b_idx``:
    (n, k_b)."""
    val = a_val[..., :, None] * b_val
    row = a_idx[..., :, None].expand(val.shape)
    ok = (row >= 0) & (b_idx >= 0)
    key = torch.where(ok, row * n_cols + b_idx, KEY_INVALID).to(torch.int32)
    val = torch.where(ok, val, 0).reshape(-1)
    key = key.reshape(-1)
    pad = pot_len - key.numel()
    if pad:
        key = torch.cat([key, key.new_full((pad,), KEY_INVALID)])
        val = torch.cat([val, val.new_zeros(pad)])
    return key, val


def _shapes(a_val, a_idx, b_val, b_idx):
    """(group, n, k_b) of the operands; raises when they do not align."""
    if a_val.dim() not in (1, 2) or a_idx.shape != a_val.shape \
            or b_val.dim() != 2 or b_idx.shape != b_val.shape \
            or a_val.shape[-1] != b_val.shape[0]:
        raise ValueError(
            f"fused_slab_sort: a {tuple(a_val.shape)}/{tuple(a_idx.shape)} "
            f"must be (n,) or (group, n) and b {tuple(b_val.shape)}/"
            f"{tuple(b_idx.shape)} (n, k_b)")
    group = a_val.shape[0] if a_val.dim() == 2 else 1
    return group, b_val.shape[0], b_val.shape[1]


def fused_slab_sort_plain(a_val, a_idx, b_val, b_idx, *, n_cols: int):
    """The kernel's function in torch ops: ``(key, tot)``, each pot lanes."""
    group, n, k_b = _shapes(a_val, a_idx, b_val, b_idx)
    pot = next_pot(group * n * k_b)
    key, val = _pack_tile(a_val, a_idx, b_val, b_idx, n_cols, pot)
    return _sort_rows_plain(key, val, pot)


def fused_slab_sort(a_val, a_idx, b_val, b_idx, *, n_cols: int):
    """Multiply, pack and sort one block of A slabs against all of B:
    ``(key, tot)`` of ``pot(group·n·k_b)`` lanes, ascending keys with
    run-tail totals."""
    group, n, k_b = _shapes(a_val, a_idx, b_val, b_idx)
    devices = {t.device for t in (a_val, a_idx, b_val, b_idx)}
    if len(devices) != 1:
        raise ValueError(f"fused_slab_sort: operands on several devices "
                         f"{devices}")
    (dev,) = devices
    if dev.type == "cpu":
        return fused_slab_sort_plain(a_val, a_idx, b_val, b_idx,
                                     n_cols=n_cols)
    if dev.type != "cuda":
        raise ValueError(f"fused_slab_sort: no kernel for device {dev}")
    if a_val.dtype != torch.float32 or b_val.dtype != torch.float32 \
            or a_idx.dtype != torch.int32 or b_idx.dtype != torch.int32:
        raise TypeError("fused_slab_sort kernel takes float32 values and "
                        f"int32 indices, got {a_val.dtype}/{b_val.dtype} and "
                        f"{a_idx.dtype}/{b_idx.dtype}")
    if not all(t.is_contiguous() for t in (a_val, a_idx, b_val, b_idx)):
        raise ValueError("fused_slab_sort kernel takes contiguous operands")
    lanes = group * n * k_b
    pot = next_pot(lanes)
    if lanes > (1 << 31) - radix_sort.TILE:
        raise ValueError(f"fused_slab_sort kernel counts lanes in 32 bits, "
                         f"got {lanes}")
    key = torch.empty(pot, dtype=torch.int32, device=dev)
    tot = torch.empty(pot, dtype=torch.float32, device=dev)
    slab = (a_val.data_ptr(), a_idx.data_ptr(), b_val.data_ptr(),
            b_idx.data_ptr(), group, n, k_b, n_cols)
    with torch.cuda.device(dev):
        if pot <= radix_sort.TILE:
            lib, fns = _entries()
            err = fns["fused_slab_rows"](
                *slab[:4], key.data_ptr(), tot.data_ptr(), *slab[4:], pot,
                torch.cuda.current_stream(dev).cuda_stream)
            _build.check(lib, _LIB, err)
            fused_slab_sort.launches += 1
            return key, tot
        m = sorted_lanes(lanes)
        v_sorted = torch.empty(m, dtype=torch.float32, device=dev)
        radix_sort.sort_rows(fused_slab_sort, None, None, key[:m], v_sorted,
                             m, v_scratch=tot[:m],
                             first_digit=FirstDigit(slab, key, m))
        seg_totals(fused_slab_sort, key, v_sorted, tot, pot)
    return key, tot


def sorted_lanes(lanes: int) -> int:
    """The lanes K8 sorts above one tile: the real ones rounded up to a
    tile (the rest up to pot are KEY_INVALID, written straight to the
    tail)."""
    return -(-lanes // radix_sort.TILE) * radix_sort.TILE


def _entries() -> tuple[ctypes.CDLL, dict]:
    return _build.bind(_LIB, _ARGS)


class FirstDigit:
    """The first digit pass of K8's sort (``radix_sort.sort_rows``'s
    ``first_digit``): its count and scatter grids form the lanes from the
    operands ``slab`` (the four pointers, group, n, k_b, n_cols); the count
    grid also writes KEY_INVALID to ``key``'s lanes from ``m`` (the sorted
    ones) to its end."""

    def __init__(self, slab, key: torch.Tensor, m: int):
        self.lib, self.fns = _entries()
        self.slab = slab
        self.tail = key[m:]

    def upsweep(self, counts, g, shift, stream) -> None:
        err = self.fns["fused_slab_upsweep"](
            *self.slab, counts.data_ptr(), g.row, g.blocks_per_row,
            g.tiles_per_block, shift, self.tail.data_ptr(),
            self.tail.numel(), stream)
        _build.check(self.lib, _LIB, err)

    def downsweep(self, counts, kd, vd, g, shift, stream) -> None:
        err = self.fns["fused_slab_downsweep"](
            *self.slab, kd.data_ptr(), vd.data_ptr(), counts.data_ptr(),
            g.row, g.blocks_per_row, g.tiles_per_block, shift, stream)
        _build.check(self.lib, _LIB, err)


fused_slab_sort.launches = 0

__all__ = ["KEY_INVALID", "fused_slab_sort", "fused_slab_sort_plain"]
