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

The CUDA kernel is ``csrc/fused_sccp_stream.cu``: its first grid forms each
4,096-pair shared-memory tile's products in place and sorts every stage below
the tile there, so unsorted products never reach device memory; the larger
strides and the totals are K5's grids (``csrc/bitonic_net.cuh``). It is
bound by bytes: the operands in, 8 B a padded lane out.

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

from . import _build
from .bitonic_merge import _sort_rows_plain
from .insitu_search import KEY_INVALID, next_pot

_LIB = "fused_sccp_stream"


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
    pot = next_pot(group * n * k_b)
    key = torch.empty(pot, dtype=torch.int32, device=dev)
    v_sorted = torch.empty(pot, dtype=torch.float32, device=dev)
    tot = torch.empty(pot, dtype=torch.float32, device=dev)
    lib = _build.library(_LIB)
    fn = lib.fused_slab_sort_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 5 \
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    grids = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = fn(a_val.data_ptr(), a_idx.data_ptr(), b_val.data_ptr(),
                 b_idx.data_ptr(), key.data_ptr(), v_sorted.data_ptr(),
                 tot.data_ptr(), group, n, k_b, n_cols, pot,
                 ctypes.byref(grids), torch.cuda.current_stream(dev).cuda_stream)
    fused_slab_sort.launches += grids.value
    _build.check(lib, _LIB, err)
    return key, tot


fused_slab_sort.launches = 0

__all__ = ["KEY_INVALID", "fused_slab_sort", "fused_slab_sort_plain"]
