"""SCCP slab-pair structured multiply (paper Fig. 8): CUDA kernel + plain twin.

Replaces ``src/repro/kernels/sccp_multiply.py:_sccp_kernel`` (the Pallas
kernel tiling the lane axis into VMEM blocks). The CUDA kernel is
``csrc/sccp_multiply.cu``: one thread per (c, t) lane of B's plane, walking
A's k_a slabs, so every store is coalesced; the stores are streaming. It is
bound by bytes: it writes the three (k_a, n, k_b) planes, 12 bytes a lane,
and reads each operand once. It masks the ragged edge of ``n`` itself, so no
padding is needed.

``sccp_multiply`` launches the kernel for CUDA tensors and runs
``sccp_multiply_plain`` only for tensors the caller put on the CPU.
``sccp_multiply.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

INVALID = -1
_LIB = "sccp_multiply"

Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def sccp_multiply_plain(a_val: torch.Tensor, a_idx: torch.Tensor,
                        b_val: torch.Tensor, b_idx: torch.Tensor) -> Planes:
    """The kernel's function in torch ops: (val, row, col), each (k_a, n, k_b)."""
    val = a_val[:, :, None] * b_val[None, :, :]
    shape = val.shape
    row = a_idx[:, :, None].expand(shape)
    col = b_idx[None, :, :].expand(shape)
    ok = (row >= 0) & (col >= 0)
    return (torch.where(ok, val, 0), torch.where(ok, row, INVALID),
            torch.where(ok, col, INVALID))


def sccp_multiply(a_val: torch.Tensor, a_idx: torch.Tensor,
                  b_val: torch.Tensor, b_idx: torch.Tensor) -> Planes:
    """All slab-pair products of A (k_a, n) and B (n, k_b)."""
    k_a, n = a_val.shape
    n_b, k_b = b_val.shape
    if n != n_b or a_idx.shape != a_val.shape or b_idx.shape != b_val.shape:
        raise ValueError(f"sccp_multiply: shapes a {tuple(a_val.shape)}/"
                         f"{tuple(a_idx.shape)}, b {tuple(b_val.shape)}/"
                         f"{tuple(b_idx.shape)} do not align")
    devices = {t.device for t in (a_val, a_idx, b_val, b_idx)}
    if len(devices) != 1:
        raise ValueError(f"sccp_multiply: operands on several devices {devices}")
    dev = a_val.device
    if dev.type == "cpu":
        return sccp_multiply_plain(a_val, a_idx, b_val, b_idx)
    if dev.type != "cuda":
        raise ValueError(f"sccp_multiply: no kernel for device {dev}")
    if a_val.dtype != torch.float32 or b_val.dtype != torch.float32:
        raise TypeError("sccp_multiply kernel takes float32 values, got "
                        f"{a_val.dtype}/{b_val.dtype}")
    if a_idx.dtype != torch.int32 or b_idx.dtype != torch.int32:
        raise TypeError("sccp_multiply kernel takes int32 indices, got "
                        f"{a_idx.dtype}/{b_idx.dtype}")
    if not all(t.is_contiguous() for t in (a_val, a_idx, b_val, b_idx)):
        raise ValueError("sccp_multiply kernel takes contiguous planes")
    val = torch.empty((k_a, n, k_b), dtype=torch.float32, device=dev)
    row = torch.empty((k_a, n, k_b), dtype=torch.int32, device=dev)
    col = torch.empty((k_a, n, k_b), dtype=torch.int32, device=dev)
    lib, fns = _build.bind(_LIB, {"sccp_multiply_f32": (
        [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])})
    fn = fns["sccp_multiply_f32"]
    with torch.cuda.device(dev):
        err = fn(a_val.data_ptr(), a_idx.data_ptr(), b_val.data_ptr(),
                 b_idx.data_ptr(), val.data_ptr(), row.data_ptr(),
                 col.data_ptr(), k_a, n, k_b,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, _LIB, err)
    sccp_multiply.launches += 1
    return val, row, col


sccp_multiply.launches = 0
