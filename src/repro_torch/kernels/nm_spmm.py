"""N:M balanced-sparsity SpMM (K10): CUDA kernel + plain twin.

``Y[t, :] = Σ_r V[r, :] · X[t, M·(r // N) + O[r, :]]`` for the condensed
planes of an N:M weight (``core.nm.NmWeights``: V (R, d_out) float32, O
(R, d_out) int8, R = d_in·N/M).

Replaces ``src/repro/kernels/nm_spmm.py:_nm_spmm_kernel``, which runs M
masked one-hot matmuls a tile because the TPU's matrix unit cannot gather.
The CUDA kernel is ``csrc/nm_spmm.cu``: nmSPARSE's conflict-free form, a
(128 tokens × 128 columns) tile a block, the chunk's X columns and V/O rows
staged in shared memory, a 16 × 4 register tile a thread, fp32 FMA on the
CUDA cores. It does only the condensed products and is bound by them
(2·t·R·d_out operations). It masks the ragged token, column and window
edges itself, so the front pads nothing.

``nm_spmm`` checks the shapes and launches the kernel for CUDA tensors; it
runs ``nm_spmm_plain`` (the reference's ``nm_spmm_xla``: M masked products,
accumulated in float32) only for tensors the caller put on the CPU.
``nm_spmm.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_LIB = "nm_spmm"


def nm_spmm_plain(x: torch.Tensor, val: torch.Tensor, off: torch.Tensor, *,
                  n: int, m: int) -> torch.Tensor:
    """The masked-product sum of ``nm_spmm_xla``: for each offset s < M, X's
    window column s (repeated N× to line up with the condensed rows) times
    ``where(O == s, V, 0)``, accumulated in float32, returned in
    ``x.dtype``."""
    t, d_in = x.shape
    r, d_out = val.shape
    windows = d_in // m
    xw = x.reshape(t, windows, m)
    off32 = off.to(torch.int32)
    acc = torch.zeros((t, d_out), dtype=torch.float32, device=x.device)
    for s in range(m):
        xs = xw[:, :, s, None].expand(t, windows, n).reshape(t, r)
        vs = torch.where(off32 == s, val.to(torch.float32), 0.0)
        acc = acc + xs.to(torch.float32) @ vs
    return acc.to(x.dtype)


def nm_spmm(x: torch.Tensor, val: torch.Tensor, off: torch.Tensor, *,
            n: int, m: int) -> torch.Tensor:
    """Y = X @ W for an N:M-condensed W, X (t, d_in) → (t, d_out)."""
    t, d_in = x.shape
    r, d_out = val.shape
    if d_in * n != r * m or d_in % m:
        raise ValueError(f"condensed rows {r} != d_in*N/M = {d_in}*{n}/{m}")
    if off.shape != val.shape:
        raise ValueError(f"nm_spmm: offsets {tuple(off.shape)} vs values "
                         f"{tuple(val.shape)}")
    devices = {v.device for v in (x, val, off)}
    if len(devices) != 1:
        raise ValueError(f"nm_spmm: operands on several devices {devices}")
    dev = x.device
    if dev.type == "cpu":
        return nm_spmm_plain(x, val, off, n=n, m=m)
    if dev.type != "cuda":
        raise ValueError(f"nm_spmm: no kernel for device {dev}")
    if x.dtype != torch.float32 or val.dtype != torch.float32:
        raise TypeError("nm_spmm kernel takes float32 x and values, got "
                        f"{x.dtype}/{val.dtype}")
    if off.dtype != torch.int8:
        raise TypeError(f"nm_spmm kernel takes int8 offsets, got {off.dtype}")
    if not all(v.is_contiguous() for v in (x, val, off)):
        raise ValueError("nm_spmm kernel takes contiguous x and planes")
    y = launch(_LIB, x, val, off, n=n, m=m)
    if t and d_out:
        nm_spmm.launches += 1
    return y


def launch(lib_name: str, x: torch.Tensor, val: torch.Tensor,
           off: torch.Tensor, *, n: int, m: int) -> torch.Tensor:
    """Run ``nm_spmm_f32`` of the library ``lib_name`` on checked CUDA
    operands: K10 itself, or a probe build of its source
    (``_build.VARIANTS``). Counts nothing; ``nm_spmm`` is the wrapper."""
    t, d_in = x.shape
    d_out = val.shape[1]
    dev = x.device
    y = torch.empty((t, d_out), dtype=torch.float32, device=dev)
    lib = _build.library(lib_name)
    fn = lib.nm_spmm_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), val.data_ptr(), off.data_ptr(), y.data_ptr(),
                 t, d_in, d_out, n, m,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, _LIB, err)
    return y


nm_spmm.launches = 0
