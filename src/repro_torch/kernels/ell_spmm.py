"""ELLPACK-rows × dense SpMM (K9): CUDA kernel + plain twin.

``C[r, :] = Σ_{s,c : idx[s,c] == r} val[s,c] · X[c, :]``, lanes with index
−1 adding nothing. This is the SCCP multiply with a structured output, the
product behind MoE's ``'spmm'`` dispatch and combine.

Replaces ``src/repro/kernels/ell_spmm.py:_ell_spmm_kernel`` (one-hot tiles on
the TPU's matrix unit, which has no scatter). The CUDA kernel is
``csrc/ell_spmm.cu``: one warp per column of A reads X's row once with
16-byte loads and scatter-adds it into each slot's output row with vector
atomics. It is bound by bytes: the planes (8 a lane), X read once and C
written once. The atomics make float sums order-dependent (bit-identical to
the plain twin on integer-valued operands only); the source says why atomics
and not a CSR transpose.

``ell_spmm`` launches the kernel for CUDA tensors and runs ``ell_spmm_plain``
(the reference oracle ``kernels/ref.py:ell_spmm_ref``, i.e.
``core.spgemm.spmm_ell_dense``) only for tensors the caller put on the CPU.
``ell_spmm.launches`` counts kernel launches. Indices must lie in
[−1, n_rows).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_LIB = "ell_spmm"


def ell_spmm_plain(a_val: torch.Tensor, a_idx: torch.Tensor, x: torch.Tensor,
                   n_rows: int) -> torch.Tensor:
    """The kernel's function in torch ops: a segment sum of every lane's
    ``val·X[c, :]`` by row index, in ``x.dtype``."""
    from ..core.formats import EllRows
    from ..core.spgemm import spmm_ell_dense
    return spmm_ell_dense(EllRows(val=a_val, idx=a_idx, n_rows=n_rows),
                          x).to(x.dtype)


def ell_spmm(a_val: torch.Tensor, a_idx: torch.Tensor, x: torch.Tensor,
             n_rows: int) -> torch.Tensor:
    """A (row-wise ELLPACK planes, (k, n)) @ X (n, d) → (n_rows, d)."""
    k, n = a_val.shape
    if a_idx.shape != a_val.shape or x.dim() != 2 or x.shape[0] != n:
        raise ValueError(f"ell_spmm: planes {tuple(a_val.shape)}/"
                         f"{tuple(a_idx.shape)} and x {tuple(x.shape)} do "
                         "not align")
    devices = {t.device for t in (a_val, a_idx, x)}
    if len(devices) != 1:
        raise ValueError(f"ell_spmm: operands on several devices {devices}")
    dev = x.device
    if dev.type == "cpu":
        return ell_spmm_plain(a_val, a_idx, x, n_rows)
    if dev.type != "cuda":
        raise ValueError(f"ell_spmm: no kernel for device {dev}")
    if a_val.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("ell_spmm kernel takes float32 values and x, got "
                        f"{a_val.dtype}/{x.dtype}")
    if a_idx.dtype != torch.int32:
        raise TypeError(f"ell_spmm kernel takes int32 indices, got "
                        f"{a_idx.dtype}")
    if not all(t.is_contiguous() for t in (a_val, a_idx, x)):
        raise ValueError("ell_spmm kernel takes contiguous planes and x")
    d = x.shape[1]
    out = torch.empty((n_rows, d), dtype=torch.float32, device=dev)
    lib = _build.library(_LIB)
    fn = lib.ell_spmm_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(a_val.data_ptr(), a_idx.data_ptr(), x.data_ptr(),
                 out.data_ptr(), k, n, d, n_rows,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, _LIB, err)
    if k and n and d and n_rows:
        ell_spmm.launches += 1
    return out


ell_spmm.launches = 0
