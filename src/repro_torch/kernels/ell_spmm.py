"""ELLPACK-rows × dense SpMM (K9): CUDA kernel + plain twin.

``C[r, :] = Σ_{s,c : idx[s,c] == r} val[s,c] · X[c, :]``, lanes with index
−1 adding nothing. This is the SCCP multiply with a structured output, the
product behind MoE's ``'spmm'`` dispatch and combine.

Replaces ``src/repro/kernels/ell_spmm.py:_ell_spmm_kernel`` (one-hot tiles on
the TPU's matrix unit, which has no scatter). The CUDA kernel is
``csrc/ell_spmm.cu``, a CSR transpose and a gather: the k·n lane ids are
sorted stably by their row (the LSD radix sort of ``csrc/radix_sort.cuh``
over the digits ``n_rows`` needs, ``transpose_passes``), each row's first
sorted lane found, and one warp a row of C sums its sources in lane order
in registers and writes the row once: no memset of C, no atomics on it.
It is bound by bytes: the planes (4 bytes an index and the value's
bytes a lane), X read at the columns with a valid lane and C written once.
Each term is one rounded product and one rounded add in lane order, the
order of the plain twin's ``index_add_`` on the CPU, so results are
deterministic; on the card the twin sums with atomics in another order, so
float operands agree within float32 summation order (integer-valued ones
bit for bit).

Two dtypes: float32 (``ell_spmm_f32``) and bfloat16 (``ell_spmm_bf16``:
``val`` and ``x`` bfloat16, each row summed in float32 registers and
rounded to bfloat16 once, to nearest even), the reference's float32
accumulator with its output in ``x.dtype``. The plain twin sums in float32
and casts to ``x.dtype`` too. Any other dtype pair raises ``TypeError`` on
the card.

``ell_spmm`` launches the kernel for CUDA tensors and runs ``ell_spmm_plain``
(the reference oracle ``kernels/ref.py:ell_spmm_ref``, i.e.
``core.spgemm.spmm_ell_dense``) only for tensors the caller put on the CPU.
``ell_spmm.launches`` counts its grids (``grids``). Indices must lie in
[−1, n_rows).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_LIB = "ell_spmm"
TILE = 4096                    # lanes one block of the transpose sorts
BITS = 8                       # a radix digit


def transpose_passes(n_rows: int) -> int:
    """8-bit digits the transpose sorts: enough that every row index
    ``< n_rows`` orders before the all-ones digits of an invalid lane."""
    p = 1
    while p < 32 // BITS and n_rows >= 1 << (BITS * p):
        p += 1
    return p


def sorted_lanes(lanes: int) -> int:
    """Lanes of the transpose's sorted buffers: ``lanes`` up to one tile,
    else rounded up to a tile."""
    return lanes if lanes <= TILE else -(-lanes // TILE) * TILE


def grids(k: int, n: int, n_rows: int, d: int) -> int:
    """Grids one ``ell_spmm`` call launches: the transpose (one grid up to
    a tile, else count, scan and scatter a digit; none without lanes), the
    row bounds and the gather; none for an empty C."""
    if not (d and n_rows):
        return 0
    lanes = k * n
    sort = 0 if lanes == 0 else 1 if lanes <= TILE \
        else 3 * transpose_passes(n_rows)
    return sort + 2


def scratch_ints(k: int, n: int, n_rows: int) -> int:
    """int32 scratch of one call: two key and two lane-id buffers, the
    radix counts and the row bounds."""
    s = sorted_lanes(k * n)
    return 4 * s + (s // TILE + 1) * (1 << BITS) + n_rows + 1


def ell_spmm_plain(a_val: torch.Tensor, a_idx: torch.Tensor, x: torch.Tensor,
                   n_rows: int) -> torch.Tensor:
    """The kernel's function in torch ops: a segment sum of every lane's
    ``val·X[c, :]`` by row index in float32 (float64 stays float64), cast to
    ``x.dtype``."""
    from ..core.formats import EllRows
    from ..core.spgemm import spmm_ell_dense
    acc = torch.promote_types(torch.float32, x.dtype)
    return spmm_ell_dense(EllRows(val=a_val.to(acc), idx=a_idx,
                                  n_rows=n_rows), x.to(acc)).to(x.dtype)


_ENTRIES = {torch.float32: "ell_spmm_f32", torch.bfloat16: "ell_spmm_bf16"}


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
    entry = _ENTRIES.get(x.dtype)
    if entry is None or a_val.dtype != x.dtype:
        raise TypeError("ell_spmm kernel takes float32 or bfloat16 values "
                        f"and x of one dtype, got {a_val.dtype}/{x.dtype}")
    if a_idx.dtype != torch.int32:
        raise TypeError(f"ell_spmm kernel takes int32 indices, got "
                        f"{a_idx.dtype}")
    if not all(t.is_contiguous() for t in (a_val, a_idx, x)):
        raise ValueError("ell_spmm kernel takes contiguous planes and x")
    if k * n >= 1 << 31:
        raise ValueError(f"ell_spmm kernel: {k}x{n} lanes exceed int32 ids")
    d = x.shape[1]
    out = torch.empty((n_rows, d), dtype=x.dtype, device=dev)
    scratch = torch.empty(scratch_ints(k, n, n_rows), dtype=torch.int32,
                          device=dev)
    sig = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 5
           + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    lib, fns = _build.bind(_LIB, {name: sig for name in _ENTRIES.values()})
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = fns[entry](
            a_val.data_ptr(), a_idx.data_ptr(), x.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), scratch.numel(), k, n, d, n_rows,
            ctypes.byref(launched),
            torch.cuda.current_stream(dev).cuda_stream)
    ell_spmm.launches += launched.value
    _build.check(lib, _LIB, err)
    return out


ell_spmm.launches = 0
