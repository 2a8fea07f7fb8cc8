"""N:M balanced-sparsity SpMM (K10): CUDA kernel + plain twin.

``Y[t, :] = Σ_r V[r, :] · X[t, M·(r // N) + O[r, :]]`` for the condensed
planes of an N:M weight (``core.nm.NmWeights``: V (R, d_out) float32, O
(R, d_out) int8, R = d_in·N/M).

Replaces ``src/repro/kernels/nm_spmm.py:_nm_spmm_kernel``, which runs M
masked one-hot matmuls a tile on the TPU's matrix unit. The CUDA kernel is
``csrc/nm_spmm.cu``, on the card's matrix unit, the tensor cores: a
(128 tokens × 128 columns) tile a block walks the reduction in K-chunks of
whole windows (``k_chunk``), stages the dense X tile and expands the
chunk's V/O rows into a dense weight tile in shared memory (rows of one
window that share an offset add, offsets outside [0, M) add nothing), and
multiplies them on the FP64 tensor cores (``mma.sync`` m16n8k8 .f64): the
fp32 operands widen exactly, products are exact and the sums run in
double, so each result is rounded once, to fp32. A bfloat16 entry
(``nm_spmm_bf16``: X and V bfloat16) runs the same tiles and pipeline on
the bf16 tensor cores (``mma.sync`` m16n8k16 .bf16, float32 sums: the
reference's accumulator) and rounds each result once, to bfloat16, the
output in ``x.dtype``. Both are bound by the dense-expanded operations
(2·t·d_in·d_out). It masks the ragged token,
column and window edges itself, so the front pads nothing.

``nm_spmm`` checks the shapes and launches the kernel for CUDA tensors; it
runs ``nm_spmm_plain`` (the reference's ``nm_spmm_xla``: M masked products,
accumulated in float32) only for tensors the caller put on the CPU. On the
card X and V must share one dtype, float32 or bfloat16 (``_ENTRIES``);
anything else raises ``TypeError``.
``nm_spmm.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_LIB = "nm_spmm"
X_COLS = 32        # input columns a K-chunk, at most, but whole windows
MMA_K = 8          # the depth of one mma.sync m16n8k8


def k_chunk(m: int) -> tuple[int, int]:
    """``(windows, columns)`` of one K-chunk of the kernel at window width
    ``m``: as many whole windows as fit ``X_COLS`` columns (at least one),
    their ``windows·m`` columns padded with zeros to a multiple of
    ``MMA_K``."""
    if m < 1:
        raise ValueError(f"nm_spmm: window width {m} must be positive")
    windows = max(1, X_COLS // m)
    return windows, -(-windows * m // MMA_K) * MMA_K


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
    if x.dtype not in _ENTRIES or val.dtype != x.dtype:
        raise TypeError("nm_spmm kernel takes float32 or bfloat16 x and "
                        f"values of one dtype, got {x.dtype}/{val.dtype}")
    if off.dtype != torch.int8:
        raise TypeError(f"nm_spmm kernel takes int8 offsets, got {off.dtype}")
    if not all(v.is_contiguous() for v in (x, val, off)):
        raise ValueError("nm_spmm kernel takes contiguous x and planes")
    y = launch(_LIB, x, val, off, n=n, m=m)
    if t and d_out:
        nm_spmm.launches += 1
    return y


_ENTRIES = {torch.float32: "nm_spmm_f32", torch.bfloat16: "nm_spmm_bf16"}
_SIG = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4
        + [ctypes.c_void_p])


def launch(lib_name: str, x: torch.Tensor, val: torch.Tensor,
           off: torch.Tensor, *, n: int, m: int) -> torch.Tensor:
    """Run the entry for ``x.dtype`` (``_ENTRIES``) of the library
    ``lib_name`` on checked CUDA operands: K10 itself, or a probe build of
    its source (``_build.VARIANTS``). Counts nothing; ``nm_spmm`` is the
    wrapper."""
    t, d_in = x.shape
    d_out = val.shape[1]
    dev = x.device
    y = torch.empty((t, d_out), dtype=x.dtype, device=dev)
    lib, fns = _build.bind(lib_name, {e: _SIG for e in _ENTRIES.values()})
    fn = fns[_ENTRIES[x.dtype]]
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), val.data_ptr(), off.data_ptr(), y.data_ptr(),
                 t, d_in, d_out, n, m, *k_chunk(m),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, _LIB, err)
    return y


nm_spmm.launches = 0
