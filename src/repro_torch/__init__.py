"""SPLIM reproduction in PyTorch + CUDA for one NVIDIA H100.

The port of ``repro`` (the JAX/Pallas reference, which it never imports).
Its slices so far carry the single-device SpGEMM, cold and warm:

    import repro_torch
    a = repro_torch.ell_rows_from_dense(A, k_a)        # on CUDA by default
    b = repro_torch.ell_cols_from_dense(B, k_b)
    c = repro_torch.spgemm(a, b)                       # 'sort' accumulation
    c = repro_torch.spgemm(a, b, accumulator="search") # the paper's Alg. 1
    c = repro_torch.spgemm(a, b, accumulator="stream") # never materialized
    st = repro_torch.make_structure(a, b, backend="sort")  # symbolic, once
    c = repro_torch.spgemm(a, b, structure=st)         # numeric, each call

Constructors default to ``default_device()`` (CUDA, or an error); pass
``device="cpu"`` to run the kernels' plain torch versions on the CPU. The
CUDA kernels build from ``src/repro_torch/csrc`` on first use.
"""
from .core.accumulate import AccumulatorOverflow, check_no_overflow
from .core.api import spgemm
from .core.formats import (Coo, EllCols, EllRows, coo_from_dense,
                           default_device, ell_cols_from_dense,
                           ell_rows_from_dense, from_numpy,
                           np_ell_cols_from_scipy, np_ell_rows_from_scipy,
                           to_numpy)
from .core.sccp import count_products
from .core.spgemm import spgemm_dense
from .plan import (SpgemmStructure, StructureCache, make_structure,
                   make_structure_batched)

__all__ = [
    "AccumulatorOverflow", "Coo", "EllCols", "EllRows", "SpgemmStructure",
    "StructureCache", "check_no_overflow", "coo_from_dense",
    "count_products", "default_device", "ell_cols_from_dense",
    "ell_rows_from_dense", "from_numpy", "make_structure",
    "make_structure_batched", "np_ell_cols_from_scipy",
    "np_ell_rows_from_scipy", "spgemm", "spgemm_dense", "to_numpy",
]
