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

and the SpMM side: pruned weights as N:M planes or ELLPACK, and the MoE
layer whose top-k routing is a row-wise ELLPACK matrix:

    lyr = repro_torch.SparseLinear(w, 0.5, nm=(2, 4))  # K10 on x @ W
    mlp = repro_torch.SparseMLP(w_in, w_out, 0.5, nm=(2, 4))
    y, aux = repro_torch.moe_apply(p, x, cfg, torch.float32)  # K9 twice

Constructors default to ``default_device()`` (CUDA, or an error); pass
``device="cpu"`` to run the kernels' plain torch versions on the CPU. The
CUDA kernels build from ``src/repro_torch/csrc`` on first use.
"""
from .core.accumulate import AccumulatorOverflow, check_no_overflow
from .core.api import spgemm
from .core.formats import (Coo, EllCols, EllRows, coo_from_dense,
                           default_device, ell_cols_from_dense,
                           ell_rows_from_dense, from_numpy, nm_from_numpy,
                           np_ell_cols_from_scipy, np_ell_rows_from_scipy,
                           params_from_numpy, to_numpy)
from .core.nm import NmWeights, detect_nm, nm_from_dense
from .core.sccp import count_products
from .core.spgemm import spgemm_dense
from .models import SparseLinear, SparseMLP, moe_apply
from .plan import (SpgemmStructure, StructureCache, make_structure,
                   make_structure_batched, plan_spmm_format)

__all__ = [
    "AccumulatorOverflow", "Coo", "EllCols", "EllRows", "NmWeights",
    "SparseLinear", "SparseMLP", "SpgemmStructure", "StructureCache",
    "check_no_overflow", "coo_from_dense", "count_products",
    "default_device", "detect_nm", "ell_cols_from_dense",
    "ell_rows_from_dense", "from_numpy", "make_structure",
    "make_structure_batched", "moe_apply", "nm_from_dense", "nm_from_numpy",
    "np_ell_cols_from_scipy", "np_ell_rows_from_scipy", "params_from_numpy",
    "plan_spmm_format", "spgemm", "spgemm_dense", "to_numpy",
]
