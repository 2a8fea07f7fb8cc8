"""SPLIM core in PyTorch: the single-device SpGEMM, cold and warm.

  api        — the ``spgemm()`` front door (prefer ``repro_torch.spgemm``)
  formats    — COO / ELLPACK containers, converters, numpy carry-over
  hwmodel    — the paper's analytical PUM latency/energy model (Table II)
               and the planner's ``MatrixStats``
  hybrid     — the hybrid ELLPACK + COO format and its dense-output
               SpGEMM (paper §III-C)
  sccp       — Structured Condensing Computation Paradigm multiply
  accumulate — the sort-and-segment-sum accumulation, overflow contract
  spgemm     — end-to-end spgemm / spmm entry points, the warm numeric
               phase
  streaming  — the slab-group streaming engine ('stream')
  distributed — the sharded SpGEMM on a device mesh: the 'ring', 'cstat'
               and 'summa' schedules, cold, batched and warm
"""
from . import (accumulate, api, distributed, formats, hwmodel, hybrid, sccp,
               spgemm, streaming)
from .accumulate import AccumulatorOverflow, accumulate_checked, check_no_overflow
from .distributed import (ring_spgemm, spgemm_coo_sharded,
                          spgemm_coo_sharded_batched,
                          spgemm_coo_sharded_numeric)
from .formats import (Coo, EllCols, EllRows, coo_from_dense, default_device,
                      ell_cols_from_dense, ell_rows_from_dense, from_numpy,
                      to_numpy)
from .hybrid import (HybridCols, HybridRows, ell_width_rule,
                     hybrid_from_numpy, hybrid_spgemm_dense,
                     split_cols_hybrid, split_rows_hybrid)
from .spgemm import (accumulate_stream, spgemm_coo, spgemm_coo_batched,
                     spgemm_coo_numeric, spgemm_coo_numeric_batched,
                     spgemm_dense, spgemm_dense_batched, spgemm_from_dense,
                     spgemm_streaming, spmm_dense_ell, spmm_ell_dense)
from .streaming import spgemm_coo_stream, spgemm_coo_stream_numeric

__all__ = [
    "accumulate", "api", "distributed", "formats", "hwmodel", "hybrid",
    "sccp", "spgemm", "streaming",
    "HybridCols", "HybridRows", "ell_width_rule", "hybrid_from_numpy",
    "hybrid_spgemm_dense", "split_cols_hybrid", "split_rows_hybrid",
    "AccumulatorOverflow", "accumulate_checked", "check_no_overflow",
    "Coo", "EllCols", "EllRows", "coo_from_dense", "default_device",
    "ell_cols_from_dense", "ell_rows_from_dense", "from_numpy", "to_numpy",
    "accumulate_stream", "ring_spgemm", "spgemm_coo", "spgemm_coo_batched",
    "spgemm_coo_sharded", "spgemm_coo_sharded_batched",
    "spgemm_coo_sharded_numeric",
    "spgemm_coo_numeric", "spgemm_coo_numeric_batched", "spgemm_coo_stream",
    "spgemm_coo_stream_numeric", "spgemm_dense",
    "spgemm_dense_batched", "spgemm_from_dense", "spgemm_streaming",
    "spmm_dense_ell", "spmm_ell_dense",
]
