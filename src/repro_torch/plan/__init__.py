"""SpGEMM planning, ported so far: the symbolic nnz(C) sizing behind
``out_cap="auto"`` (``symbolic``), the pinned-backend ``Plan`` sizing
(``planner``), the symbolic phase as a frozen ``SpgemmStructure`` with the
operands' sparsity fingerprint (``structure``), the fingerprint-keyed
``StructureCache`` (``cache``), and the SpMM format choice
(``planner.plan_spmm_format``)."""
from . import cache, planner, structure, symbolic
from .cache import StructureCache
from .planner import Plan, make_plan, plan_spmm_format
from .structure import (SpgemmStructure, fingerprint, make_structure,
                        make_structure_batched)
from .symbolic import exact_nnz, out_cap_auto, upper_bound_nnz

__all__ = ["Plan", "SpgemmStructure", "StructureCache", "cache",
           "exact_nnz", "fingerprint", "make_plan", "make_structure",
           "make_structure_batched", "out_cap_auto", "plan_spmm_format",
           "planner", "structure", "symbolic", "upper_bound_nnz"]
