"""SpGEMM planning: the symbolic nnz(C) sizing behind ``out_cap="auto"``
(``symbolic``), ``Plan`` sizing and backend selection (``planner``: the
cost model in per-device units, behind ``accumulator='auto'``; and
``make_dist_plan``, a ``DistPlan`` across a mesh axis), the symbolic
phase as a frozen ``SpgemmStructure`` with the operands' sparsity
fingerprint (``structure``), the fingerprint-keyed ``StructureCache`` with
its measured autotune (``cache``), and the SpMM format choice
(``planner.plan_spmm_format``)."""
from . import cache, planner, structure, symbolic
from .cache import StructureCache
from .planner import (BACKENDS, SCHEDULES, DistPlan, Plan, make_dist_plan,
                      make_plan, plan_spmm_format)
from .structure import (SpgemmStructure, fingerprint, make_structure,
                        make_structure_batched)
from .symbolic import (exact_nnz, out_cap_auto, per_block_nnz,
                       per_shard_products, upper_bound_nnz)

__all__ = ["BACKENDS", "DistPlan", "Plan", "SCHEDULES", "SpgemmStructure",
           "StructureCache", "cache", "exact_nnz", "fingerprint",
           "make_dist_plan", "make_plan", "make_structure",
           "make_structure_batched", "out_cap_auto", "per_block_nnz",
           "per_shard_products", "plan_spmm_format", "planner", "structure",
           "symbolic", "upper_bound_nnz"]
