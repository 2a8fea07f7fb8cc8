"""SpGEMM planning, ported so far: the symbolic nnz(C) sizing behind
``out_cap="auto"`` (``symbolic``), the pinned-backend ``Plan`` sizing
(``planner``) and the operands' sparsity fingerprint (``structure``)."""
from . import planner, structure, symbolic
from .planner import Plan, make_plan
from .structure import fingerprint
from .symbolic import exact_nnz, out_cap_auto, upper_bound_nnz

__all__ = ["Plan", "exact_nnz", "fingerprint", "make_plan", "out_cap_auto",
           "planner", "structure", "symbolic", "upper_bound_nnz"]
