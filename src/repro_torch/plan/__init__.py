"""SpGEMM planning, ported so far: the symbolic nnz(C) sizing behind
``out_cap="auto"`` (``symbolic``)."""
from . import symbolic
from .symbolic import exact_nnz, out_cap_auto, upper_bound_nnz

__all__ = ["exact_nnz", "out_cap_auto", "symbolic", "upper_bound_nnz"]
