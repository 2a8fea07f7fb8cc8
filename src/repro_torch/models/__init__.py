"""Model layers of the port, so far the SpMM slice's:

  sparse — ``SparseLinear`` (pruned weights as N:M planes or ELLPACK), the
           prunes and the apply functions
  ffn    — ``SparseMLP``, SwiGLU and the MoE layer with ``dispatch='spmm'``
"""
from . import ffn, sparse
from .ffn import SparseMLP, moe_apply, swiglu_apply
from .sparse import (SparseLinear, ell_from_pruned, magnitude_prune,
                     magnitude_prune_nm, nm_linear_apply,
                     sparse_linear_apply, sparsify_linear)

__all__ = ["SparseLinear", "SparseMLP", "ell_from_pruned", "ffn",
           "magnitude_prune", "magnitude_prune_nm", "moe_apply",
           "nm_linear_apply", "sparse", "sparse_linear_apply",
           "sparsify_linear", "swiglu_apply"]
