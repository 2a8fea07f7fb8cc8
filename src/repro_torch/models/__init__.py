"""Model layers of the port, mirroring ``repro.models``:

  params      — ``Spec`` trees, ``init_params``, ``abstract_params``
  common      — norms, RoPE, embeddings, losses
  attention   — GQA (full, windowed, chunked, cached decode, ring decode),
                MLA (full, absorbed decode) and cross-attention
  ffn         — SwiGLU, GELU MLP, ``SparseMLP`` and the MoE layer with the
                ``'ellpack'``, ``'sort'`` and ``'spmm'`` dispatches
  ssm         — the Mamba-1 selective SSM block (falcon-mamba)
  rglru       — the RG-LRU recurrent block (recurrentgemma)
  transformer — segment plans, blocks, decoder forward / prefill / decode
  encdec      — the encoder-decoder (whisper)
  api         — the ``Model`` facade and ``build_model``
  sparse      — ``SparseLinear`` (pruned weights as N:M planes or ELLPACK)
"""
from . import (attention, common, encdec, ffn, params, rglru, sparse, ssm,
               transformer)
from .api import Model, build_model
from .ffn import SparseMLP, moe_apply, swiglu_apply
from .sparse import (SparseLinear, ell_from_pruned, magnitude_prune,
                     magnitude_prune_nm, nm_linear_apply,
                     sparse_linear_apply, sparsify_linear)

__all__ = ["Model", "SparseLinear", "SparseMLP", "attention", "build_model",
           "common", "ell_from_pruned", "encdec", "ffn", "magnitude_prune",
           "magnitude_prune_nm", "moe_apply", "nm_linear_apply", "params",
           "rglru", "sparse", "sparse_linear_apply", "sparsify_linear", "ssm",
           "swiglu_apply", "transformer"]
