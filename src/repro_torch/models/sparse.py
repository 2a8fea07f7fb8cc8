"""SparseLinear — pruned weight matrices stored and applied in SPLIM formats,
mirroring ``src/repro/models/sparse.py``.

A magnitude-pruned weight is condensed column-wise (the weight is the
*right* operand of ``x @ W``) into ELLPACK with the NNZ-a + σ hybrid rule,
or into N:M condensed planes when its pattern is balanced. The ELLPACK apply
is ``spmm_dense_ell`` (per-slab gather and ``index_add_``, as the reference
runs it off the TPU, no kernel); the N:M apply is K10
(``kernels/nm_spmm.py``). Pruning and condensing are one-time operations on
the weight's device; the apply follows the activations' device.
"""
from __future__ import annotations

import math

import torch

from ..core.formats import EllCols, as_tensor, ell_cols_from_dense
from ..core.nm import NmWeights, nm_from_dense
from ..core.spgemm import spmm_dense_ell
from ..kernels.nm_spmm import nm_spmm


def magnitude_prune(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Zero out the smallest-|w| fraction (global threshold)."""
    k = int(w.numel() * (1.0 - sparsity))
    if k <= 0:
        return torch.zeros_like(w)
    thresh = torch.sort(w.abs().reshape(-1)).values[-k]
    return torch.where(w.abs() >= thresh, w, 0)


def magnitude_prune_nm(w: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Keep the N largest-|w| entries of every M-window along d_in.

    The mask is *exactly* N-in-M balanced per window per column (ties break
    toward the earlier position), which routes the layer onto K10 through
    ``core.nm.NmWeights``.
    """
    d_in, d_out = w.shape
    if d_in % m:
        raise ValueError(f"d_in={d_in} not a multiple of M={m}")
    if not 0 < n <= m:
        raise ValueError(f"need 0 < N <= M, got {n}:{m}")
    aw = w.abs().reshape(d_in // m, m, d_out)
    order = torch.argsort(-aw, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)   # rank of each slot
    mask = (rank < n).reshape(d_in, d_out)
    return torch.where(mask, w, 0)


def sparsify_linear(w: torch.Tensor, sparsity: float) -> EllCols:
    """Dense (d_in, d_out) weight → pruned column-wise ELLPACK. The slab
    width is ceil(mean + σ) of the per-row non-zeros, σ with ddof 0 in
    float32 as ``jnp.std`` takes it; entries beyond it are dropped."""
    wp = magnitude_prune(w, sparsity)
    nnz_per_row = (wp != 0).sum(dim=1).to(torch.float32)
    k = int(math.ceil(float(nnz_per_row.mean()
                            + nnz_per_row.std(correction=0))))
    k = max(1, min(k, w.shape[1]))
    return ell_cols_from_dense(wp, k, device=wp.device)


def ell_from_pruned(wp: torch.Tensor) -> EllCols:
    """Lossless column-wise ELLPACK of an already-pruned weight (k = the
    widest row), so it holds exactly the matrix of the N:M planes: the
    bit-identity between the two routes rests on it."""
    k = max(1, int((wp != 0).sum(dim=1).max()))
    return ell_cols_from_dense(wp, k, device=wp.device)


def sparse_linear_apply(x: torch.Tensor, w_ell: EllCols) -> torch.Tensor:
    """y = x @ W_sparse with x (..., d_in). Materializes (tokens, d_in·k)
    products, so keep the token count small on wide layers."""
    lead = x.shape[:-1]
    y = spmm_dense_ell(x.reshape(-1, x.shape[-1]), w_ell)
    return y.reshape(*lead, -1)


def nm_linear_apply(x: torch.Tensor, w_nm: NmWeights) -> torch.Tensor:
    """y = x @ W_sparse through K10, x (..., d_in)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()     # the kernel's layout
    y = nm_spmm(x2, w_nm.val, w_nm.off, n=w_nm.n, m=w_nm.m)
    return y.reshape(*lead, -1)


class SparseLinear:
    """A pruned weight layer that holds its SpGEMM structures across applies.

    The weight's sparsity pattern is frozen at construction, so every
    sparse-activation apply (``matmul_sparse``) against a recurring
    activation pattern reuses one cached ``SpgemmStructure`` through the
    layer's ``plan.cache.StructureCache``. Pass a shared ``cache`` to pool
    structures across layers (``SparseMLP`` does). Dense activations
    (``__call__``) take the structured SpMM and need no structure.

    ``nm`` routes the dense apply (``plan.planner.plan_spmm_format``):

    * a tuple ``(n, m)`` prunes with :func:`magnitude_prune_nm` and stores
      the condensed planes (K10), plus a lossless ELLPACK twin of the same
      matrix — bit-identical results on either route;
    * ``"auto"`` (default) prunes globally, then lets the planner pick the
      N:M route iff the resulting pattern happens to be balanced;
    * ``None`` keeps the ELLPACK-only layout.

    ``w`` is pruned on its own device; a numpy weight goes to ``device``
    (``default_device()`` when None).
    """

    def __init__(self, w, sparsity: float, *, cache=None,
                 cache_capacity: int = 16, nm="auto", device=None):
        w = as_tensor(w, device)
        if isinstance(nm, tuple):
            wp = magnitude_prune_nm(w, *nm)
            shape = nm
        else:
            wp = magnitude_prune(w, sparsity)
            shape = None
            if nm == "auto":
                from ..plan.planner import plan_spmm_format
                _, shape = plan_spmm_format(wp)
        if shape is not None:
            self.w_nm = nm_from_dense(wp, *shape)
            self.w_ell = ell_from_pruned(wp)    # bit-identical ELL twin
        else:
            self.w_nm = None
            self.w_ell = sparsify_linear(w, sparsity)
        self.cache = self._cache(cache, cache_capacity)

    @staticmethod
    def _cache(cache, capacity: int):
        if cache is not None:
            return cache
        from ..plan.cache import StructureCache
        return StructureCache(capacity=capacity)

    @classmethod
    def from_planes(cls, w_ell: EllCols, w_nm: NmWeights = None, *,
                    cache=None, cache_capacity: int = 16) -> "SparseLinear":
        """A layer over ready planes, e.g. the reference layer's ``w_ell``
        and ``w_nm`` carried over with ``core.formats.from_numpy`` and
        ``nm_from_numpy``."""
        layer = cls.__new__(cls)
        layer.w_ell, layer.w_nm = w_ell, w_nm
        layer.cache = cls._cache(cache, cache_capacity)
        return layer

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Dense activations: y = x @ W_sparse (structured SpMM)."""
        if self.w_nm is not None:
            return nm_linear_apply(x, self.w_nm)
        return sparse_linear_apply(x, self.w_ell)

    def matmul_sparse(self, a, **spgemm_kwargs):
        """Sparse activations: C = A · W_sparse as sorted COO, two-phase.

        ``a`` is a row-wise ELLPACK activation matrix (d_batch rows, d_in
        logical columns). Symbolic work runs once per distinct A pattern;
        repeats are numeric-only. ``spgemm_kwargs`` forward to the structure
        build on a miss; the port needs a pinned ``backend=`` there, since
        backend selection is not ported (ROADMAP queue 1 item 3)."""
        from ..core.spgemm import spgemm_coo_numeric
        structure = self.cache.get(a, self.w_ell, **spgemm_kwargs)
        # the cache key already proved the fingerprint matches
        return spgemm_coo_numeric(a, self.w_ell, structure, validate=False)
