"""FFN pieces of the SpMM slice: SwiGLU, the pruned ``SparseMLP``, and the
MoE layer with the reference's ``dispatch='spmm'``, mirroring
``src/repro/models/ffn.py``.

A top-k routing matrix **is** a row-wise ELLPACK matrix: every token row has
exactly ``k`` slots. Dispatch (``Xᵉ = Rᵀ·X``) and combine (``Y = R·E(Xᵉ)``)
run as two ELLPACK × dense SpMMs through ``kernels.ops.ell_spmm`` (K9) on
the card, and through its plain twin ``spmm_ell_dense`` on the CPU; the
expert and shared-expert products are plain batched matmuls, as the
reference leaves them to XLA.

Without a mesh the reference takes one token group (``axis_size("batch")``
is 1) and its ``maybe_shard`` does nothing; the port has no mesh yet, so it
keeps one group. The ``'ellpack'`` and ``'sort'`` dispatches run no TPU
kernel and come with the LM stack.

Parameters are dicts of tensors in the reference's layouts
(``core.formats.params_from_numpy`` carries the reference's over):
``router`` (d, E), ``w_gate``/``w_up`` (E, d, f), ``w_down`` (E, f, d) and,
with shared experts, ``shared`` = {``w_gate``, ``w_up`` (d, n_shared·f),
``w_down`` (n_shared·f, d)}.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..core.formats import EllRows
from ..obs import trace as _obs
from .sparse import SparseLinear


def swiglu_apply(p, x: torch.Tensor, dtype) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"].to(dtype)) * (x @ p["w_up"].to(dtype))
    return h @ p["w_down"].to(dtype)


def _topk_routing(logits: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (weights (..., k) fp32 normalized, expert ids (..., k) int32),
    a row-wise ELLPACK representation of the T×E routing matrix (k slots a
    row, idx plane = expert ids). The top k come from a stable descending
    sort, so equal probabilities keep the lower expert first, as
    ``lax.top_k`` orders them (``torch.topk`` does not promise that)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[..., :k], ids[..., :k]
    w = w / w.sum(dim=-1, keepdim=True)
    return w, ids.to(torch.int32)


def _spmm_ell_auto(a: EllRows, x: torch.Tensor) -> torch.Tensor:
    """ELLPACK × dense SpMM through ``ops.ell_spmm``: K9 for CUDA tensors,
    its plain twin ``spmm_ell_dense`` for CPU tensors — the reference's
    ``resolve_mode`` rule keyed on the device."""
    from ..kernels import ops
    return ops.ell_spmm(a.val, a.idx, x, a.n_rows)


def moe_capacity(tg: int, cfg) -> int:
    """Per-expert capacity of a group of ``tg`` tokens."""
    m = cfg.moe
    return max(1, int(tg * m.capacity_factor * m.top_k / m.n_experts))


def _spmm_route(logits: torch.Tensor, cfg):
    """Routing of a (G, Tg, E) logits block: ``(w, ids, onehot, kept,
    slot)``. ``kept`` (G, Tg, k) marks the (token, slot) pairs inside their
    expert's capacity and ``slot`` = expert·cap + rank their capacity slot.
    The rank is a float32 cumsum over the flattened (token, k-slot) axis, in
    the reference's order, so the same pairs are dropped."""
    m = cfg.moe
    g, tg, e = logits.shape
    k = m.top_k
    cap = moe_capacity(tg, cfg)
    w, ids = _topk_routing(logits, k)
    onehot = F.one_hot(ids.long(), e).to(torch.float32)      # (G,Tg,k,E)
    pos = torch.cumsum(onehot.reshape(g, tg * k, e), dim=1).reshape(
        g, tg, k, e) - 1.0
    keep = (pos < cap) & (onehot > 0)
    rank = torch.where(keep, pos, 0).sum(-1).to(torch.int32)  # (G,Tg,k)
    kept = keep.any(-1)
    slot = ids * cap + rank                                   # in [0, E·C)
    return w, ids, onehot, kept, slot


def dispatch_planes(kept: torch.Tensor, slot: torch.Tensor, n_slots: int,
                    dtype) -> EllRows:
    """Dispatch as a k-slab ELLPACK of one group: columns = tokens, rows =
    the E·C capacity slots, value 1 on every kept pair."""
    return EllRows(val=kept.to(dtype).T.contiguous(),
                   idx=torch.where(kept, slot, -1).T.contiguous()
                   .to(torch.int32), n_rows=n_slots)


def combine_planes(kept: torch.Tensor, slot: torch.Tensor, w: torch.Tensor,
                   n_slots: int, dtype) -> EllRows:
    """Combine as a 1-slab ELLPACK over the slot axis of one group: slot →
    (token, routing weight); ranks are unique per expert, so every slot
    holds at most one pair and empty slots carry index −1."""
    tg, k = kept.shape
    dev = kept.device
    flat = torch.where(kept, slot, n_slots).reshape(-1).long()
    tok = torch.arange(tg, dtype=torch.int32, device=dev)[:, None] \
        .expand(tg, k).reshape(-1)
    tok_of = torch.full((n_slots + 1,), -1, dtype=torch.int32, device=dev)
    tok_of[flat] = tok
    w_of = torch.zeros((n_slots + 1,), dtype=dtype, device=dev)
    w_of[flat] = w.reshape(-1).to(dtype)
    return EllRows(val=w_of[None, :n_slots].contiguous(),
                   idx=tok_of[None, :n_slots].contiguous(), n_rows=tg)


def _moe_spmm(p, x_grp: torch.Tensor, cfg, dtype):
    """SpGEMM-stack dispatch: the routing planes feed two structured
    ELLPACK × dense SpMMs through ``_spmm_ell_auto`` instead of a (T, E, C)
    one-hot tensor. Dispatch scatters token rows into per-expert capacity
    slots (k slabs); combine gathers them back with the routing weights
    (one slab over the slot axis)."""
    m = cfg.moe
    g, tg, d = x_grp.shape
    e = m.n_experts
    cap = moe_capacity(tg, cfg)
    logits = x_grp @ p["router"].to(dtype)                  # (G,Tg,E)
    w, ids, onehot, kept, slot = _spmm_route(logits, cfg)
    ys = []
    for i in range(g):
        disp = dispatch_planes(kept[i], slot[i], e * cap, dtype)
        xe = _spmm_ell_auto(disp, x_grp[i].contiguous()).reshape(e, cap, d)
        h = torch.bmm(xe, p["w_gate"].to(dtype))
        u = torch.bmm(xe, p["w_up"].to(dtype))
        ye = torch.bmm(F.silu(h) * u, p["w_down"].to(dtype)) \
            .reshape(e * cap, d)
        comb = combine_planes(kept[i], slot[i], w[i], e * cap, dtype)
        ys.append(_spmm_ell_auto(comb, ye))                 # (Tg, d)
    y = torch.stack(ys)
    me = onehot.sum(2).mean(dim=(0, 1))
    pe = torch.softmax(logits.to(torch.float32), -1).mean(dim=(0, 1))
    aux = e * torch.sum(me * pe)
    return y, aux


def moe_apply(p, x: torch.Tensor, cfg, dtype) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """x: (B, S, d) → (y, aux_loss), ``cfg.moe.dispatch`` = ``'spmm'``."""
    b, s, d = x.shape
    if cfg.moe.dispatch != "spmm":
        raise NotImplementedError(
            f"moe_apply(dispatch={cfg.moe.dispatch!r}) is not ported to "
            "repro_torch yet: ROADMAP queue 1 item 10 (LM stack); "
            "dispatch='spmm' is")
    x_grp = x.reshape(1, b * s, d)          # one group without a mesh
    with _obs.span("moe.dispatch", strategy=cfg.moe.dispatch, tokens=b * s,
                   experts=cfg.moe.n_experts):
        y, aux = _obs.sync(_moe_spmm(p, x_grp, cfg, dtype))
    if cfg.moe.n_shared:
        y = y + swiglu_apply(p["shared"], x_grp, dtype)
    return y.reshape(b, s, d), aux


class SparseMLP:
    """Pruned two-layer MLP whose layers pool one structure cache.

    Both ``SparseLinear`` layers share a single ``plan.cache.StructureCache``
    (pass ``cache=`` to pool wider). ``nm`` and ``device`` go to each
    layer."""

    def __init__(self, w_in, w_out, sparsity: float, *, cache=None,
                 cache_capacity: int = 16, nm="auto", device=None):
        from ..plan.cache import StructureCache
        self.cache = cache if cache is not None \
            else StructureCache(capacity=cache_capacity)
        self.fc_in = SparseLinear(w_in, sparsity, cache=self.cache, nm=nm,
                                  device=device)
        self.fc_out = SparseLinear(w_out, sparsity, cache=self.cache, nm=nm,
                                   device=device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Dense activations: x @ W_in → GELU (tanh form, ``jax.nn.gelu``'s
        default) → @ W_out (structured SpMMs)."""
        with _obs.span("sparse_mlp.apply"):
            return _obs.sync(self.fc_out(F.gelu(self.fc_in(x),
                                                approximate="tanh")))

    def cache_stats(self):
        """Hit/miss/eviction counters of the shared structure cache."""
        return self.cache.stats()
