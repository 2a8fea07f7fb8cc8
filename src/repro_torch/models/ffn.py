"""FFN variants: SwiGLU, GELU MLP, the pruned ``SparseMLP``, and the MoE
layer with the reference's three dispatches, mirroring
``src/repro/models/ffn.py``.

A top-k routing matrix **is** a row-wise ELLPACK matrix: every token row has
exactly ``k`` slots. The dispatches (``cfg.moe.dispatch``):

  * ``'ellpack'`` — one-hot dispatch / combine einsums over a (T, E, C)
    tensor (GShard-style, the baseline).
  * ``'sort'``    — (token, slot) pairs sorted stably by expert id, ranked
    within their expert's run, gathered into the capacity buffers and
    summed back: no (T, E, C) tensor.
  * ``'spmm'``    — dispatch (``Xᵉ = Rᵀ·X``) and combine (``Y = R·E(Xᵉ)``)
    as two ELLPACK × dense SpMMs through ``kernels.ops.ell_spmm`` (K9) on
    the card, and through its plain twin on the CPU.

The expert and shared-expert products are plain batched matmuls, as the
reference leaves them to XLA; ``'ellpack'`` and ``'sort'`` run no TPU
kernel. Under ``parallel.sharding_rules(mesh)`` the tokens form one group
a data shard, in all three dispatches, and ``'sort'`` runs its region
shard by shard on the mesh (``_moe_sort_sharded``): what the reference's
``shard_map`` computes, the expert offsets, ``psum`` and aux ``pmean``
included. Without a mesh there is one group and one body. ``'ellpack'``,
``'spmm'``, the router and the shared experts run on the tokens' device
as one program: their layout under a mesh is the reference's partitioner's
choice and changes no value.

With the weights placed on the mesh (``models.params.place_params``) the
partitioned program runs ``swiglu_apply_sharded`` and
``gelu_mlp_apply_sharded`` (column-parallel over ``ff``, the ``fsdp`` rows
all-gathered for the call, row-parallel back to partial sums) and
``moe_apply_sharded``: every dispatch runs at every mesh coordinate on
that coordinate's own blocks of the placed expert weights, so it copies
no weight a call and gathers nothing whole. ``'spmm'`` routes each
coordinate's groups over every expert, keeps in its ELLPACK planes the
pairs bound for its own experts' capacity slots (the other lanes dead)
and runs K9 there, dispatch and combine (``_moe_spmm_local``);
``'ellpack'`` cuts its one-hot tensors to the local experts. Everything
runs under autograd, the aux loss (``aux=True``) included.

Parameters are dicts of tensors in the reference's layouts
(``core.formats.params_from_numpy`` carries the reference's over):
``router`` (d, E), ``w_gate``/``w_up`` (E, d, f), ``w_down`` (E, f, d) and,
with shared experts, ``shared`` = {``w_gate``, ``w_up`` (d, n_shared·f),
``w_down`` (n_shared·f, d)}.
"""
from __future__ import annotations

import itertools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.formats import EllRows
from ..obs import trace as _obs
from .params import Spec
from .sparse import SparseLinear


# ---------------------------------------------------------------------------
# Dense FFNs
# ---------------------------------------------------------------------------

def swiglu_specs(cfg, d_ff: Optional[int] = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "w_gate": Spec((d, f), ("fsdp", "ff")),
        "w_up": Spec((d, f), ("fsdp", "ff")),
        "w_down": Spec((f, d), ("ff", "fsdp")),
    }


def swiglu_apply(p, x: torch.Tensor, dtype) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"].to(dtype)) * (x @ p["w_up"].to(dtype))
    return h @ p["w_down"].to(dtype)


def swiglu_apply_sharded(p, x, dtype):
    """SwiGLU on placed weights, ``x`` a ``Sharded`` (..., d) with ``d``
    whole: ``w_gate``/``w_up`` column-parallel by the rules' ``ff`` split,
    ``w_down`` row-parallel. Returns partial sums over the ``ff`` axes (a
    whole product where ``ff`` is not split)."""
    from ..parallel.sharding import gather, matmul, smap
    wg, wu = gather(p["w_gate"], 0), gather(p["w_up"], 0)
    h = smap(lambda a, g, u: F.silu(a @ g.to(dtype)) * (a @ u.to(dtype)),
             x, wg, wu, spec=x.spec[:-1] + (wg.spec[1],))
    return matmul(h, gather(p["w_down"], 1), dtype)


def gelu_mlp_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_in": Spec((d, f), ("fsdp", "ff")),
        "b_in": Spec((f,), ("ff",), init="zeros"),
        "w_out": Spec((f, d), ("ff", "fsdp")),
        "b_out": Spec((d,), (None,), init="zeros"),
    }


def gelu_mlp_apply(p, x: torch.Tensor, dtype) -> torch.Tensor:
    """GELU in its tanh form, ``jax.nn.gelu``'s default."""
    h = F.gelu(x @ p["w_in"].to(dtype) + p["b_in"].to(dtype),
               approximate="tanh")
    return h @ p["w_out"].to(dtype) + p["b_out"].to(dtype)


def gelu_mlp_apply_sharded(p, x, dtype):
    """The GELU MLP on placed weights, ``x`` a ``Sharded`` (..., d) with
    ``d`` whole: ``w_in`` and ``b_in`` column-parallel by the ``ff`` split,
    ``w_out`` row-parallel, ``b_out`` added once, on the first shard of the
    ``ff`` axes. Returns partial sums over them."""
    from ..parallel.sharding import gather, matmul, smap
    wi = gather(p["w_in"], 0)
    h = smap(lambda a, w, b: F.gelu(a @ w.to(dtype) + b.to(dtype),
                                    approximate="tanh"),
             x, wi, p["b_in"], spec=x.spec[:-1] + (wi.spec[1],))
    y = matmul(h, gather(p["w_out"], 1), dtype)
    return smap(lambda a, b, at: a + b.to(dtype)
                if all(at[ax] == 0 for ax in y.partial) else a,
                y, p["b_out"], spec=y.spec, partial=y.partial, at=True)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_specs(cfg) -> dict:
    m = cfg.moe
    d, fe = cfg.d_model, m.d_ff_expert
    s = {
        "router": Spec((d, m.n_experts), (None, "expert")),
        "w_gate": Spec((m.n_experts, d, fe), ("expert", None, "expert_ff")),
        "w_up": Spec((m.n_experts, d, fe), ("expert", None, "expert_ff")),
        "w_down": Spec((m.n_experts, fe, d), ("expert", "expert_ff", None)),
    }
    if m.n_shared:
        s["shared"] = swiglu_specs(cfg, d_ff=m.n_shared * fe)
    return s


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


def _aux_loss(logits: torch.Tensor, onehot: torch.Tensor, e: int):
    """Switch load-balancing loss: mean routed share × mean probability an
    expert, times E."""
    me = onehot.sum(2).mean(dim=(0, 1))
    pe = torch.softmax(logits.to(torch.float32), -1).mean(dim=(0, 1))
    return e * torch.sum(me * pe)


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
    return torch.stack(ys), _aux_loss(logits, onehot, e)


def _moe_ellpack(p, x_grp: torch.Tensor, cfg, dtype):
    """One-hot (ELLPACK) dispatch: GShard-style capacity-bounded einsums over
    x_grp (G, T_g, d), through a (G, T_g, E, C) dispatch tensor."""
    m = cfg.moe
    g, tg, d = x_grp.shape
    e, k = m.n_experts, m.top_k
    cap = moe_capacity(tg, cfg)
    logits = x_grp @ p["router"].to(dtype)                  # (G,Tg,E)
    w, ids = _topk_routing(logits, k)                       # ELLPACK planes
    onehot = F.one_hot(ids.long(), e).to(torch.float32)     # (G,Tg,k,E)
    # position of each (token, slot) within its expert's capacity buffer
    pos = torch.cumsum(onehot.reshape(g, tg * k, e), dim=1).reshape(
        g, tg, k, e) - 1.0
    keep = (pos < cap) & (onehot > 0)
    pos = torch.where(keep, pos, 0).to(torch.int64)
    disp = (keep.to(torch.float32)[..., None]
            * F.one_hot(pos, cap).to(torch.float32))        # (G,Tg,k,E,C)
    comb = disp * w[..., None, None]
    disp = disp.sum(2)                                      # (G,Tg,E,C)
    comb = comb.sum(2)
    xe = torch.einsum("gtec,gtd->gecd", disp.to(dtype), x_grp)
    h = torch.einsum("gecd,edf->gecf", xe, p["w_gate"].to(dtype))
    u = torch.einsum("gecd,edf->gecf", xe, p["w_up"].to(dtype))
    ye = torch.einsum("gecf,efd->gecd", F.silu(h) * u, p["w_down"].to(dtype))
    y = torch.einsum("gtec,gecd->gtd", comb.to(dtype), ye)
    return y, _aux_loss(logits, onehot, e)


def _moe_sort(p, x_grp: torch.Tensor, cfg, dtype):
    """Sorted dispatch (the in-situ-search dual: equal coordinates grouped
    by sorting). Without a mesh, one body (``_moe_sort_body``) over every
    group and expert. Under ``sharding_rules(mesh)`` the reference runs the
    region under a full-manual ``shard_map``; here ``_moe_sort_sharded``
    runs its shards one after another."""
    from ..parallel.sharding import current_rules
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return _moe_sort_body(x_grp, p["router"], p["w_gate"], p["w_up"],
                              p["w_down"], cfg, dtype, 0)
    return _moe_sort_sharded(p, x_grp, cfg, dtype, rules)


def _moe_sort_sharded(p, x_grp: torch.Tensor, cfg, dtype, rules):
    """The reference's ``shard_map`` of the ``'sort'`` region on the
    in-process mesh. The groups split over the data axes ``gspec`` names
    and the expert weights over ``"model"`` (the expert dim where it
    divides, else the hidden dim, else not at all), by the specs the
    reference resolves. For each data coordinate and each ``"model"``
    coordinate the device-local body runs on that mesh device, on its
    blocks (views where they lie on that device already, else counted
    copies: ``parallel.mesh.place``), with ``e_off`` = its ``"model"``
    index · e_loc. An axis no spec names replicates and runs once. When
    the weights were split, ``psum`` over ``"model"`` completes each data
    shard's partial combine; the data shards' groups are concatenated on
    the mesh's first device, and the aux loss is the mean of theirs (the
    reference's ``pmean``). Everything runs under autograd.

    On ``meta`` tensors (the dry run, whatever the mesh's devices) one
    body runs over the global shapes, every group and expert: a trace
    that counts the whole program without a loop over hundreds of shards
    a layer."""
    from ..parallel.mesh import place, psum
    from ..parallel.sharding import shard_block, shard_shape, spec_axes
    mesh = rules.mesh
    d = x_grp.shape[-1]
    e, fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
    if x_grp.is_meta:
        return _moe_sort_body(x_grp, p["router"], p["w_gate"], p["w_up"],
                              p["w_down"], cfg, dtype, 0)
    gspec = rules.resolve(("batch", None, None), x_grp.shape)
    wg_spec = rules.resolve(("expert", None, "expert_ff"), (e, d, fe))
    wd_spec = rules.resolve(("expert", "expert_ff", None), (e, fe, d))
    gaxes = spec_axes(gspec[0])
    waxes = tuple(dict.fromkeys(ax for sp in (wg_spec, wd_spec)
                                for entry in sp for ax in spec_axes(entry)))
    if set(waxes) - {"model"} or "model" in gaxes:
        raise ValueError(f"the 'sort' region splits groups over the data "
                         f"axes and experts over 'model' only; the rules "
                         f"give groups {gspec[0]!r}, experts {waxes}")
    e_loc, _, f_loc = shard_shape(wg_spec, (e, d, fe), mesh)
    partitioned = e_loc < e or f_loc < fe
    n_model = mesh.shape["model"] if partitioned else 1
    first = mesh.devices.flat[0]
    ys, auxes = [], []
    for gc in itertools.product(*(range(mesh.shape[ax]) for ax in gaxes)):
        parts = []
        for j in range(n_model):
            coords = dict(zip(gaxes, gc), model=j)
            dev = mesh.device_at(coords)
            x_loc = place(shard_block(x_grp, gspec, mesh, coords), dev)
            w = [place(shard_block(p[name], sp, mesh, coords), dev)
                 for name, sp in (("w_gate", wg_spec), ("w_up", wg_spec),
                                  ("w_down", wd_spec))]
            e_off = j * e_loc if e_loc < e else 0
            y, aux = _moe_sort_body(x_loc, place(p["router"], dev), *w,
                                    cfg, dtype, e_off)
            parts.append(y)
            if j == 0:
                auxes.append(place(aux, first))
        ys.append(place(psum(parts) if partitioned else parts[0], first))
    aux = auxes[0] if len(auxes) == 1 else torch.stack(auxes).mean()
    return torch.cat(ys) if len(ys) > 1 else ys[0], aux


def _moe_sort_body(x_grp: torch.Tensor, router, w_gate, w_up, w_down, cfg,
                   dtype, e_off: int):
    """The reference's device-local ``_moe_sort_body``. Every group sorts
    its (token, slot) pairs by expert id, stably; a pair's rank in its
    expert's run (a running max of the run starts) decides whether it fits
    the capacity; kept tokens are gathered into the (E·C) capacity rows,
    the expert products run on the ``e_loc`` = ``w_gate.shape[0]`` experts
    from ``e_off`` whose weights arrive (all of them, or a hidden-dim
    slice, without a mesh), and the rows of those experts come back scaled
    by their routing weights and summed into their tokens (``index_add_``):
    a partial combine where the weights were split."""
    m = cfg.moe
    g, tg, d = x_grp.shape
    e, k = m.n_experts, m.top_k
    cap = moe_capacity(tg, cfg)
    e_loc = w_gate.shape[0]
    dev = x_grp.device
    logits = x_grp @ router.to(dtype)                       # (G,Tg,E)
    w, ids = _topk_routing(logits, k)
    npg = tg * k                                             # pairs a group
    tok_of = torch.arange(tg, dtype=torch.int64, device=dev) \
        .repeat_interleave(k)[None].expand(g, npg)
    s_ids, perm = torch.sort(ids.reshape(g, npg), dim=1, stable=True)
    s_tok = tok_of.gather(1, perm)
    s_w = w.reshape(g, npg).gather(1, perm)
    # rank within each (group, expert) run
    idx = torch.arange(npg, device=dev)[None].expand(g, npg)
    start = torch.ones((g, npg), dtype=torch.bool, device=dev)
    start[:, 1:] = s_ids[:, 1:] != s_ids[:, :-1]
    run_start = torch.cummax(torch.where(start, idx, 0), dim=1).values
    rank = idx - run_start
    keep = rank < cap
    slot = s_ids.to(torch.int64) * cap + torch.where(keep, rank, 0)
    goff_t = (torch.arange(g, device=dev) * tg)[:, None]
    tok_flat = (s_tok + goff_t).reshape(-1)
    gathered = x_grp.reshape(g * tg, d)[tok_flat].reshape(g, npg, d) \
        * keep[..., None].to(dtype)
    goff_s = (torch.arange(g, device=dev) * (e * cap))[:, None]
    flat_slot = torch.where(keep, slot + goff_s, g * e * cap).reshape(-1)
    xe = torch.zeros((g * e * cap + 1, d), dtype=dtype, device=dev)
    xe.index_add_(0, flat_slot, gathered.reshape(g * npg, d))
    xe = xe[:-1].reshape(g, e, cap, d)[:, e_off:e_off + e_loc]
    del gathered
    h = torch.einsum("gecd,edf->gecf", xe, w_gate.to(dtype))
    u = torch.einsum("gecd,edf->gecf", xe, w_up.to(dtype))
    ye = torch.einsum("gecf,efd->gecd", F.silu(h) * u, w_down.to(dtype))
    del h, u
    # combine only the pairs whose expert is local
    loc_slot = slot - e_off * cap
    scale = s_w * keep
    if e_loc < e:
        scale = scale * ((loc_slot >= 0) & (loc_slot < e_loc * cap))
        loc_slot = loc_slot.clamp(0, e_loc * cap - 1)
    goff_l = (torch.arange(g, device=dev) * (e_loc * cap))[:, None]
    back = ye.reshape(g * e_loc * cap, d)[(loc_slot + goff_l).reshape(-1)] \
        .reshape(g, npg, d) * scale.to(dtype)[..., None]
    y = torch.zeros((g * tg, d), dtype=dtype, device=dev)
    y.index_add_(0, tok_flat, back.reshape(g * npg, d))
    onehot = F.one_hot(ids.long(), e).to(torch.float32)
    return y.reshape(g, tg, d), _aux_loss(logits, onehot, e)


_DISPATCH = {"ellpack": _moe_ellpack, "sort": _moe_sort, "spmm": _moe_spmm}


def moe_apply(p, x: torch.Tensor, cfg, dtype) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """x: (B, S, d) → (y, aux_loss) through ``cfg.moe.dispatch``
    (``'ellpack'``, ``'sort'`` or ``'spmm'``). Tokens are split into
    ``min(axis_size("batch"), B)`` groups (GShard groups, one a data shard
    under ``sharding_rules(mesh)``, one without a mesh), which must divide
    the B·S tokens; capacity is counted a group."""
    from ..parallel.sharding import axis_size
    b, s, d = x.shape
    groups = max(1, min(axis_size("batch"), b))
    if b * s % groups:
        raise ValueError(f"{b} x {s} tokens do not split into {groups} "
                         "groups (the reference's reshape fails alike)")
    x_grp = x.reshape(groups, b * s // groups, d)
    run = _DISPATCH.get(cfg.moe.dispatch, _moe_ellpack)
    with _obs.span("moe.dispatch", strategy=cfg.moe.dispatch, tokens=b * s,
                   experts=cfg.moe.n_experts):
        y, aux = _obs.sync(run(p, x_grp, cfg, dtype))
    if cfg.moe.n_shared:
        y = y + swiglu_apply(p["shared"], x_grp, dtype)
    return y.reshape(b, s, d), aux


def moe_apply_sharded(p, x, cfg, dtype, rules, aux: bool = False):
    """The MoE layer on placed weights: ``x`` a ``Sharded`` (B, S, d) in the
    residual stream's layout, the result in the same. The tokens form
    ``min(axis_size("batch"), B)`` groups, as ``moe_apply``'s. Every
    dispatch runs at each coordinate on that coordinate's own expert
    blocks (``_moe_partitioned``); the shared experts run column- and
    row-parallel, their partial sums added to the region's before one
    reduce where both are split over the same axes. Returns ``(y, aux)``:
    with ``aux`` the load-balancing loss as the reference computes it
    under a mesh (a ``Sharded`` scalar every coordinate holds), else
    None."""
    from ..parallel.sharding import add, axis_size, relayout
    b, s, d = x.shape
    groups = max(1, min(axis_size("batch"), b))
    if b * s % groups:
        raise ValueError(f"{b} x {s} tokens do not split into {groups} "
                         "groups (the reference's reshape fails alike)")
    xg = relayout(x, (x.spec[0], None, None))
    with _obs.span("moe.dispatch", strategy=cfg.moe.dispatch, tokens=b * s,
                   experts=cfg.moe.n_experts):
        y, a = _moe_partitioned(p, xg, cfg, dtype, rules, groups, aux)
    if cfg.moe.n_shared:
        sh = swiglu_apply_sharded(p["shared"], xg, dtype)
        if sh.partial != y.partial:
            y, sh = relayout(y, x.spec), relayout(sh, x.spec)
        y = add(y, sh)
    return relayout(y, x.spec), a


def _moe_spmm_local(x_grp, router, w_gate, w_up, w_down, cfg, dtype,
                    e_off: int):
    """``_moe_spmm`` on one coordinate's expert blocks (``w_gate.shape[0]``
    = e_loc experts from ``e_off``, all of them where the hidden dim is
    split): the groups are routed over every expert with the router whole,
    and the dispatch and combine planes keep only the pairs bound for the
    local experts' capacity slots, renumbered from 0; the other lanes are
    dead (index -1, weight 0). K9 dispatches, the local experts run, K9
    combines: a partial sum where the experts were split. Returns (y,
    the aux loss's sums (2, E): routed counts and probabilities over the
    groups' tokens)."""
    g, tg, d = x_grp.shape
    e_loc = w_gate.shape[0]
    cap = moe_capacity(tg, cfg)
    logits = x_grp @ router.to(dtype)                       # (G,Tg,E)
    w, ids, onehot, kept, slot = _spmm_route(logits, cfg)
    loc = slot - e_off * cap
    mine = kept & (loc >= 0) & (loc < e_loc * cap)
    ys = []
    for i in range(g):
        disp = dispatch_planes(mine[i], loc[i], e_loc * cap, dtype)
        xe = _spmm_ell_auto(disp, x_grp[i].contiguous()).reshape(
            e_loc, cap, d)
        h = torch.bmm(xe, w_gate.to(dtype))
        u = torch.bmm(xe, w_up.to(dtype))
        ye = torch.bmm(F.silu(h) * u, w_down.to(dtype)) \
            .reshape(e_loc * cap, d)
        comb = combine_planes(mine[i], loc[i], w[i], e_loc * cap, dtype)
        ys.append(_spmm_ell_auto(comb, ye))                 # (Tg, d)
    return torch.stack(ys), _aux_sums(logits, onehot)


def _moe_ellpack_local(x_grp, router, w_gate, w_up, w_down, cfg, dtype,
                       e_off: int):
    """``_moe_ellpack`` on one coordinate's expert blocks: the (G, Tg, E,
    C) dispatch and combine tensors cut to the local experts. Returns (y,
    the aux loss's sums), as ``_moe_spmm_local``."""
    m = cfg.moe
    g, tg, d = x_grp.shape
    e, k = m.n_experts, m.top_k
    e_loc = w_gate.shape[0]
    cap = moe_capacity(tg, cfg)
    logits = x_grp @ router.to(dtype)
    w, ids = _topk_routing(logits, k)
    onehot = F.one_hot(ids.long(), e).to(torch.float32)
    pos = torch.cumsum(onehot.reshape(g, tg * k, e), dim=1).reshape(
        g, tg, k, e) - 1.0
    keep = (pos < cap) & (onehot > 0)
    pos = torch.where(keep, pos, 0).to(torch.int64)
    disp = (keep.to(torch.float32)[..., None]
            * F.one_hot(pos, cap).to(torch.float32))[:, :, :,
                                                     e_off:e_off + e_loc]
    comb = (disp * w[..., None, None]).sum(2)
    disp = disp.sum(2)
    xe = torch.einsum("gtec,gtd->gecd", disp.to(dtype), x_grp)
    h = torch.einsum("gecd,edf->gecf", xe, w_gate.to(dtype))
    u = torch.einsum("gecd,edf->gecf", xe, w_up.to(dtype))
    ye = torch.einsum("gecf,efd->gecd", F.silu(h) * u, w_down.to(dtype))
    y = torch.einsum("gtec,gecd->gtd", comb.to(dtype), ye)
    return y, _aux_sums(logits, onehot)


def _aux_sums(logits: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """The sums behind ``_aux_loss``'s means over a block of groups: (2, E)
    routed counts and router probabilities, float32."""
    return torch.stack([onehot.sum(2).sum(dim=(0, 1)),
                        torch.softmax(logits.to(torch.float32), -1)
                        .sum(dim=(0, 1))])


def _moe_partitioned(p, xg, cfg, dtype, rules, groups: int, aux: bool):
    """The MoE region of the partitioned program: ``xg`` (B, S, d) whole on
    S and d. Each coordinate takes its groups (its own tokens where the
    batch and the groups split over the same axes, its cut of all of them
    where the batch is whole), the router whole (an all-gather over its
    expert split) and its own blocks of the placed expert weights, and
    runs the config's dispatch there with ``e_off`` its ``"model"``
    block's first expert: ``_moe_sort_body`` (``'sort'``, the reference's
    ``shard_map`` region), ``_moe_spmm_local`` (``'spmm'``, K9) or
    ``_moe_ellpack_local``. Nothing is gathered whole. Returns ((B, S, d)
    by batch, partial sums over the experts' axes where the rules split
    them; the aux loss or None). The aux loss is the reference's under a
    mesh: ``'sort'``'s the mean of the group shards' (its ``pmean``), the
    others' from the sums over every group (an all-reduce of the (2, E)
    sums over the groups' axes)."""
    from ..parallel.sharding import (Sharded, entry_pos, gather, reduce,
                                     relayout, shard_shape, smap, spec_axes,
                                     split)
    b, s, d = xg.shape
    m = cfg.moe
    e, fe = m.n_experts, m.d_ff_expert
    tg = b * s // groups
    gspec = rules.resolve(("batch", None, None), (groups, tg, d))
    wg_spec, wd_spec = p["w_gate"].spec, p["w_down"].spec
    waxes = {ax for sp in (wg_spec, wd_spec) for entry in sp
             for ax in spec_axes(entry)}
    if waxes - {"model"} or "model" in spec_axes(gspec[0]):
        raise ValueError(f"the MoE region splits groups over the data "
                         f"axes and experts over 'model' only; the rules "
                         f"give groups {gspec[0]!r}, experts {waxes}")
    bat = xg.spec[0]
    if bat == gspec[0]:
        x_grp = smap(lambda a: a.reshape(-1, tg, d), xg,
                     spec=(bat, None, None))
    elif bat is None:
        x_grp = split(smap(lambda a: a.reshape(groups, tg, d), xg,
                           spec=(None, None, None)), 0, gspec[0])
    else:
        raise ValueError(f"the batch splits as {bat!r} and its {groups} "
                         f"token groups as {gspec[0]!r}")
    e_loc, _, f_loc = shard_shape(wg_spec, (e, d, fe), xg.mesh)
    mesh = xg.mesh
    run = {"sort": _moe_sort_body, "spmm": _moe_spmm_local}.get(
        m.dispatch, _moe_ellpack_local)

    def body(xl, router, wg, wu, wd, at):
        e_off = entry_pos(wg_spec[0], mesh, at) * e_loc if e_loc < e else 0
        return run(xl, router, wg, wu, wd, cfg, dtype, e_off)
    gaxes = spec_axes(gspec[0])
    y, st = smap(body, x_grp, relayout(p["router"], (None, None)),
                 p["w_gate"], p["w_up"], p["w_down"],
                 spec=[(gspec[0], None, None), ()],
                 partial=("model",) if e_loc < e or f_loc < fe else (),
                 at=True)
    if gspec[0] != bat:
        y = gather(y, 0)
    y = smap(lambda a: a.reshape(-1, s, d), y, spec=(bat, None, None),
             partial=y.partial)
    if not aux:
        return y, None
    st = Sharded(mesh, st.spec, st.shape, st.blocks, gaxes)
    n = math.prod(mesh.shape[a] for a in gaxes)
    if m.dispatch == "sort":
        return y, smap(lambda a: a / n, reduce(st), spec=())
    tot = reduce(st)
    return y, smap(lambda a: e * torch.sum(a[0] / (groups * tg)
                                           * (a[1] / (groups * tg))),
                   tot, spec=())


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
