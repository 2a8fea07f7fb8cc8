"""Generic decoder-only LM, mirroring ``src/repro/models/transformer.py``.

An architecture is a *segment plan*: a list of (unit, repeats) where a unit
is a tuple of block kinds. A segment of several repeats keeps its
parameters stacked on a leading layer dim, as the reference's do, and runs
as a Python loop over that dim (the reference scans it). The same plan
drives parameter construction, the forward and loss, prefill, and cached
decode.

Block kinds ported:
  attn       full-attention GQA + SwiGLU          (dense archs)
  attn_moe   GQA + MoE                            (granite)
  local      windowed GQA + SwiGLU                (recurrentgemma 1-in-3)
  mla_dense  MLA + SwiGLU                         (deepseek layer 0)
  mla_moe    MLA + MoE(+shared)                   (deepseek)
  mamba      selective SSM alone                  (falcon-mamba)
  rec        RG-LRU + SwiGLU                      (recurrentgemma 2-in-3)

Caches are preallocated at ``s_max`` (``decoder_cache_zeros``) and written
in place: prefill fills them, every decode step writes its token's entries
(the recurrent kinds: their conv window and state) and returns the same
tensors. ``pos`` is a Python int.

The loss is differentiable: a stacked segment's leaves are split into their
layers with ``unbind`` (whose backward stacks the layers' grads once, where
indexing would add a zero-filled leaf-sized grad for every layer), and with
grad enabled and no cache wanted each layer's block runs under
``torch.utils.checkpoint`` as ``cfg.remat`` asks, the reference's
``_maybe_remat``: ``"full"`` saves only each block's inputs, ``"dots"``
saves the matmul outputs (a selective-checkpoint policy, the counterpart of
``checkpoint_dots_with_no_batch_dims``) and recomputes the rest. Remat
changes memory, never values.

The partitioned program. Under ``sharding_rules(mesh)`` with the weights
placed on the mesh (``params.place_params``; the serving engine and the
trainer place them), ``decoder_prefill``, ``decoder_decode_step`` and
``decoder_loss`` run ``parallel.sharding.Sharded`` tensors through the
``*_sharded`` layers of ``attention``, ``ffn``, ``ssm``, ``rglru`` and
``common``, every block kind included. Between blocks the residual stream
is held as the rules hold it, ``("batch", "seq_act", None)``: batch over
the data axes, the sequence over ``"model"`` where it divides. Each shard
runs its norms on its own rows; an all-gather over the sequence precedes
each column-parallel product (and each mixer: the scans need every
position on each channel shard), and a reduce-scatter back to the
stream's layout (an all-reduce where the sequence is whole, as in decode)
follows each row-parallel one. The caches are laid out by
``launch.steps.cache_shardings``: keys and values by batch and sequence
(a ``local`` block's ring of W slots too, each shard writing the slots it
owns from the prefill's whole keys), the recurrent states by batch and
channel. Without a mesh, or with whole weights, every path is the one
above. An unknown block kind raises.
"""
from __future__ import annotations

import functools
import itertools
from typing import Any, Dict, List, Tuple

import torch
import torch.utils.checkpoint as _ckpt

from . import attention as attn
from . import ffn, rglru, ssm
from .common import (embed_lookup, embed_specs, rmsnorm,
                     sharded_softmax_xent, unembed)
from .params import (Spec, is_placed, stack, torch_dtype, tree_items,
                     tree_leaves, tree_map, tree_unflatten)

# ---------------------------------------------------------------------------
# Segment planning
# ---------------------------------------------------------------------------

def segment_plan(cfg) -> List[Tuple[Tuple[str, ...], int]]:
    L = cfg.n_layers
    if cfg.family == "ssm":
        return [(("mamba",), L)]
    if cfg.family == "hybrid":
        unit = tuple("local" if k == "attn" else k for k in cfg.griffin.pattern)
        reps, rem = divmod(L, len(unit))
        plan = [(unit, reps)]
        if rem:
            plan.append((unit[:rem], 1))
        return plan
    if cfg.moe is not None and cfg.mla is not None:
        fd = cfg.moe.first_dense_layers
        plan = []
        if fd:
            plan.append((("mla_dense",), fd))
        plan.append((("mla_moe",), L - fd))
        return plan
    if cfg.moe is not None:
        return [(("attn_moe",), L)]
    return [(("attn",), L)]


# ---------------------------------------------------------------------------
# Block specs / apply / cache
# ---------------------------------------------------------------------------

def _norm_spec(cfg):
    return Spec((cfg.d_model,), (None,), init="ones")


def block_specs(cfg, kind: str) -> Dict[str, Any]:
    s: Dict[str, Any] = {"ln1": _norm_spec(cfg)}
    if kind in ("attn", "attn_moe", "local"):
        s["attn"] = attn.gqa_specs(cfg)
        s["ln2"] = _norm_spec(cfg)
        s["ffn"] = ffn.moe_specs(cfg) if kind == "attn_moe" \
            else ffn.swiglu_specs(cfg)
    elif kind in ("mla_dense", "mla_moe"):
        s["attn"] = attn.mla_specs(cfg)
        s["ln2"] = _norm_spec(cfg)
        s["ffn"] = ffn.moe_specs(cfg) if kind == "mla_moe" \
            else ffn.swiglu_specs(cfg)
    elif kind == "mamba":
        s["mixer"] = ssm.mamba_specs(cfg)
    elif kind == "rec":
        s["rec"] = rglru.rglru_specs(cfg)
        s["ln2"] = _norm_spec(cfg)
        s["ffn"] = ffn.swiglu_specs(cfg)
    else:
        raise ValueError(kind)
    return s


def _ffn_apply(p, x, cfg, kind, dtype):
    if kind in ("attn_moe", "mla_moe"):
        return ffn.moe_apply(p, x, cfg, dtype)
    return ffn.swiglu_apply(p, x, dtype), torch.zeros((), device=x.device)


def _ring_layout(k, v, s: int, w: int):
    """The prefill's last ``w`` keys/values laid out as decode's ``pos % w``
    ring indexing expects, with each slot's absolute position (-1 empty)."""
    dev = k.device
    if s >= w:
        shift = s % w
        k = torch.roll(k[:, -w:], shift, dims=1)
        v = torch.roll(v[:, -w:], shift, dims=1)
        slot_pos = torch.roll(torch.arange(s - w, s, dtype=torch.int32,
                                           device=dev), shift)
        return k, v, slot_pos
    slot_pos = torch.full((w,), -1, dtype=torch.int32, device=dev)
    slot_pos[:s] = torch.arange(s, dtype=torch.int32, device=dev)
    return k, v, slot_pos


def block_apply_full(p, x, cfg, kind: str, dtype, want_cache: bool,
                     s_max: int = 0, cache=None):
    """Full-seq path. Returns (x, aux_loss, cache or None). With
    ``want_cache`` the block's keys/values (or latent, or recurrent states)
    are written into ``cache`` (``block_cache_zeros``' layout; allocated
    here when None)."""
    aux = torch.zeros((), device=x.device)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    s = x.shape[1]
    if want_cache and cache is None:
        cache = block_cache_zeros(cfg, kind, x.shape[0], s_max or s, dtype,
                                  x.device)
    if kind in ("attn", "attn_moe", "local"):
        window = cfg.griffin.window if kind == "local" else cfg.attn_window
        out, kv = attn.gqa_full(p["attn"], h, cfg, dtype, window=window,
                                return_kv=want_cache)
        x = x + out
        h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
        y, aux = _ffn_apply(p["ffn"], h2, cfg, kind, dtype)
        x = x + y
        if want_cache:
            k, v = kv
            if kind == "local":
                k, v, slot_pos = _ring_layout(k, v, s, cfg.griffin.window)
                n = k.shape[1]
            else:
                n = s
                slot_pos = torch.arange(cache["slot_pos"].shape[0],
                                        dtype=torch.int32, device=x.device)
                slot_pos = torch.where(slot_pos < s, slot_pos, -1)
            cache["k"][:, :n] = k
            cache["v"][:, :n] = v
            cache["slot_pos"].copy_(slot_pos)
    elif kind in ("mla_dense", "mla_moe"):
        out, kv = attn.mla_full(p["attn"], h, cfg, dtype, return_kv=want_cache)
        x = x + out
        h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
        y, aux = _ffn_apply(p["ffn"], h2, cfg, kind, dtype)
        x = x + y
        if want_cache:
            latent, krope = kv
            cache["latent"][:, :s] = latent
            cache["krope"][:, :s] = krope
    elif kind == "mamba":
        out, st = ssm.mamba_apply_full(p["mixer"], h, cfg, dtype,
                                       return_state=want_cache)
        x = x + out
        if want_cache:
            cache["conv"].copy_(st[0])
            cache["ssm"].copy_(st[1])
    elif kind == "rec":
        out, st = rglru.rglru_apply_full(p["rec"], h, cfg, dtype,
                                         return_state=want_cache)
        x = x + out
        h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
        y, _ = _ffn_apply(p["ffn"], h2, cfg, kind, dtype)
        x = x + y
        if want_cache:
            cache["conv"].copy_(st[0])
            cache["h"].copy_(st[1])
    else:
        raise ValueError(kind)
    return x, aux, (cache if want_cache else None)


def block_cache_zeros(cfg, kind: str, batch: int, s_max: int, dtype,
                      device=None):
    hd, kv = cfg.head_dim, cfg.n_kv_heads
    zeros = (lambda *shape: torch.zeros(shape, dtype=dtype, device=device))
    if kind in ("attn", "attn_moe", "local"):
        n = cfg.griffin.window if kind == "local" else s_max
        return {"k": zeros(batch, n, kv, hd), "v": zeros(batch, n, kv, hd),
                "slot_pos": torch.full((n,), -1, dtype=torch.int32,
                                       device=device)}
    if kind in ("mla_dense", "mla_moe"):
        m = cfg.mla
        return {"latent": zeros(batch, s_max, m.kv_lora_rank),
                "krope": zeros(batch, s_max, m.rope_head_dim)}
    f32 = functools.partial(torch.zeros, dtype=torch.float32, device=device)
    if kind == "mamba":
        di = cfg.ssm.expand * cfg.d_model
        return {"conv": zeros(batch, cfg.ssm.d_conv - 1, di),
                "ssm": f32((batch, di, cfg.ssm.d_state))}
    if kind == "rec":
        w = rglru._width(cfg)
        return {"conv": zeros(batch, cfg.griffin.conv_width - 1, w),
                "h": f32((batch, w))}
    raise ValueError(kind)


def block_apply_decode(p, x, cfg, kind: str, dtype, cache, pos: int):
    """One-token path; ``cache`` is written in place. Returns (x, cache)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind in ("attn", "attn_moe", "local"):
        if kind == "local":
            w = cfg.griffin.window
            out, _, _ = attn.gqa_decode_ring(
                p["attn"], h, cfg, dtype, cache["k"], cache["v"],
                cache["slot_pos"], pos, pos % w, w)
        else:
            out, _, _ = attn.gqa_decode(p["attn"], h, cfg, dtype,
                                        cache["k"], cache["v"], pos)
            cache["slot_pos"][pos] = pos
        x = x + out
    elif kind in ("mla_dense", "mla_moe"):
        out, _, _ = attn.mla_decode(p["attn"], h, cfg, dtype,
                                    cache["latent"], cache["krope"], pos)
        x = x + out
    elif kind == "mamba":
        out, conv, st = ssm.mamba_decode(p["mixer"], h, cfg, dtype,
                                         cache["conv"], cache["ssm"])
        cache["conv"].copy_(conv)
        cache["ssm"].copy_(st)
        return x + out, cache            # the mixer alone: no ln2, no FFN
    elif kind == "rec":
        out, conv, hst = rglru.rglru_decode(p["rec"], h, cfg, dtype,
                                            cache["conv"], cache["h"])
        cache["conv"].copy_(conv)
        cache["h"].copy_(hst)
        x = x + out
    else:
        raise ValueError(kind)
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    y, _ = _ffn_apply(p["ffn"], h2, cfg, kind, dtype)
    return x + y, cache


# ---------------------------------------------------------------------------
# Whole-model spec / apply
# ---------------------------------------------------------------------------

def decoder_specs(cfg) -> Dict[str, Any]:
    segs = []
    for unit, reps in segment_plan(cfg):
        unit_specs = {f"u{i}": block_specs(cfg, kind)
                      for i, kind in enumerate(unit)}
        segs.append(stack(unit_specs, reps) if reps > 1 else unit_specs)
    return {
        "embed": embed_specs(cfg),
        "segments": segs,
        "ln_f": _norm_spec(cfg),
    }


def _layers(seg, reps: int):
    """The per-layer slices of a segment's (stacked when reps > 1) tree."""
    if reps == 1:
        yield seg
        return
    for i in range(reps):
        yield tree_map(lambda a: a[i], seg)


def _unstack(tree, reps: int) -> list:
    """The ``reps`` per-layer trees of a stacked segment, each leaf split
    once with ``unbind``; a segment of one repeat is its own layer."""
    if reps == 1:
        return [tree]
    if isinstance(tree, dict):
        parts = {k: _unstack(v, reps) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(reps)]
    if isinstance(tree, (list, tuple)):
        parts = [_unstack(v, reps) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(reps)]
    return list(tree.unbind(0))


def _remat(fn, cfg):
    """``fn`` under the activation checkpoint ``cfg.remat`` names (None for
    ``"none"``). The recompute runs under the sharding rules active now:
    autograd runs a card's backward on a thread of its own, where the
    thread's rules (``parallel.sharding_rules``) would be missing and the
    MoE layer would regroup its tokens."""
    from ..parallel.sharding import current_rules, use_rules
    rules = current_rules()

    def body(*args):
        with use_rules(rules):
            return fn(*args)
    # the blocks draw no random numbers: no RNG state to keep for the
    # recompute
    ckpt = functools.partial(_ckpt.checkpoint, body, use_reentrant=False,
                             preserve_rng_state=False)
    if cfg.remat == "full":
        return ckpt
    if cfg.remat == "dots":
        aten = torch.ops.aten
        matmuls = {aten.mm.default, aten.bmm.default, aten.addmm.default,
                   aten.baddbmm.default}

        def save_matmuls(ctx, op, *args, **kwargs):
            return (_ckpt.CheckpointPolicy.MUST_SAVE if op in matmuls
                    else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
        return functools.partial(ckpt, context_fn=functools.partial(
            _ckpt.create_selective_checkpoint_contexts, save_matmuls))
    return None


def decoder_forward(params, tokens, cfg, *, prefix_embed=None,
                    want_cache: bool = False, s_max: int = 0,
                    return_hidden: bool = False):
    """Full-seq forward. tokens: (B,S) int. prefix_embed: optional (B,P,d)
    continuous prefix (the VLM patch-embedding stub).

    Returns (logits, aux_loss, cache layers or None)."""
    dtype = torch_dtype(cfg.compute_dtype)
    x = embed_lookup(params["embed"], tokens, dtype)
    if prefix_embed is not None:
        x = torch.cat([prefix_embed.to(dtype), x], dim=1)
    s_max = s_max or x.shape[1]
    aux_total = torch.zeros((), device=x.device)
    caches = decoder_cache_zeros(cfg, x.shape[0], s_max,
                                 device=x.device)["layers"] \
        if want_cache else None
    remat = None
    if torch.is_grad_enabled() and not want_cache:
        remat = _remat(block_apply_full, cfg)
    for j, (seg_params, (unit, reps)) in enumerate(
            zip(params["segments"], segment_plan(cfg))):
        seg_cache = _layers(caches[j], reps) if want_cache \
            else itertools.repeat(None)
        for p_slice, c_slice in zip(_unstack(seg_params, reps), seg_cache):
            for i, kind in enumerate(unit):
                if remat is not None:
                    x, aux, _ = remat(p_slice[f"u{i}"], x, cfg, kind, dtype,
                                      False)
                else:
                    x, aux, _ = block_apply_full(
                        p_slice[f"u{i}"], x, cfg, kind, dtype, want_cache,
                        s_max,
                        cache=c_slice[f"u{i}"] if want_cache else None)
                aux_total = aux_total + aux
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    if return_hidden:
        return x, aux_total, caches
    return unembed(params["embed"], x, dtype), aux_total, caches


def decoder_loss(params, tokens, cfg, prefix_embed=None) -> torch.Tensor:
    """LM loss through ``sharded_softmax_xent``, differentiable in
    ``params`` (leaves that require grad). Placed weights run the
    partitioned program (``_loss_sharded``): the loss is then a
    ``Sharded`` scalar every coordinate holds."""
    if is_placed(params):
        return _loss_sharded(params, tokens, cfg, prefix_embed)
    dtype = torch_dtype(cfg.compute_dtype)
    hidden, aux, _ = decoder_forward(params, tokens, cfg,
                                     prefix_embed=prefix_embed,
                                     return_hidden=True)
    if prefix_embed is not None:
        hidden = hidden[:, prefix_embed.shape[1]:]
    if "out" in params["embed"]:
        w_out = params["embed"]["out"].to(dtype)
    else:
        w_out = params["embed"]["tok"].to(dtype).T
    return sharded_softmax_xent(hidden, w_out, tokens) + 0.01 * aux


def decoder_prefill(params, tokens, cfg, s_max: int, prefix_embed=None):
    """Prefill: the cache filled at ``s_max`` and the logits of the final
    position only (full-sequence logits would be (B·S, V)). Placed weights
    run the partitioned program: the logits are then a ``Sharded`` (B, V)
    split by batch, the cache's leaves ``Sharded`` too."""
    if is_placed(params):
        return _prefill_sharded(params, tokens, cfg, s_max, prefix_embed)
    dtype = torch_dtype(cfg.compute_dtype)
    hidden, _, caches = decoder_forward(params, tokens, cfg,
                                        prefix_embed=prefix_embed,
                                        want_cache=True, s_max=s_max,
                                        return_hidden=True)
    logits = unembed(params["embed"], hidden[:, -1:], dtype)
    pos = tokens.shape[1] + (prefix_embed.shape[1]
                             if prefix_embed is not None else 0)
    return logits[:, 0], {"layers": caches, "pos": pos}


def decoder_cache_zeros(cfg, batch: int, s_max: int, device=None,
                        mesh=None):
    """The decode cache, zeros at ``s_max``: a segment of several repeats
    keeps its per-layer caches stacked on a leading dim, as its
    parameters are. With ``mesh`` (under ``sharding_rules(mesh)``) each
    leaf is a ``Sharded`` laid out by ``launch.steps.cache_shardings``,
    one zero block a device, no whole leaf made."""
    if mesh is not None:
        from ..launch.steps import cache_shardings
        from ..parallel.sharding import sharded_zeros
        shapes = decoder_cache_zeros(cfg, batch, s_max, device="meta")
        laid = cache_shardings(shapes)
        items = tree_items(shapes["layers"])
        flat = [sharded_zeros(t.shape, t.dtype, sh.spec, mesh) for (_, t), sh
                in zip(items, tree_leaves(laid["layers"]))]
        for (path, _), t in zip(items, flat):
            if path.rsplit("/", 1)[-1] == "slot_pos":  # empty slots hold -1
                for b in t.blocks.values():
                    b.fill_(-1)
        return {"layers": tree_unflatten(shapes["layers"], flat), "pos": 0}
    dtype = torch_dtype(cfg.compute_dtype)
    caches = []
    for unit, reps in segment_plan(cfg):
        cache_u = {f"u{i}": block_cache_zeros(cfg, kind, batch, s_max, dtype,
                                              device)
                   for i, kind in enumerate(unit)}
        if reps > 1:
            cache_u = tree_map(
                lambda c: c[None].repeat(reps, *([1] * c.dim())), cache_u)
        caches.append(cache_u)
    return {"layers": caches, "pos": 0}


def decoder_decode_step(params, cache, tokens, cfg):
    """tokens: (B,1). Returns (logits (B,V), cache): the cache's tensors are
    written in place and ``pos`` advances by one. Placed weights run the
    partitioned program (``decoder_prefill``)."""
    if is_placed(params):
        return _decode_step_sharded(params, cache, tokens, cfg)
    dtype = torch_dtype(cfg.compute_dtype)
    pos = int(cache["pos"])
    x = embed_lookup(params["embed"], tokens, dtype)
    for seg_params, seg_cache, (unit, reps) in zip(
            params["segments"], cache["layers"], segment_plan(cfg)):
        for p_slice, c_slice in zip(_layers(seg_params, reps),
                                    _layers(seg_cache, reps)):
            for i, kind in enumerate(unit):
                x, _ = block_apply_decode(p_slice[f"u{i}"], x, cfg, kind,
                                          dtype, c_slice[f"u{i}"], pos)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = unembed(params["embed"], x, dtype)
    return logits[:, 0], {"layers": cache["layers"], "pos": pos + 1}


# ---------------------------------------------------------------------------
# The partitioned serving program (placed weights under a mesh)
# ---------------------------------------------------------------------------

def _rules_of(params):
    """The active rules, whose mesh must be the one ``params`` lie on."""
    from ..parallel.sharding import current_rules
    rules = current_rules()
    mesh = tree_leaves(params)[0].mesh
    if rules is None or rules.mesh is not mesh:
        raise RuntimeError("placed weights run under the sharding_rules of "
                           "the mesh they were placed on")
    return rules


def _stream_spec(rules, shape):
    """The residual stream's layout: batch, the sequence over ``seq_act``."""
    return rules.resolve(("batch", "seq_act", None), shape)


def _embed_sharded(params, tokens, cfg, rules, prefix_embed=None):
    """The token embeddings (and the VLM prefix before them) in the
    residual stream's layout."""
    from ..parallel.sharding import relayout, shard, smap
    from .common import embed_lookup_sharded
    dtype = torch_dtype(cfg.compute_dtype)
    mesh = rules.mesh
    tok = shard(tokens, rules.resolve(("batch", None), tokens.shape), mesh)
    x = embed_lookup_sharded(params["embed"], tok, dtype)
    if prefix_embed is not None:
        # the prefix shifts the tokens' positions: add the vocab's partial
        # sums over the whole sequence before cutting it
        x = relayout(x, x.spec)
        pre = shard(prefix_embed.to(dtype), x.spec, mesh)
        x = smap(lambda a, b: torch.cat([a, b], dim=1), pre, x, spec=x.spec)
    return relayout(x, _stream_spec(rules, x.shape))


def _norm_sharded(x, w, cfg):
    from ..parallel.sharding import smap
    return smap(lambda a, b: rmsnorm(a, b, cfg.norm_eps), x, w, spec=x.spec)


def _ffn_sharded(p, h, cfg, kind, dtype, rules, aux: bool = False):
    """The block's FFN on ``h`` in the stream's layout, back in it, and
    with ``aux`` an MoE layer's aux loss (else None)."""
    from ..parallel.sharding import relayout
    if kind in ("attn_moe", "mla_moe"):
        return ffn.moe_apply_sharded(p, h, cfg, dtype, rules, aux)
    y = ffn.swiglu_apply_sharded(p, relayout(h, (h.spec[0], None, None)),
                                 dtype)
    return relayout(y, h.spec), None


def _write_blocks(cache, names, values) -> None:
    """``values`` (``Sharded``, laid out as the cache leaves ``names``: a
    recurrent block's new states, whisper's cross keys) copied into those
    leaves' blocks. Every value is computed before the first copy:
    coordinates may share a block."""
    for name, v in zip(names, values):
        dst = cache[name]
        if dst.spec != v.spec:
            raise ValueError(f"cache {name!r} laid out {dst.spec}, the "
                             f"value written {v.spec}")
        for c, b in dst.blocks.items():
            b.copy_(v.blocks[c])


def ring_positions(s: int, w: int, lo: int, n: int, device) -> torch.Tensor:
    """The positions slots ``lo``..``lo + n`` of a ``w``-slot ring hold after
    a prefill of ``s`` tokens, as ``_ring_layout`` lays them out (-1
    empty): slot j the last position p < s with p = j mod w."""
    j = torch.arange(lo, lo + n, device=device)
    if s >= w:
        return s - w + torch.remainder(j - s, w)
    return torch.where(j < s, j, -1)


def _ring_block(kb, s: int, w: int, lo: int, n: int):
    """Slots ``lo``..``lo + n`` of the ring from ``kb`` (B, S, KV, hd),
    whole along the sequence: each slot's position gathered, zeros where
    it is empty."""
    pos = ring_positions(s, w, lo, n, kb.device)
    got = kb[:, pos.clamp(min=0)]
    return torch.where((pos >= 0)[None, :, None, None], got,
                       torch.zeros((), dtype=kb.dtype, device=kb.device))


def _write_ring(cache, k, v, s: int, w: int) -> None:
    """A ``local`` block's prefill keys and values (whole along the
    sequence on every shard) written into its ring, split by slot: each
    shard takes the positions its slots hold from its own copy, so nothing
    moves; every shard's ``slot_pos`` is the whole ring's."""
    for name, t in (("k", k), ("v", v)):
        dst = cache[name]
        for c, b in dst.blocks.items():
            b.copy_(_ring_block(t.blocks[c], s, w, dst.index(c)[1].start,
                                b.shape[1]))
    for sp in cache["slot_pos"].blocks.values():
        sp.copy_(ring_positions(s, w, 0, w, sp.device))


def _block_full_sharded(p, x, cfg, kind, dtype, cache, rules,
                        aux: bool = False):
    """``block_apply_full``, partitioned: ``x`` in the stream's layout; with
    a ``cache`` (prefill) its blocks written at their positions (a ring's
    slots, a recurrent block's states), with ``cache`` None (training)
    none kept. Returns (x, the MoE aux loss where ``aux`` asks for it,
    else None)."""
    from ..parallel.sharding import add, relayout, write_prefix
    h = relayout(_norm_sharded(x, p["ln1"], cfg), (x.spec[0], None, None))
    s = x.shape[1]
    if kind == "mamba":
        out, st = ssm.mamba_apply_full_sharded(p["mixer"], h, cfg, dtype,
                                               return_state=cache is not None)
        if cache is not None:
            _write_blocks(cache, ("conv", "ssm"), st)
        return add(x, relayout(out, x.spec)), None     # no ln2, no FFN
    if kind == "rec":
        out, st = rglru.rglru_apply_full_sharded(
            p["rec"], h, cfg, dtype, return_state=cache is not None)
        if cache is not None:
            _write_blocks(cache, ("conv", "h"), st)
    elif kind in ("attn", "attn_moe", "local"):
        window = cfg.griffin.window if kind == "local" else cfg.attn_window
        out, (k, v) = attn.gqa_full_sharded(p["attn"], h, cfg, dtype, rules,
                                            window=window)
        if cache is not None and kind == "local":
            _write_ring(cache, k, v, s, window)
        elif cache is not None:
            write_prefix(cache["k"], 1, k)
            write_prefix(cache["v"], 1, v)
            for sp in cache["slot_pos"].blocks.values():
                t = torch.arange(sp.shape[0], dtype=torch.int32,
                                 device=sp.device)
                sp.copy_(torch.where(t < s, t, -1))
    elif kind in ("mla_dense", "mla_moe"):
        out, (latent, krope) = attn.mla_full_sharded(p["attn"], h, cfg, dtype,
                                                     rules)
        if cache is not None:
            write_prefix(cache["latent"], 1, latent)
            write_prefix(cache["krope"], 1, krope)
    else:
        raise ValueError(f"block kind {kind!r} has no partitioned program")
    del h
    x = add(x, relayout(out, x.spec))
    y, a = _ffn_sharded(p["ffn"], _norm_sharded(x, p["ln2"], cfg), cfg, kind,
                        dtype, rules, aux)
    return add(x, y), a


def _train_block_sharded(p, x, cfg, kind, dtype, rules):
    """A training block: no cache, the aux loss kept."""
    return _block_full_sharded(p, x, cfg, kind, dtype, None, rules, aux=True)


def _block_decode_sharded(p, x, cfg, kind, dtype, cache, pos, rules):
    """``block_apply_decode``, partitioned."""
    from ..parallel.sharding import add, relayout
    h = relayout(_norm_sharded(x, p["ln1"], cfg), (x.spec[0], None, None))
    if kind == "mamba":
        out, conv, st = ssm.mamba_decode_sharded(p["mixer"], h, cfg, dtype,
                                                 cache["conv"], cache["ssm"])
        _write_blocks(cache, ("conv", "ssm"), (conv, st))
        return add(x, relayout(out, x.spec))           # no ln2, no FFN
    if kind == "rec":
        out, conv, hs = rglru.rglru_decode_sharded(p["rec"], h, cfg, dtype,
                                                   cache["conv"], cache["h"])
        _write_blocks(cache, ("conv", "h"), (conv, hs))
    elif kind == "local":
        out = attn.gqa_decode_sharded(p["attn"], h, cfg, dtype, cache["k"],
                                      cache["v"], pos, rules,
                                      window=cfg.griffin.window,
                                      slot_pos=cache["slot_pos"])
    elif kind in ("attn", "attn_moe"):
        out = attn.gqa_decode_sharded(p["attn"], h, cfg, dtype, cache["k"],
                                      cache["v"], pos, rules,
                                      window=cfg.attn_window)
        for sp in cache["slot_pos"].blocks.values():
            sp[pos] = pos
    elif kind in ("mla_dense", "mla_moe"):
        out = attn.mla_decode_sharded(p["attn"], h, cfg, dtype,
                                      cache["latent"], cache["krope"], pos,
                                      rules)
    else:
        raise ValueError(f"block kind {kind!r} has no partitioned program")
    x = add(x, relayout(out, x.spec))
    return add(x, _ffn_sharded(p["ffn"], _norm_sharded(x, p["ln2"], cfg),
                               cfg, kind, dtype, rules)[0])


def _logits_sharded(params, x, cfg):
    """(B, 1, d) hidden, whole on d, to (B, V) logits split by batch."""
    from ..parallel.sharding import smap
    from .common import unembed_sharded
    y = unembed_sharded(params["embed"], x, torch_dtype(cfg.compute_dtype))
    return smap(lambda a: a[:, 0], y, spec=y.spec[:1] + y.spec[2:])


def last_logits_sharded(params, x, cfg):
    """The logits (B, V) of the last position of ``x`` (B, S, d) in the
    stream's layout: each shard's last row, the sequence's last shard's."""
    from ..parallel.sharding import gather, smap
    last = gather(smap(lambda a: a[:, -1:], x, spec=x.spec), 1)
    last = smap(lambda a: a[:, -1:], last, spec=last.spec)
    return _logits_sharded(params, last, cfg)


def _prefill_sharded(params, tokens, cfg, s_max: int, prefix_embed=None):
    rules = _rules_of(params)
    dtype = torch_dtype(cfg.compute_dtype)
    x = _embed_sharded(params, tokens, cfg, rules, prefix_embed)
    b, s, _ = x.shape
    cache = decoder_cache_zeros(cfg, b, s_max or s, mesh=rules.mesh)
    for seg_params, seg_cache, (unit, reps) in zip(
            params["segments"], cache["layers"], segment_plan(cfg)):
        for p_slice, c_slice in zip(_layers(seg_params, reps),
                                    _layers(seg_cache, reps)):
            for i, kind in enumerate(unit):
                x, _ = _block_full_sharded(p_slice[f"u{i}"], x, cfg,
                                           kind, dtype, c_slice[f"u{i}"],
                                           rules)
    cache["pos"] = s
    return last_logits_sharded(params, _norm_sharded(x, params["ln_f"], cfg),
                               cfg), cache


def _decode_step_sharded(params, cache, tokens, cfg):
    rules = _rules_of(params)
    dtype = torch_dtype(cfg.compute_dtype)
    pos = int(cache["pos"])
    x = _embed_sharded(params, tokens, cfg, rules)
    for seg_params, seg_cache, (unit, reps) in zip(
            params["segments"], cache["layers"], segment_plan(cfg)):
        for p_slice, c_slice in zip(_layers(seg_params, reps),
                                    _layers(seg_cache, reps)):
            for i, kind in enumerate(unit):
                x = _block_decode_sharded(p_slice[f"u{i}"], x, cfg, kind,
                                          dtype, c_slice[f"u{i}"], pos,
                                          rules)
    x = _norm_sharded(x, params["ln_f"], cfg)
    return _logits_sharded(params, x, cfg), {"layers": cache["layers"],
                                             "pos": pos + 1}


def _loss_sharded(params, tokens, cfg, prefix_embed=None):
    """``decoder_loss`` on placed weights: the embedding, every block in
    the stream's layout (each under ``_remat`` when grad is enabled, its
    recompute re-entering the rules), ``ln_f`` and the partitioned loss
    (``common.sharded_softmax_xent_partitioned``, targets rolled with the
    patch prefix masked), plus 0.01 · the MoE layers' aux losses. Returns
    a ``Sharded`` scalar every coordinate holds; its backward runs every
    collective's dual (``parallel.mesh``)."""
    from ..parallel.sharding import add, shard, smap
    from .common import (rolled_targets, sharded_softmax_xent_partitioned,
                         unembed_weight_sharded)
    rules = _rules_of(params)
    dtype = torch_dtype(cfg.compute_dtype)
    x = _embed_sharded(params, tokens, cfg, rules, prefix_embed)
    run = _remat(_train_block_sharded, cfg) if torch.is_grad_enabled() \
        else None
    run = run or _train_block_sharded
    aux = None
    for seg_params, (unit, reps) in zip(params["segments"],
                                        segment_plan(cfg)):
        for p_slice in _unstack(seg_params, reps):
            for i, kind in enumerate(unit):
                x, a = run(p_slice[f"u{i}"], x, cfg, kind, dtype, rules)
                if a is not None:
                    aux = a if aux is None else add(aux, a)
    x = _norm_sharded(x, params["ln_f"], cfg)
    prefix = prefix_embed.shape[1] if prefix_embed is not None else 0
    targets = shard(rolled_targets(tokens, prefix), x.spec[:2], rules.mesh)
    loss = sharded_softmax_xent_partitioned(
        x, unembed_weight_sharded(params["embed"], dtype), targets)
    if aux is None:
        return loss
    return smap(lambda a, b: a + 0.01 * b, loss, aux, spec=())
