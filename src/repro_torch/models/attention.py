"""Attention variants: GQA/MHA (+bias), sliding-window, MLA and
cross-attention (whisper's decoder), mirroring
``src/repro/models/attention.py``.

Each variant has a full-sequence path (train / prefill; it also returns the
compact keys and values the cache keeps) and a one-token decode path
against a cache preallocated at ``s_max``. The decode paths write the new
token's entries into the cache tensors in place and return them; ``pos`` is
a Python int, so a step never waits on the device to learn it.

No TPU kernel lies here: these are torch ops in the reference's order and
casts. Prompts longer than ``CHUNKED_THRESHOLD`` take ``_sdpa_chunked``,
the reference's online-softmax blocking over keys, which bounds the live
scores at one key block: every query block goes through one tensor op per
key block (query rows are independent, so batching them changes no sum),
and only the key blocks are a loop.

Under a mesh, with the weights placed (``models.params.place_params``),
``gqa_full_sharded``, ``gqa_decode_sharded`` (a ring's too),
``mla_full_sharded`` and ``mla_decode_sharded`` run the partitioned program on
``parallel.sharding.Sharded`` tensors. Each ``"model"`` shard computes
its own heads where the rules split the heads (``"heads"``), all of them
where they do not; a projection whose flat ``qkv_flat`` split falls
inside a head (or across heads the rules keep whole) is all-gathered on
its flat dim first, and keys and values always are, since the cache
holds every kv head. ``wo`` is row-parallel: its output holds partial
sums for the caller to reduce. The decode caches are split by sequence
(``("batch", "seq_shard")``): a token's entries are written on the shard
that owns its position, and decode is a flash-decode merge: each shard
scores every head over its own positions and keeps its maxima, sums and
weighted values; an all-gather of the maxima and a reduce-scatter (an
all-reduce where the heads are whole) of the rescaled sums and values
give each shard its heads' attention. Cross-attention
(``cross_kv_sharded``, ``cross_apply_sharded``) keeps its keys and values
by heads: each shard projects, caches and attends its own heads only.
"""
from __future__ import annotations

import torch

from .common import apply_rope, rmsnorm, rope_angles
from .params import Spec

NEG_INF = -1e30
CHUNKED_THRESHOLD = 1024


def _pos_tensor(pos, device) -> torch.Tensor:
    return torch.tensor([int(pos)], dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# GQA / MHA
# ---------------------------------------------------------------------------

def gqa_specs(cfg) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    s = {
        "wq": Spec((d, h * hd), ("fsdp", "qkv_flat")),
        "wk": Spec((d, kv * hd), ("fsdp", "qkv_flat")),
        "wv": Spec((d, kv * hd), ("fsdp", "qkv_flat")),
        "wo": Spec((h * hd, d), ("qkv_flat", "fsdp")),
    }
    if cfg.qkv_bias:
        s["bq"] = Spec((h * hd,), ("qkv_flat",), init="zeros")
        s["bk"] = Spec((kv * hd,), ("qkv_flat",), init="zeros")
        s["bv"] = Spec((kv * hd,), ("qkv_flat",), init="zeros")
    return s


def _project_qkv(p, x, cfg, dtype):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"].to(dtype)
    k = x @ p["wk"].to(dtype)
    v = x @ p["wv"].to(dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    return (q.reshape(b, s, h, hd), k.reshape(b, s, kv, hd),
            v.reshape(b, s, kv, hd))


def _sdpa(q, k, v, mask, n_kv: int) -> torch.Tensor:
    """q: (B,S,H,hd), k/v: (B,T,KV,hd), mask: (S,T) or (B,S,T) bool."""
    b, s, h, hd = q.shape
    g = h // n_kv
    q = q.reshape(b, s, n_kv, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", q, k).to(torch.float32)
    scores = scores * (hd ** -0.5)
    if mask is not None:
        mask_b = mask[None, None, None] if mask.dim() == 2 \
            else mask[:, None, None]
        scores = torch.where(mask_b, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(b, s, h, v.shape[-1])


def _pick_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is ≤ target (whisper's 1500 → 500)."""
    c = min(target, n)
    while n % c:
        c -= 1
    return c


def _sdpa_chunked(q, k, v, n_kv: int, causal: bool, window: int,
                  chunk_q: int = 512, chunk_k: int = 512) -> torch.Tensor:
    """Flash-style online-softmax attention over key blocks of
    ``_pick_chunk(T, chunk_k)``: running (max, denominator, accumulator) a
    query row, never the (S, T) score matrix. The reference also blocks the
    queries (``chunk_q``) and maps over the blocks; each query row's sums
    are the same either way, so here all query rows go through each key
    block's step together."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    hv = v.shape[-1]                 # may differ from hd (MLA: 192 vs 128)
    g = h // n_kv
    ck = _pick_chunk(t, chunk_k)
    scale = hd ** -0.5
    qg = q.reshape(b, s, n_kv, g, hd)
    q_pos = torch.arange(s, device=q.device)
    m = torch.full((b, n_kv, g, s), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, n_kv, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n_kv, g, s, hv), dtype=torch.float32,
                      device=q.device)
    for lo in range(0, t, ck):
        k_tile, v_tile = k[:, lo:lo + ck], v[:, lo:lo + ck]
        k_pos = lo + torch.arange(ck, device=q.device)
        s_blk = torch.einsum("bqkgh,btkh->bkgqt", qg, k_tile)
        s_blk = (s_blk * scale).to(torch.float32)
        mask = None
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
        if window:
            near = q_pos[:, None] - k_pos[None, :] < window
            mask = near if mask is None else mask & near
        if mask is not None:
            s_blk = torch.where(mask, s_blk, NEG_INF)
        m_new = torch.maximum(m, s_blk.amax(-1))
        p_blk = torch.exp(s_blk - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p_blk.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqt,btkh->bkgqh", p_blk.to(v_tile.dtype), v_tile
        ).to(torch.float32)
        m = m_new
        del s_blk, p_blk
    out = acc / torch.clamp(l, min=1e-30)[..., None]     # (B,KV,g,S,hv)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hv)
    return out.to(q.dtype)


def _attend(q, k, v, window: int, causal: bool = True):
    """Attention of (B, S, H, hd) queries over keys and values of as many
    heads (causal, within ``window`` where one is given): ``_sdpa``, or
    ``_sdpa_chunked`` past ``CHUNKED_THRESHOLD``."""
    s, n = q.shape[1], q.shape[2]
    if s > CHUNKED_THRESHOLD:
        return _sdpa_chunked(q, k, v, n, causal, window)
    mask = causal_mask(s, window, q.device) if causal else None
    return _sdpa(q, k, v, mask, n)


def causal_mask(s: int, window: int = 0, device=None) -> torch.Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    m = j <= i
    if window:
        m = m & (i - j < window)
    return m


def gqa_full(p, x, cfg, dtype, window: int = 0, causal: bool = True,
             return_kv: bool = False):
    """Train / prefill path. Returns (out, (k, v) or None); KV heads are
    repeated up to the head count for the scores, the returned (k, v) keep
    the compact KV-head layout the cache holds."""
    s = x.shape[1]
    q, k, v = _project_qkv(p, x, cfg, dtype)
    pos = torch.arange(s, device=x.device)
    cos, sin = rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    kv_compact = (k, v)
    g = cfg.n_heads // cfg.n_kv_heads
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    out = _attend(q, k, v, window, causal)
    out = out.reshape(*x.shape[:2], -1) @ p["wo"].to(dtype)
    return (out, kv_compact) if return_kv else (out, None)


def gqa_decode(p, x, cfg, dtype, cache_k, cache_v, pos: int,
               window: int = 0):
    """One-token decode. cache_k/v: (B, S_max, KV, hd), written at ``pos``
    in place. Returns (out, cache_k, cache_v)."""
    b = x.shape[0]
    s_max = cache_k.shape[1]
    q, k, v = _project_qkv(p, x, cfg, dtype)          # S = 1
    cos, sin = rope_angles(_pos_tensor(pos, x.device), cfg.head_dim,
                           cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    cache_k[:, pos] = k[:, 0]
    cache_v[:, pos] = v[:, 0]
    t_idx = torch.arange(s_max, device=x.device)
    mask = t_idx <= pos
    if window:
        mask = mask & (t_idx > pos - window)
    out = _sdpa(q, cache_k, cache_v, mask[None, :], cfg.n_kv_heads)
    out = out.reshape(b, 1, -1) @ p["wo"].to(dtype)
    return out, cache_k, cache_v


def gqa_decode_ring(p, x, cfg, dtype, cache_k, cache_v, slot_pos, pos: int,
                    slot: int, window: int):
    """Sliding-window decode against a ring buffer of W slots.

    cache_k/v: (B, W, KV, hd); slot_pos: (W,) absolute position stored in
    each slot (-1 = empty); all three are written at ``slot`` in place. Keys
    carry RoPE at their absolute positions, so scores stay correct whatever
    the ring's layout."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, dtype)
    cos, sin = rope_angles(_pos_tensor(pos, x.device), cfg.head_dim,
                           cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    slot_pos[slot] = pos
    mask = (slot_pos >= 0) & (slot_pos > pos - window)
    out = _sdpa(q, cache_k, cache_v, mask[None, :], cfg.n_kv_heads)
    out = out.reshape(b, 1, -1) @ p["wo"].to(dtype)
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank latent KV, absorbed decode
# ---------------------------------------------------------------------------

def mla_specs(cfg) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qd = m.nope_head_dim + m.rope_head_dim
    return {
        "wq": Spec((d, h * qd), ("fsdp", "qkv_flat")),
        "w_dkv": Spec((d, m.kv_lora_rank + m.rope_head_dim), ("fsdp", None)),
        "kv_norm": Spec((m.kv_lora_rank,), (None,), init="ones"),
        "w_uk": Spec((m.kv_lora_rank, h, m.nope_head_dim),
                     (None, "heads", None)),
        "w_uv": Spec((m.kv_lora_rank, h, m.v_head_dim),
                     (None, "heads", None)),
        "wo": Spec((h * m.v_head_dim, d), ("qkv_flat", "fsdp")),
    }


def _mla_q(p, x, cfg, dtype, positions):
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    qd = m.nope_head_dim + m.rope_head_dim
    return _mla_q_split((x @ p["wq"].to(dtype)).reshape(b, s, h, qd), cfg,
                        positions)


def _mla_q_split(q, cfg, positions):
    """(B, S, H, nope + rope) queries as (nope part, rope part with RoPE)."""
    m = cfg.mla
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    cos, sin = rope_angles(positions, m.rope_head_dim, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, cos, sin)


def _mla_latent(p, x, cfg, dtype, positions):
    m = cfg.mla
    ckv = x @ p["w_dkv"].to(dtype)
    latent = rmsnorm(ckv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = ckv[..., m.kv_lora_rank:][:, :, None, :]    # (B,S,1,rope_d)
    cos, sin = rope_angles(positions, m.rope_head_dim, cfg.rope_theta)
    k_rope = apply_rope(k_rope, cos, sin)[:, :, 0, :]
    return latent, k_rope


def mla_full(p, x, cfg, dtype, return_kv: bool = False):
    """Train / prefill: per-head K/V materialized from the latent. Returns
    (out, (latent, k_rope) or None)."""
    m = cfg.mla
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, dtype, positions)
    latent, k_rope = _mla_latent(p, x, cfg, dtype, positions)
    k_nope = torch.einsum("bsl,lhn->bshn", latent, p["w_uk"].to(dtype))
    v = torch.einsum("bsl,lhv->bshv", latent, p["w_uv"].to(dtype))
    # the decoupled-rope score split as one concat-head attention:
    # score = q_nope·k_nope + q_rope·k_rope (k_rope shared across heads)
    h = cfg.n_heads
    qc = torch.cat([q_nope, q_rope], dim=-1)
    kc = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_rope.shape[:2], h, m.rope_head_dim)], dim=-1)
    del k_nope
    out = _attend(qc, kc, v, 0)
    out = out.reshape(b, s, -1) @ p["wo"].to(dtype)
    return (out, (latent, k_rope)) if return_kv else (out, None)


def mla_decode(p, x, cfg, dtype, cache_latent, cache_krope, pos: int):
    """Absorbed decode: W_uk folded into the query, scored in latent space
    against the (B, S_max, kv_lora) cache. cache_latent / cache_krope
    (B, S_max, rope_d) are written at ``pos`` in place."""
    m = cfg.mla
    b = x.shape[0]
    posv = _pos_tensor(pos, x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, dtype, posv)
    latent_t, krope_t = _mla_latent(p, x, cfg, dtype, posv)
    cache_latent[:, pos] = latent_t[:, 0]
    cache_krope[:, pos] = krope_t[:, 0]
    q_lat = torch.einsum("bshn,lhn->bshl", q_nope, p["w_uk"].to(dtype))
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    scores = (torch.einsum("bshl,btl->bhst", q_lat, cache_latent)
              + torch.einsum("bshr,btr->bhst", q_rope, cache_krope)
              ).to(torch.float32)
    scores = scores * scale
    t_idx = torch.arange(cache_latent.shape[1], device=x.device)
    scores = torch.where((t_idx <= pos)[None, None, None, :], scores,
                         NEG_INF)
    w = torch.softmax(scores, dim=-1).to(dtype)
    ctx = torch.einsum("bhst,btl->bshl", w, cache_latent)    # (B,1,H,L)
    out = torch.einsum("bshl,lhv->bshv", ctx, p["w_uv"].to(dtype))
    out = out.reshape(b, 1, -1) @ p["wo"].to(dtype)
    return out, cache_latent, cache_krope


# ---------------------------------------------------------------------------
# The partitioned program (placed weights under a mesh)
# ---------------------------------------------------------------------------

def _project_sharded(p, w: str, bias: str, x, dtype):
    """``x @ p[w] (+ p[bias])`` with ``x`` (B, S, d) whole on ``d``: the
    weight's ``fsdp`` rows all-gathered for the call, its columns as the
    rules split them."""
    from ..parallel.sharding import gather, matmul, smap
    y = matmul(x, gather(p[w], 0), dtype)
    if bias in p:
        y = smap(lambda a, c: a + c.to(dtype), y, p[bias], spec=y.spec)
    return y


def _heads_sharded(y, hd: int, own):
    """``y`` (B, S, H·hd) as (B, S, H, hd), split by heads where its flat
    split is ``own`` (the rules' heads split), else every head on every
    shard: a flat dim split another way (inside a head, or across heads the
    rules keep whole) is all-gathered first."""
    from ..parallel.sharding import gather, smap
    if y.spec[-1] is not None and y.spec[-1] != own:
        y = gather(y, -1)
    return smap(lambda a: a.reshape(*a.shape[:-1], -1, hd), y,
                spec=y.spec[:-1] + (y.spec[-1], None))


def _out_sharded(p, o, dtype):
    """``o`` (B, S, H·hv), split by heads or whole, through ``wo``: cut to
    ``wo``'s row split (no communication where the heads are whole), then a
    row-parallel product of partial sums over those rows' axes."""
    from ..parallel.sharding import gather, matmul, relayout
    wo = gather(p["wo"], 1)
    return matmul(relayout(o, o.spec[:-1] + (wo.spec[0],)), wo, dtype)


def _positions(cache, block, at, pos: int, window: int = 0,
               slot_pos=None):
    """Which slots of ``block``, ``cache``'s block at ``at`` (split along
    dim 1), a decode at ``pos`` attends: the positions at or before it
    (and within ``window``); in a ring (``slot_pos``, the (W,) position
    each slot holds, -1 empty) the slots holding one within the window."""
    from ..parallel.sharding import entry_pos
    n, entry = block.shape[1], cache.spec[1]
    lo = entry_pos(entry, cache.mesh, at) * n if entry is not None else 0
    if slot_pos is not None:
        t = slot_pos[lo:lo + n]
        return (t >= 0) & (t > pos - window)
    t = lo + torch.arange(n, device=block.device)
    valid = t <= pos
    if window:
        valid = valid & (t > pos - window)
    return valid


def _merge_heads(m, l, acc, seq, own):
    """The flash-decode merge: ``m``, ``l`` (B, H) and ``acc`` (B, H, hv),
    float32, each shard's maxima, sums and weighted values over its block of
    a cache split along ``seq`` (None: whole, nothing to merge). Every
    shard's maxima are all-gathered; each rescales its sums and values to
    the global maximum, and a reduce over ``seq``'s axes adds them, cut by
    ``own`` heads. Returns the attention (B, H, hv), float32."""
    from ..parallel.sharding import gather, relayout, smap, spec_axes
    if seq is None:
        return smap(lambda a, b: a / b[..., None], acc, l, spec=acc.spec)
    bat = m.spec[0]
    ms = gather(smap(lambda a: a[None], m, spec=(seq,) + m.spec), 0)

    def rescale(mb, mall, lb, ab):
        e = torch.exp(mb - mall.amax(0))
        return torch.cat([ab * e[..., None], (lb * e)[..., None]], -1)
    packed = smap(rescale, m, ms, l, acc, spec=acc.spec,
                  partial=spec_axes(seq))
    packed = relayout(packed, (bat, own, None))
    return smap(lambda a: a[..., :-1] / a[..., -1:], packed,
                spec=packed.spec)


def gqa_full_sharded(p, x, cfg, dtype, rules, window: int = 0,
                     causal: bool = True):
    """Prefill on placed weights, ``x`` (B, S, d) with S and d whole on each
    shard (``causal`` False: the encoder's unmasked attention). Returns
    ``(out, (k, v))``: ``out`` (B, S, d) partial sums over ``wo``'s row
    axes, ``k``/``v`` (B, S, KV, hd) with every kv head (keys with RoPE),
    as the cache keeps them. A shard's query heads attend the kv heads
    repeated to the head count and cut to its own."""
    from ..parallel.sharding import entry_pos, smap
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    own = rules.resolve(("heads",), (h,))[0]
    q = _heads_sharded(_project_sharded(p, "wq", "bq", x, dtype), hd, own)
    k = _heads_sharded(_project_sharded(p, "wk", "bk", x, dtype), hd, None)
    v = _heads_sharded(_project_sharded(p, "wv", "bv", x, dtype), hd, None)
    heads, g, mesh = q.spec[2], h // kv, x.mesh

    def core(qb, kb, vb, at):
        cos, sin = rope_angles(torch.arange(qb.shape[1], device=qb.device),
                               hd, cfg.rope_theta)
        qb, kb = apply_rope(qb, cos, sin), apply_rope(kb, cos, sin)
        kr, vr = kb, vb
        if g > 1:
            kr = torch.repeat_interleave(kb, g, dim=2)
            vr = torch.repeat_interleave(vb, g, dim=2)
        if heads is not None:
            n = qb.shape[2]
            lo = entry_pos(heads, mesh, at) * n
            kr, vr = kr[:, :, lo:lo + n], vr[:, :, lo:lo + n]
        out = _attend(qb, kr, vr, window, causal)
        return out.reshape(*out.shape[:2], -1), kb
    bat = x.spec[0]
    o, k = smap(core, q, k, v, spec=[(bat, None, heads),
                                     (bat, None, None, None)], at=True)
    return _out_sharded(p, o, dtype), (k, v)


def gqa_decode_sharded(p, x, cfg, dtype, cache_k, cache_v, pos: int, rules,
                       window: int = 0, slot_pos=None):
    """One-token decode on placed weights against ``cache_k``/``cache_v``
    (B, S_max, KV, hd) split by sequence; the token's entries are written
    on the shard owning ``pos``. Every shard scores every head over its
    positions (``_merge_heads``). With ``slot_pos`` (a ``Sharded`` (W,),
    whole on every shard) the caches are ``gqa_decode_ring``'s ring of W
    slots: the token goes to slot ``pos % W``. Returns ``out`` (B, 1, d),
    partial sums over ``wo``'s row axes."""
    from ..parallel.sharding import smap, write_index
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    own = rules.resolve(("heads",), (h,))[0]
    q = _heads_sharded(_project_sharded(p, "wq", "bq", x, dtype), hd, None)
    k = _heads_sharded(_project_sharded(p, "wk", "bk", x, dtype), hd, None)
    v = _heads_sharded(_project_sharded(p, "wv", "bv", x, dtype), hd, None)

    def rope(qb, kb):
        cos, sin = rope_angles(_pos_tensor(pos, qb.device), hd,
                               cfg.rope_theta)
        return apply_rope(qb, cos, sin), apply_rope(kb, cos, sin)
    q, k = smap(rope, q, k, spec=[q.spec, k.spec])
    slot = pos if slot_pos is None else pos % cache_k.shape[1]
    write_index(cache_k, 1, slot, k)
    write_index(cache_v, 1, slot, v)
    if slot_pos is not None:
        for sp in slot_pos.blocks.values():
            sp[slot] = pos

    def part(qb, kb, vb, sp, at):
        b, _, n, _ = qb.shape
        valid = _positions(cache_k, kb, at, pos, window, sp)
        s = torch.einsum("bskgh,btkh->bkgst", qb.reshape(b, 1, kv, n // kv,
                                                         hd),
                         kb).to(torch.float32) * (hd ** -0.5)
        s = torch.where(valid, s, NEG_INF)
        m = s.amax(-1)
        e = torch.exp(s - m[..., None])
        acc = torch.einsum("bkgst,btkh->bkgsh", e.to(vb.dtype), vb)
        return (m.reshape(b, n), e.sum(-1).reshape(b, n),
                acc.to(torch.float32).reshape(b, n, -1))
    bat = x.spec[0]
    m, l, acc = smap(part, q, cache_k, cache_v, slot_pos,
                     spec=[(bat, None), (bat, None), (bat, None, None)],
                     at=True)
    o = _merge_heads(m, l, acc, cache_k.spec[1], own)
    o = smap(lambda a: a.to(dtype).reshape(a.shape[0], 1, -1), o,
             spec=(bat, None, o.spec[1]))
    return _out_sharded(p, o, dtype)


def mla_full_sharded(p, x, cfg, dtype, rules):
    """MLA prefill on placed weights, ``x`` (B, S, d) with S and d whole.
    The latent and the shared rope key are computed on every shard (their
    projection is not split over ``"model"``), each shard's heads from them
    by its blocks of ``w_uk``/``w_uv``. Returns ``(out, (latent,
    k_rope))``, ``out`` partial sums over ``wo``'s row axes."""
    from ..parallel.sharding import gather, smap
    m, h = cfg.mla, cfg.n_heads
    qd = m.nope_head_dim + m.rope_head_dim
    own = rules.resolve(("heads",), (h,))[0]
    q = _heads_sharded(_project_sharded(p, "wq", "bq", x, dtype), qd, own)
    heads = q.spec[2]
    if p["w_uk"].spec[1] != heads or p["w_uv"].spec[1] != heads:
        raise ValueError(f"MLA queries by heads {heads!r} against w_uk "
                         f"{p['w_uk'].spec} and w_uv {p['w_uv'].spec}")

    def core(xb, qb, wd, kvn, wuk, wuv):
        s, n = qb.shape[1], qb.shape[2]
        positions = torch.arange(s, device=xb.device)
        q_nope, q_rope = _mla_q_split(qb, cfg, positions)
        latent, k_rope = _mla_latent({"w_dkv": wd, "kv_norm": kvn}, xb, cfg,
                                     dtype, positions)
        k_nope = torch.einsum("bsl,lhn->bshn", latent, wuk.to(dtype))
        v = torch.einsum("bsl,lhv->bshv", latent, wuv.to(dtype))
        qc = torch.cat([q_nope, q_rope], dim=-1)
        kc = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            *k_rope.shape[:2], n, m.rope_head_dim)], dim=-1)
        out = _attend(qc, kc, v, 0)
        return out.reshape(*out.shape[:2], -1), latent, k_rope
    bat = x.spec[0]
    o, latent, k_rope = smap(core, x, q, gather(p["w_dkv"], 0), p["kv_norm"],
                             p["w_uk"], p["w_uv"],
                             spec=[(bat, None, heads), (bat, None, None),
                                   (bat, None, None)])
    return _out_sharded(p, o, dtype), (latent, k_rope)


def mla_decode_sharded(p, x, cfg, dtype, cache_latent, cache_krope,
                       pos: int, rules):
    """Absorbed MLA decode on placed weights against the latent caches
    (B, S_max, kv_lora) and (B, S_max, rope_d) split by sequence: each
    shard folds ``w_uk`` into its heads' queries, the folded queries of all
    heads are gathered where the cache is split, and the flash-decode merge
    gives each shard its heads' latent context, which its ``w_uv`` block
    and ``wo``'s rows turn into partial sums."""
    from ..parallel.sharding import gather, smap, write_index
    m, h = cfg.mla, cfg.n_heads
    qd = m.nope_head_dim + m.rope_head_dim
    own = rules.resolve(("heads",), (h,))[0]
    q = _heads_sharded(_project_sharded(p, "wq", "bq", x, dtype), qd, own)
    heads = q.spec[2]

    def local(xb, qb, wd, kvn, wuk):
        posv = _pos_tensor(pos, xb.device)
        q_nope, q_rope = _mla_q_split(qb, cfg, posv)
        latent, krope = _mla_latent({"w_dkv": wd, "kv_norm": kvn}, xb, cfg,
                                    dtype, posv)
        q_lat = torch.einsum("bshn,lhn->bshl", q_nope, wuk.to(dtype))
        return q_lat, q_rope, latent, krope
    bat = x.spec[0]
    q_lat, q_rope, latent, krope = smap(
        local, x, q, gather(p["w_dkv"], 0), p["kv_norm"], p["w_uk"],
        spec=[(bat, None, heads, None)] * 2 + [(bat, None, None)] * 2)
    write_index(cache_latent, 1, pos, latent)
    write_index(cache_krope, 1, pos, krope)
    seq = cache_latent.spec[1]
    if seq is not None:
        q_lat, q_rope = gather(q_lat, 2), gather(q_rope, 2)
    scale = qd ** -0.5

    def part(ql, qr, cl, ck, at):
        s = (torch.einsum("bshl,btl->bhst", ql, cl)
             + torch.einsum("bshr,btr->bhst", qr, ck)).to(torch.float32)
        s = torch.where(_positions(cache_latent, cl, at, pos), s * scale,
                        NEG_INF)
        mx = s.amax(-1)
        e = torch.exp(s - mx[..., None])
        acc = torch.einsum("bhst,btl->bhsl", e.to(cl.dtype), cl)
        return mx[..., 0], e.sum(-1)[..., 0], acc[:, :, 0].to(torch.float32)
    hs = q_lat.spec[2]
    mx, l, acc = smap(part, q_lat, q_rope, cache_latent, cache_krope,
                      spec=[(bat, hs), (bat, hs), (bat, hs, None)], at=True)
    ctx = _merge_heads(mx, l, acc, seq, heads)

    def values(c, wuv):
        out = torch.einsum("bshl,lhv->bshv", c.to(dtype)[:, None],
                           wuv.to(dtype))
        return out.reshape(c.shape[0], 1, -1)
    o = smap(values, ctx, p["w_uv"], spec=(bat, None, heads))
    return _out_sharded(p, o, dtype)


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder)
# ---------------------------------------------------------------------------

def cross_specs(cfg) -> dict:
    d, hd, h = cfg.d_model, cfg.head_dim, cfg.n_heads
    return {
        "wq": Spec((d, h * hd), ("fsdp", "qkv_flat")),
        "wk": Spec((d, h * hd), (None, "qkv_flat")),
        "wv": Spec((d, h * hd), (None, "qkv_flat")),
        "wo": Spec((h * hd, d), ("qkv_flat", "fsdp")),
    }


def cross_kv(p, enc_out, cfg, dtype):
    """The encoder states' keys and values, (B, T_enc, H, hd) each."""
    b, t, _ = enc_out.shape
    h, hd = cfg.n_heads, cfg.head_dim
    k = (enc_out @ p["wk"].to(dtype)).reshape(b, t, h, hd)
    v = (enc_out @ p["wv"].to(dtype)).reshape(b, t, h, hd)
    return k, v


def cross_apply(p, x, k, v, cfg, dtype):
    """Unmasked attention of ``x`` over the encoder's keys and values, one
    ``_sdpa`` whatever T_enc is, as the reference's."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = (x @ p["wq"].to(dtype)).reshape(b, s, h, hd)
    out = _sdpa(q, k, v, None, h)
    return out.reshape(b, s, -1) @ p["wo"].to(dtype)


def cross_kv_sharded(p, enc, cfg, dtype, rules):
    """``cross_kv`` on placed weights: ``enc`` the encoder states (B, T, d)
    with T and d whole. ``wk``/``wv`` are column-parallel: each shard makes
    its own heads' keys and values, (B, T, H, hd) split by heads as the
    cache's ``ck``/``cv`` lay them out (every head where the rules keep
    the heads whole)."""
    h, hd = cfg.n_heads, cfg.head_dim
    own = rules.resolve(("heads",), (h,))[0]
    return tuple(_heads_sharded(_project_sharded(p, w, "b" + w[1], enc,
                                                 dtype), hd, own)
                 for w in ("wk", "wv"))


def cross_apply_sharded(p, x, k, v, cfg, dtype, rules):
    """``cross_apply`` on placed weights: ``x`` (B, S, d) with S and d
    whole, ``k``/``v`` split by heads (``cross_kv_sharded``, or the
    cache's). Each shard's queries attend its own heads' keys, nothing
    gathered; ``wo`` row-parallel: the output holds partial sums over its
    row axes."""
    from ..parallel.sharding import smap
    h, hd = cfg.n_heads, cfg.head_dim
    q = _heads_sharded(_project_sharded(p, "wq", "bq", x, dtype), hd,
                       rules.resolve(("heads",), (h,))[0])
    if q.spec[2] != k.spec[2] or k.spec[2] != v.spec[2]:
        raise ValueError(f"cross-attention queries by heads {q.spec[2]!r} "
                         f"against keys {k.spec} and values {v.spec}")

    def core(qb, kb, vb):
        out = _sdpa(qb, kb, vb, None, qb.shape[2])
        return out.reshape(*out.shape[:2], -1)
    o = smap(core, q, k, v, spec=(x.spec[0], None, q.spec[2]))
    return _out_sharded(p, o, dtype)
