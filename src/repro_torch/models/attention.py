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
    n_kv = cfg.n_heads
    if s > CHUNKED_THRESHOLD:
        out = _sdpa_chunked(q, k, v, n_kv, causal, window)
    else:
        mask = causal_mask(s, window, x.device) if causal else None
        out = _sdpa(q, k, v, mask, n_kv)
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
    q = (x @ p["wq"].to(dtype)).reshape(b, s, h, qd)
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
    if s > CHUNKED_THRESHOLD:
        out = _sdpa_chunked(qc, kc, v, h, causal=True, window=0)
    else:
        out = _sdpa(qc, kc, v, causal_mask(s, device=x.device), h)
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
