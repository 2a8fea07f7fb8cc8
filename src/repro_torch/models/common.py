"""Shared layers: norms, RoPE, embeddings, losses, mirroring
``src/repro/models/common.py``.

The casts come in the reference's order, which is what keeps bfloat16
results alongside its: ``rmsnorm`` reduces in float32 and multiplies in
``x.dtype``, RoPE rotates in float32 and casts back, the losses work in
float32.

Under a mesh, with the weights placed (``models.params.place_params``),
the partitioned program embeds and unembeds by vocab block
(``embed_lookup_sharded``, ``unembed_sharded``): the tables' ``fsdp`` dim
gathered over the data axes for the call, each ``"model"`` shard looking
up or scoring its own rows of the vocab. A vocab the rules leave whole
runs unsplit. The training loss (``sharded_softmax_xent_partitioned``)
keeps the logits by position, as the reference's does: the unembedding
weight is gathered whole instead.
"""
from __future__ import annotations

import torch

from .params import Spec


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Variance in float32, the scale multiply in ``x.dtype``."""
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * w.to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.to(torch.float32) + b.to(torch.float32)).to(dt)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int -> cos/sin (..., head_dim/2), float32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2)."""
    dt = x.dtype
    x = x.to(torch.float32)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``), with no switch to ``x`` above a threshold as
    ``F.softplus`` has."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def linear_scan(a: torch.Tensor, b: torch.Tensor):
    """The recurrence ``h_t = a_t·h_{t-1} + b_t`` along dim 1 from
    ``h_{-1} = 0``, and the running products ``a_0···a_t``: the pair
    ``jax.lax.associative_scan`` gives for the combine ``(a_l·a_r,
    a_r·b_l + b_r)``, here in ⌈log₂ C⌉ doubling passes over the C steps
    (each step t combined with step t − 2ʲ). Every pass is a tensor op over
    the whole chunk, differentiable; the sums come in another order than
    the reference's, so results agree within rounding, not bit for bit."""
    n = a.shape[1]
    d = 1
    while d < n:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a, b


# --- embeddings -------------------------------------------------------------

def embed_specs(cfg) -> dict:
    s = {"tok": Spec((cfg.vocab, cfg.d_model), ("vocab", "fsdp"),
                     scale=cfg.d_model ** -0.5)}
    if not cfg.tie_embeddings:
        s["out"] = Spec((cfg.d_model, cfg.vocab), ("fsdp", "vocab"))
    return s


def embed_lookup(params: dict, tokens: torch.Tensor,
                 compute_dtype) -> torch.Tensor:
    return params["tok"].to(compute_dtype)[tokens.long()]


def unembed(params: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    if "out" in params:
        w = params["out"].to(compute_dtype)
    else:
        w = params["tok"].to(compute_dtype).T
    return x @ w


def embed_lookup_sharded(params: dict, tokens, compute_dtype):
    """Token embeddings from placed tables: ``tokens`` a ``Sharded`` (B, S)
    laid out on batch. Where the rules split the vocab, each shard looks its
    tokens up in its block of rows and zeros the others: the result holds
    partial sums over the vocab's axes, each row one shard's lookup and
    zeros, so their sum (a reduce) is exact."""
    from ..parallel.sharding import entry_pos, gather, smap, spec_axes
    tok = gather(params["tok"], 1)
    vocab = tok.spec[0]
    spec = tokens.spec + (None,)
    if vocab is None:
        return smap(lambda t, w: w[t.long()].to(compute_dtype), tokens, tok,
                    spec=spec)
    mesh = tok.mesh

    def look(t, w, at):
        n = w.shape[0]
        i = t.long() - entry_pos(vocab, mesh, at) * n
        mine = (i >= 0) & (i < n)
        return torch.where(mine[..., None],
                           w[i.clamp(0, n - 1)].to(compute_dtype), 0)
    return smap(look, tokens, tok, spec=spec, partial=spec_axes(vocab),
                at=True)


def unembed_sharded(params: dict, x, compute_dtype):
    """Logits from placed tables, ``x`` a ``Sharded`` (B, S, d) with ``d``
    whole: each shard scores its vocab block, then an all-gather over the
    vocab's axes gives every shard the whole vocab (the reference's
    outputs' layout, batch split, vocab whole)."""
    from ..parallel.sharding import gather, matmul, relayout, smap
    if "out" in params:
        y = matmul(x, gather(params["out"], 0), compute_dtype)
    else:
        tok = gather(params["tok"], 1)
        y = smap(lambda a, w: a @ w.to(compute_dtype).T, x, tok,
                 spec=x.spec[:-1] + (tok.spec[0],))
    return relayout(y, x.spec[:-1] + (None,))


# --- losses -----------------------------------------------------------------

def _lse_gold(logits: torch.Tensor, targets: torch.Tensor):
    """log-sum-exp over the vocab and the target's logit (0 where the
    target is outside it, as the reference's iota compare gives)."""
    lse = torch.logsumexp(logits, dim=-1)
    iota = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.sum(torch.where(iota == targets[..., None].long(), logits,
                                 0.0), dim=-1)
    return lse, gold


def sharded_softmax_xent(x: torch.Tensor, w_out: torch.Tensor,
                         tokens: torch.Tensor,
                         z_loss: float = 1e-4) -> torch.Tensor:
    """The LM loss from the final hidden ``x`` (B, S, d): targets rolled by
    one, the final position masked out."""
    targets = rolled_targets(tokens)
    logits = (x @ w_out).to(torch.float32)             # (B, S, V)
    lse, gold = _lse_gold(logits, targets)
    valid = (targets >= 0).to(torch.float32)
    cnt = torch.sum(valid)
    loss = torch.sum((lse - gold) * valid) / cnt
    if z_loss:
        loss = loss + z_loss * torch.sum(torch.square(lse) * valid) / cnt
    return loss


def rolled_targets(tokens: torch.Tensor, prefix: int = 0) -> torch.Tensor:
    """The next-token targets of ``tokens`` (B, S): rolled by one, the final
    position -1 (masked), after ``prefix`` masked positions (a VLM's patch
    prefix, which has no targets)."""
    b = tokens.shape[0]
    fill = (lambda n: torch.full((b, n), -1, dtype=tokens.dtype,
                                 device=tokens.device))
    return torch.cat([fill(prefix), tokens[:, 1:], fill(1)], dim=1)


def unembed_weight_sharded(params: dict, compute_dtype):
    """The unembedding weight (d, V) whole on every coordinate: ``out``, or
    the tied table transposed, all-gathered over its ``fsdp`` and vocab
    splits (their backwards reduce-scatter its gradient to the blocks)."""
    from ..parallel.sharding import gather, smap
    if "out" in params:
        w = gather(gather(params["out"], 0), 1)
        return smap(lambda a: a.to(compute_dtype), w, spec=(None, None))
    t = gather(gather(params["tok"], 1), 0)
    return smap(lambda a: a.to(compute_dtype).T, t, spec=(None, None))


def sharded_softmax_xent_partitioned(x, w_out, targets,
                                     z_loss: float = 1e-4):
    """``sharded_softmax_xent`` on the partitioned program, as the
    reference partitions it: ``x`` a ``Sharded`` (B, S, d) in the stream's
    layout (``("batch", "seq_act")``, ``d`` whole), ``w_out`` the whole
    (d, V) weight on every coordinate (``unembed_weight_sharded``),
    ``targets`` (B, S) laid out like ``x`` (``rolled_targets``, -1
    masked). Each coordinate scores its own positions: its logits, lse,
    gold and z-loss terms are local; the three sums (loss, z-loss, count)
    are all-reduced over the axes splitting the positions, in one op.
    Returns the loss, a ``Sharded`` scalar every coordinate holds."""
    from ..parallel.sharding import Sharded, reduce, smap, spec_axes

    def sums(xb, wb, tb):
        logits = (xb @ wb).to(torch.float32)              # (b, s, V)
        lse, gold = _lse_gold(logits, tb)
        valid = (tb >= 0).to(torch.float32)
        return torch.stack([torch.sum((lse - gold) * valid),
                            torch.sum(torch.square(lse) * valid),
                            torch.sum(valid)])
    part = smap(sums, x, w_out, targets, spec=(None,))
    axes = tuple(a for e in x.spec[:2] for a in spec_axes(e))
    tot = reduce(Sharded(part.mesh, part.spec, part.shape, part.blocks,
                         axes))

    def loss(t):
        out = t[0] / t[2]
        return out + z_loss * t[1] / t[2] if z_loss else out
    return smap(loss, tot, spec=())


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    z_loss: float = 1e-4) -> torch.Tensor:
    """Causal LM loss: logits (B, S, V) predict tokens shifted by one."""
    logits = logits[:, :-1].to(torch.float32)
    lse, gold = _lse_gold(logits, tokens[:, 1:])
    loss = torch.mean(lse - gold)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss
