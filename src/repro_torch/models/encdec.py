"""Whisper-style encoder-decoder (whisper-medium backbone), mirroring
``src/repro/models/encdec.py``.

The audio frontend (log-mel + 2×conv) is a stub, as in the reference:
``batch["frames"]`` carries precomputed frame embeddings (B, T_enc,
d_model). Encoder: bidirectional self-attention + GELU MLP. Decoder:
causal self-attention + cross-attention over the encoder's output + GELU
MLP. Pre-LN LayerNorm (with bias), MHA, sinusoidal positions.

Both stacks keep their parameters stacked on a leading layer dim, as the
reference's do, and run as a Python loop over their ``unbind`` slices
(the reference scans them). The decode cache (``encdec_cache_zeros``) is
preallocated and written in place: the prefill fills the self-attention
keys and values at their positions and the cross-attention keys and
values of the whole encoder output; a decode step writes its token's
entries. ``pos`` is a Python int.

With the weights placed on a mesh (``params.place_params``), ``encode``,
``decode_full``, ``encdec_loss``, ``encdec_prefill`` and
``encdec_decode_step`` run the partitioned program on
``parallel.sharding.Sharded`` tensors, as the decoder-only configs' does
(``models/transformer.py``): the streams in the rules' layout
``("batch", "seq_act", None)`` (1,500 frames split four ways, not
sixteen), LayerNorm on each shard's rows, the sequence all-gathered
before each column-parallel product and reduced back after each
row-parallel one. The encoder attends unmasked by heads
(``attention.gqa_full_sharded``), the MLPs are
``ffn.gelu_mlp_apply_sharded``. Cross-attention keeps its keys and values
by heads: the encoder's output is all-gathered on its sequence once, each
shard projects its own heads (``attention.cross_kv_sharded``), the
prefill writes them into ``ck``/``cv`` once, and a decode step attends
its own heads' cache (``attention.cross_apply_sharded``), gathering none.
The loss is ``common.sharded_softmax_xent_partitioned`` against the tied
table, gathered whole (whisper's 51,865 tokens divide no axis).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import attention as attn
from .common import layernorm, sharded_softmax_xent, sinusoidal_positions
from .ffn import gelu_mlp_apply, gelu_mlp_apply_sharded, gelu_mlp_specs
from .params import Spec, is_placed, stack, torch_dtype, tree_map
from .transformer import _remat, _unstack, _write_blocks


def _ln_spec(cfg):
    return {"w": Spec((cfg.d_model,), (None,), init="ones"),
            "b": Spec((cfg.d_model,), (None,), init="zeros")}


def _enc_layer_specs(cfg):
    return {"ln1": _ln_spec(cfg), "attn": attn.gqa_specs(cfg),
            "ln2": _ln_spec(cfg), "mlp": gelu_mlp_specs(cfg)}


def _dec_layer_specs(cfg):
    return {"ln1": _ln_spec(cfg), "self": attn.gqa_specs(cfg),
            "ln2": _ln_spec(cfg), "cross": attn.cross_specs(cfg),
            "ln3": _ln_spec(cfg), "mlp": gelu_mlp_specs(cfg)}


def encdec_specs(cfg) -> Dict[str, Any]:
    return {
        "embed": {"tok": Spec((cfg.vocab, cfg.d_model), ("vocab", "fsdp"),
                              scale=cfg.d_model ** -0.5)},
        "encoder": stack(_enc_layer_specs(cfg), cfg.n_encoder_layers),
        "enc_ln": _ln_spec(cfg),
        "decoder": stack(_dec_layer_specs(cfg), cfg.n_layers),
        "dec_ln": _ln_spec(cfg),
    }


def _ln(x, p, eps):
    return layernorm(x, p["w"], p["b"], eps)


def _layers(tree, n: int) -> list:
    """The ``n`` per-layer trees of a stack, each leaf split once with
    ``unbind``; the stack dim is there even for one layer."""
    return _unstack(tree, n) if n > 1 else [tree_map(lambda a: a[0], tree)]


def encode(params, frames, cfg):
    """frames: (B, T_enc, d) stub frontend output -> encoder states (a
    ``Sharded`` in the stream's layout on placed weights)."""
    if is_placed(params):
        return _encode_sharded(params, frames, cfg)
    dtype = torch_dtype(cfg.compute_dtype)
    x = frames.to(dtype) + sinusoidal_positions(
        frames.shape[1], cfg.d_model, frames.device).to(dtype)[None]

    def body(x, p):
        h = _ln(x, p["ln1"], cfg.norm_eps)
        out, _ = attn.gqa_full(p["attn"], h, cfg, dtype, causal=False)
        x = x + out
        h = _ln(x, p["ln2"], cfg.norm_eps)
        return x + gelu_mlp_apply(p["mlp"], h, dtype)

    if cfg.remat == "full" and torch.is_grad_enabled():
        body = _remat(body, cfg)
    for p in _layers(params["encoder"], cfg.n_encoder_layers):
        x = body(x, p)
    return _ln(x, params["enc_ln"], cfg.norm_eps)


def decode_full(params, tokens, enc_out, cfg, want_cache: bool = False,
                s_max: int = 0, return_hidden: bool = False):
    """Teacher-forced decoder pass. Returns (logits or hidden, cache layers
    or None): with ``want_cache`` the self-attention keys and values padded
    to ``s_max`` and the cross-attention keys and values, a stacked
    (L, ...) tensor each, as ``encdec_cache_zeros`` lays them out. Placed
    weights run the partitioned program (``enc_out`` a ``Sharded``)."""
    if is_placed(params):
        return _decode_full_sharded(params, tokens, enc_out, cfg, want_cache,
                                    s_max, return_hidden)
    dtype = torch_dtype(cfg.compute_dtype)
    b, s = tokens.shape
    s_max = s_max or s
    x = params["embed"]["tok"].to(dtype)[tokens.long()]
    x = x + sinusoidal_positions(s, cfg.d_model, x.device).to(dtype)[None]
    caches = encdec_cache_zeros(cfg, b, s_max, x.device,
                                t_enc=enc_out.shape[1])["layers"] \
        if want_cache else None

    def body(x, p):
        h = _ln(x, p["ln1"], cfg.norm_eps)
        out, kv = attn.gqa_full(p["self"], h, cfg, dtype,
                                return_kv=want_cache)
        x = x + out
        h = _ln(x, p["ln2"], cfg.norm_eps)
        ck, cv = attn.cross_kv(p["cross"], enc_out, cfg, dtype)
        x = x + attn.cross_apply(p["cross"], h, ck, cv, cfg, dtype)
        h = _ln(x, p["ln3"], cfg.norm_eps)
        return x + gelu_mlp_apply(p["mlp"], h, dtype), kv, ck, cv

    if cfg.remat == "full" and not want_cache and torch.is_grad_enabled():
        body = _remat(body, cfg)
    for i, p in enumerate(_layers(params["decoder"], cfg.n_layers)):
        x, kv, ck, cv = body(x, p)
        if want_cache:
            caches["k"][i, :, :s] = kv[0]
            caches["v"][i, :, :s] = kv[1]
            caches["ck"][i] = ck
            caches["cv"][i] = cv
    x = _ln(x, params["dec_ln"], cfg.norm_eps)
    if return_hidden:
        return x, caches
    return x @ params["embed"]["tok"].to(dtype).T, caches


def encdec_loss(params, frames, tokens, cfg) -> torch.Tensor:
    """The decoder's next-token loss through ``sharded_softmax_xent``,
    differentiable in ``params``. Placed weights run the partitioned
    program: the loss is then a ``Sharded`` scalar every coordinate
    holds."""
    if is_placed(params):
        return _loss_sharded(params, frames, tokens, cfg)
    dtype = torch_dtype(cfg.compute_dtype)
    enc_out = encode(params, frames, cfg)
    hidden, _ = decode_full(params, tokens, enc_out, cfg, return_hidden=True)
    w_out = params["embed"]["tok"].to(dtype).T
    return sharded_softmax_xent(hidden, w_out, tokens)


def encdec_prefill(params, frames, tokens, cfg, s_max: int):
    """Encode, then the decoder over the prompt with its cache filled at
    ``s_max``; the last position's logits only. Placed weights run the
    partitioned program: the logits are then a ``Sharded`` (B, V), the
    cache's leaves ``Sharded`` too."""
    if is_placed(params):
        return _prefill_sharded(params, frames, tokens, cfg, s_max)
    dtype = torch_dtype(cfg.compute_dtype)
    enc_out = encode(params, frames, cfg)
    hidden, caches = decode_full(params, tokens, enc_out, cfg,
                                 want_cache=True, s_max=s_max,
                                 return_hidden=True)
    logits = hidden[:, -1:] @ params["embed"]["tok"].to(dtype).T
    return logits[:, 0], {"layers": caches, "pos": tokens.shape[1]}


def encdec_cache_zeros(cfg, batch: int, s_max: int, device=None,
                       t_enc: int = 0, mesh=None):
    """The decode cache, zeros: self-attention keys and values at
    ``s_max``, cross-attention ones at ``t_enc`` encoder frames (default
    ``cfg.encoder_seq``), stacked over the decoder's layers. With ``mesh``
    (under ``sharding_rules(mesh)``) each leaf is a ``Sharded`` laid out by
    ``launch.steps.cache_shardings``: ``k``/``v`` by batch and sequence,
    ``ck``/``cv`` by batch and heads, one zero block a device."""
    if mesh is not None:
        from ..launch.steps import cache_shardings
        from ..parallel.sharding import sharded_zeros
        shapes = encdec_cache_zeros(cfg, batch, s_max, "meta", t_enc)
        laid = cache_shardings(shapes)["layers"]
        return {"layers": {k: sharded_zeros(t.shape, t.dtype, laid[k].spec,
                                            mesh)
                           for k, t in shapes["layers"].items()}, "pos": 0}
    dtype = torch_dtype(cfg.compute_dtype)
    hd, h, L = cfg.head_dim, cfg.n_heads, cfg.n_layers
    t_enc = t_enc or cfg.encoder_seq

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {"layers": {
        "k": zeros(L, batch, s_max, cfg.n_kv_heads, hd),
        "v": zeros(L, batch, s_max, cfg.n_kv_heads, hd),
        "ck": zeros(L, batch, t_enc, h, hd),
        "cv": zeros(L, batch, t_enc, h, hd)},
        "pos": 0}


def encdec_decode_step(params, cache, tokens, cfg):
    """tokens: (B,1). The cross keys and values come from the prefill's
    cache; the self-attention cache is written at ``pos`` in place.
    Returns (logits (B,V), cache) with ``pos`` one on. Placed weights run
    the partitioned program."""
    if is_placed(params):
        return _decode_step_sharded(params, cache, tokens, cfg)
    dtype = torch_dtype(cfg.compute_dtype)
    pos = int(cache["pos"])
    x = params["embed"]["tok"].to(dtype)[tokens.long()]
    # sinusoidal position of the current step, as the reference computes it
    d = cfg.d_model
    dim = torch.arange(d // 2, dtype=torch.float32, device=x.device)[None, :]
    posv = torch.tensor([pos], dtype=torch.float32, device=x.device)
    ang = posv[:, None] / (10000.0 ** (2 * dim / d))
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)
    x = x + pe[None]
    layers = cache["layers"]
    for i, p in enumerate(_layers(params["decoder"], cfg.n_layers)):
        c = tree_map(lambda t: t[i], layers)
        h = _ln(x, p["ln1"], cfg.norm_eps)
        out, _, _ = attn.gqa_decode(p["self"], h, cfg, dtype, c["k"], c["v"],
                                    pos)
        x = x + out
        h = _ln(x, p["ln2"], cfg.norm_eps)
        x = x + attn.cross_apply(p["cross"], h, c["ck"], c["cv"], cfg, dtype)
        h = _ln(x, p["ln3"], cfg.norm_eps)
        x = x + gelu_mlp_apply(p["mlp"], h, dtype)
    x = _ln(x, params["dec_ln"], cfg.norm_eps)
    logits = x @ params["embed"]["tok"].to(dtype).T
    return logits[:, 0], {"layers": layers, "pos": pos + 1}



# ---------------------------------------------------------------------------
# The partitioned program (placed weights under a mesh)
# ---------------------------------------------------------------------------

def _ln_sharded(x, p, cfg):
    from ..parallel.sharding import smap
    return smap(lambda a, w, b: layernorm(a, w, b, cfg.norm_eps), x, p["w"],
                p["b"], spec=x.spec)


def _positioned(x, cfg, pos: int = 0):
    """``x`` (B, S, d) in the stream's layout plus the sinusoidal embedding
    of its positions ``pos``.., each shard adding its own rows'."""
    from ..parallel.sharding import smap

    def add(a, at):
        lo = pos + (x.index(tuple(at[n] for n in x.mesh.axis_names))[1].start)
        pe = sinusoidal_positions(lo + a.shape[1], cfg.d_model, a.device)
        return a + pe[lo:].to(a.dtype)[None]
    return smap(add, x, spec=x.spec, at=True)


def _sublayer(x, fn, ln, cfg):
    """``x + fn(LN(x))``: the norm on each shard's rows, its output's
    sequence all-gathered for ``fn``, whose partial sums are reduced back
    to the stream's layout."""
    from ..parallel.sharding import add, relayout
    h = relayout(_ln_sharded(x, ln, cfg), (x.spec[0], None, None))
    return add(x, relayout(fn(h), x.spec))


def _enc_block_sharded(x, p, cfg, dtype, rules):
    x = _sublayer(x, lambda h: attn.gqa_full_sharded(
        p["attn"], h, cfg, dtype, rules, causal=False)[0], p["ln1"], cfg)
    return _sublayer(x, lambda h: gelu_mlp_apply_sharded(p["mlp"], h, dtype),
                     p["ln2"], cfg)


def _encode_sharded(params, frames, cfg):
    from ..parallel.sharding import shard
    from .transformer import _rules_of, _stream_spec
    rules = _rules_of(params)
    dtype = torch_dtype(cfg.compute_dtype)
    x = _positioned(shard(frames.to(dtype), _stream_spec(rules, frames.shape),
                          rules.mesh), cfg)
    body = _enc_block_sharded
    if cfg.remat == "full" and torch.is_grad_enabled():
        body = _remat(body, cfg)
    for p in _layers(params["encoder"], cfg.n_encoder_layers):
        x = body(x, p, cfg, dtype, rules)
    return _ln_sharded(x, params["enc_ln"], cfg)


def _dec_block_sharded(x, p, enc, cfg, dtype, rules, cache=None):
    """One decoder layer: ``enc`` the encoder's output whole along its
    sequence; with ``cache`` (a layer's leaves) the self-attention keys
    and values written at their positions and the cross ones whole."""
    from ..parallel.sharding import write_prefix
    kv = []

    def self_attn(h):
        out, (k, v) = attn.gqa_full_sharded(p["self"], h, cfg, dtype, rules)
        kv.extend((k, v))
        return out
    x = _sublayer(x, self_attn, p["ln1"], cfg)
    ck, cv = attn.cross_kv_sharded(p["cross"], enc, cfg, dtype, rules)
    x = _sublayer(x, lambda h: attn.cross_apply_sharded(
        p["cross"], h, ck, cv, cfg, dtype, rules), p["ln2"], cfg)
    if cache is not None:
        write_prefix(cache["k"], 1, kv[0])
        write_prefix(cache["v"], 1, kv[1])
        _write_blocks(cache, ("ck", "cv"), (ck, cv))
    return _sublayer(x, lambda h: gelu_mlp_apply_sharded(p["mlp"], h, dtype),
                     p["ln3"], cfg)


def _decoder_in(params, tokens, cfg, rules, pos: int = 0):
    from .transformer import _embed_sharded
    return _positioned(_embed_sharded(params, tokens, cfg, rules), cfg, pos)


def _decode_full_sharded(params, tokens, enc_out, cfg, want_cache, s_max,
                         return_hidden):
    from ..parallel.sharding import relayout
    from .transformer import _rules_of, last_logits_sharded
    rules = _rules_of(params)
    dtype = torch_dtype(cfg.compute_dtype)
    x = _decoder_in(params, tokens, cfg, rules)
    b, s, _ = x.shape
    enc = relayout(enc_out, (enc_out.spec[0], None, None))
    caches = encdec_cache_zeros(cfg, b, s_max or s, t_enc=enc.shape[1],
                                mesh=rules.mesh)["layers"] \
        if want_cache else None
    body = _dec_block_sharded
    if cfg.remat == "full" and not want_cache and torch.is_grad_enabled():
        body = _remat(body, cfg)
    for i, p in enumerate(_layers(params["decoder"], cfg.n_layers)):
        x = body(x, p, enc, cfg, dtype, rules,
                 *((tree_map(lambda t: t[i], caches),) if want_cache else ()))
    x = _ln_sharded(x, params["dec_ln"], cfg)
    if return_hidden:
        return x, caches
    return last_logits_sharded(params, x, cfg), caches


def _loss_sharded(params, frames, tokens, cfg):
    from ..parallel.sharding import shard
    from .common import (rolled_targets, sharded_softmax_xent_partitioned,
                         unembed_weight_sharded)
    dtype = torch_dtype(cfg.compute_dtype)
    hidden, _ = decode_full(params, tokens, encode(params, frames, cfg), cfg,
                            return_hidden=True)
    targets = shard(rolled_targets(tokens), hidden.spec[:2], hidden.mesh)
    return sharded_softmax_xent_partitioned(
        hidden, unembed_weight_sharded(params["embed"], dtype), targets)


def _prefill_sharded(params, frames, tokens, cfg, s_max: int):
    logits, caches = decode_full(params, tokens, encode(params, frames, cfg),
                                 cfg, want_cache=True, s_max=s_max)
    return logits, {"layers": caches, "pos": tokens.shape[1]}


def _decode_step_sharded(params, cache, tokens, cfg):
    from .transformer import _logits_sharded, _rules_of
    rules = _rules_of(params)
    dtype = torch_dtype(cfg.compute_dtype)
    pos = int(cache["pos"])
    x = _decoder_in(params, tokens, cfg, rules, pos)
    layers = cache["layers"]
    for i, p in enumerate(_layers(params["decoder"], cfg.n_layers)):
        c = tree_map(lambda t: t[i], layers)
        x = _sublayer(x, lambda h: attn.gqa_decode_sharded(
            p["self"], h, cfg, dtype, c["k"], c["v"], pos, rules),
            p["ln1"], cfg)
        x = _sublayer(x, lambda h: attn.cross_apply_sharded(
            p["cross"], h, c["ck"], c["cv"], cfg, dtype, rules),
            p["ln2"], cfg)
        x = _sublayer(x, lambda h: gelu_mlp_apply_sharded(p["mlp"], h,
                                                          dtype),
                      p["ln3"], cfg)
    x = _ln_sharded(x, params["dec_ln"], cfg)
    return _logits_sharded(params, x, cfg), {"layers": layers,
                                             "pos": pos + 1}
