"""Mamba-1 selective SSM block (falcon-mamba-7b), mirroring
``src/repro/models/ssm.py``.

The full-sequence path is the reference's chunked scan: a Python loop over
sequence chunks of ``min(cfg.ssm.chunk, S)`` carrying ``(conv_state,
ssm_state)``, each chunk's recurrence one ``common.linear_scan`` (the
reference's ``jax.lax.associative_scan``) over its (B, C, d_inner,
d_state) discretized tensors. The state is float32 and the activations
are in ``compute_dtype``, cast where the reference casts them. A prompt
longer than one chunk must be a whole number of chunks, as the
reference asserts.

Decode keeps the (conv window, ssm state) caches: O(1) a token.

With the weights placed on a mesh (``models.params.place_params``),
``mamba_apply_full_sharded`` and ``mamba_decode_sharded`` run the mixer
on ``parallel.sharding.Sharded`` tensors, each ``"ff"`` shard on its own
channels of ``d_inner`` (the layout of ``conv_w``, ``a_log`` and the
caches' channel dims). The input ``h`` comes with its sequence whole: the
scan needs every position on each channel shard. ``w_in`` is
column-parallel (its ``fsdp`` rows all-gathered for the call); its (x, z)
halves fall on other shards than their channels, so the product is
all-gathered on its flat dim and each shard keeps its own channels of
both. The conv, the step sizes (``w_dt`` column-parallel), the
recurrence and the skip are local. ``w_x`` is row-parallel: its (B, C,
dt_rank + 2·d_state) partial sums take one all-reduce a chunk (a step in
decode). ``w_out`` is row-parallel too: the output holds partial sums for
the caller to reduce. The states stay float32, split by channel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import linear_scan, softplus
from .params import Spec


def _dt_rank(cfg) -> int:
    return cfg.ssm.dt_rank or math.ceil(cfg.d_model / 16)


def mamba_specs(cfg) -> dict:
    d = cfg.d_model
    di = cfg.ssm.expand * d
    st = cfg.ssm.d_state
    dt = _dt_rank(cfg)
    return {
        "w_in": Spec((d, 2 * di), ("fsdp", "ff")),
        "conv_w": Spec((cfg.ssm.d_conv, di), (None, "ff")),
        "conv_b": Spec((di,), ("ff",), init="zeros"),
        "w_x": Spec((di, dt + 2 * st), ("ff", None)),
        "w_dt": Spec((dt, di), (None, "ff")),
        "b_dt": Spec((di,), ("ff",), init="ones"),
        "a_log": Spec((di, st), ("ff", None), init="ones"),
        "d_skip": Spec((di,), ("ff",), init="ones"),
        "w_out": Spec((di, d), ("ff", "fsdp")),
    }


def _conv1d_causal(x, w, b, state=None):
    """Depthwise causal conv along seq. x: (B,S,di); w: (K,di).

    state: (B, K-1, di) trailing inputs from the previous chunk/step; the
    new state is the last K-1 rows of state and input together."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out + b, xp[:, -(k - 1):]


def check_chunks(s: int, chunk: int) -> int:
    """The scan's chunk, ``min(chunk, s)``; a sequence longer than one
    chunk must be a whole number of them (the reference asserts it)."""
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"a sequence of {s} tokens is not a whole number "
                         f"of {c}-token scan chunks")
    return c


def _ssm_scan_chunk(a_bar, bx, h0):
    """The scan within a chunk. a_bar/bx: (B,C,di,st); h0: (B,di,st).
    Returns every step's state and the last."""
    a_all, h_all = linear_scan(a_bar, bx)
    h_all = h_all + a_all * h0[:, None]
    return h_all, h_all[:, -1]


def _dt_b_c(p, xc, cfg, dtype):
    """The input-dependent step size (float32) and the B and C planes."""
    st, dtr = cfg.ssm.d_state, _dt_rank(cfg)
    proj = xc @ p["w_x"].to(dtype)
    dt_r, bmat, cmat = torch.split(proj, [dtr, st, st], dim=-1)
    dt_v = softplus(dt_r @ p["w_dt"].to(dtype)
                    + p["b_dt"].to(dtype)).to(torch.float32)
    return dt_v, bmat, cmat


def mamba_apply_full(p, x, cfg, dtype, conv_state=None, ssm_state=None,
                     return_state: bool = False):
    """Full-sequence path (train / prefill), chunked over seq. Returns
    (out, (conv_state, ssm_state) or None)."""
    b, s, d = x.shape
    di = cfg.ssm.expand * d
    chunk = check_chunks(s, cfg.ssm.chunk)
    u = x @ p["w_in"].to(dtype)
    xs, z = u.chunk(2, dim=-1)
    if conv_state is None:
        conv_state = torch.zeros((b, cfg.ssm.d_conv - 1, di), dtype=dtype,
                                 device=x.device)
    if ssm_state is None:
        ssm_state = torch.zeros((b, di, cfg.ssm.d_state),
                                dtype=torch.float32, device=x.device)
    a = -torch.exp(p["a_log"].to(torch.float32))             # (di, st)
    conv_w, conv_b = p["conv_w"].to(dtype), p["conv_b"].to(dtype)
    d_skip = p["d_skip"].to(torch.float32)
    ys = []
    for lo in range(0, s, chunk):
        xc, conv_state = _conv1d_causal(xs[:, lo:lo + chunk], conv_w, conv_b,
                                        conv_state)
        xc = F.silu(xc)
        dt_v, bmat, cmat = _dt_b_c(p, xc, cfg, dtype)
        xf = xc.to(torch.float32)
        a_bar = torch.exp(dt_v[..., None] * a)               # (B,C,di,st)
        bx = (dt_v * xf)[..., None] * bmat.to(torch.float32)[:, :, None, :]
        h_all, ssm_state = _ssm_scan_chunk(a_bar, bx, ssm_state)
        del a_bar, bx
        y = torch.einsum("bcds,bcs->bcd", h_all, cmat.to(torch.float32))
        del h_all
        ys.append((y + d_skip * xf).to(dtype))
    y = torch.cat(ys, dim=1) * F.silu(z)
    out = y @ p["w_out"].to(dtype)
    return out, ((conv_state, ssm_state) if return_state else None)


def mamba_decode(p, x, cfg, dtype, conv_state, ssm_state):
    """One-token decode. x: (B,1,d); conv_state: (B,K-1,di);
    ssm_state: (B,di,st) float32. Returns (out, conv_state, ssm_state), the
    states new tensors."""
    u = x @ p["w_in"].to(dtype)
    xs, z = u.chunk(2, dim=-1)
    xs, conv_state = _conv1d_causal(xs, p["conv_w"].to(dtype),
                                    p["conv_b"].to(dtype), conv_state)
    xs = F.silu(xs)[:, 0]                                    # (B,di)
    dt_v, bmat, cmat = _dt_b_c(p, xs, cfg, dtype)
    xf = xs.to(torch.float32)
    a = -torch.exp(p["a_log"].to(torch.float32))
    a_bar = torch.exp(dt_v[..., None] * a)                   # (B,di,st)
    bx = (dt_v * xf)[..., None] * bmat.to(torch.float32)[:, None, :]
    ssm_state = a_bar * ssm_state + bx
    y = torch.einsum("bds,bs->bd", ssm_state, cmat.to(torch.float32))
    y = y + p["d_skip"].to(torch.float32) * xf
    y = (y.to(dtype) * F.silu(z[:, 0]))[:, None]
    return y @ p["w_out"].to(dtype), conv_state, ssm_state


# ---------------------------------------------------------------------------
# The partitioned program (placed weights under a mesh)
# ---------------------------------------------------------------------------

def channel_entry(p, leaves: tuple = ()) -> object:
    """The spec entry splitting the mixer's channels: ``conv_w``'s. Every
    leaf laid out on them (``leaves``: (name, dim) pairs) must split them
    alike; Mamba's ``w_in``, twice as wide, may not, and is cut by hand."""
    ch = p["conv_w"].spec[1]
    for name, dim in leaves:
        if p[name].spec[dim] != ch:
            raise ValueError(f"{name} splits its channels as "
                             f"{p[name].spec[dim]!r}, the conv as {ch!r}")
    return ch


def _in_proj_sharded(p, h, dtype, ch):
    """``h @ w_in`` column-parallel (``h`` (B, S, d) whole on d, the
    weight's ``fsdp`` rows all-gathered), as its (x, z) halves each cut to
    the channels ``ch``: the flat split of the product does not follow its
    halves, so it is all-gathered on its flat dim first."""
    from ..parallel.sharding import gather, matmul, smap, split
    u = gather(matmul(h, gather(p["w_in"], 0), dtype), -1)
    halves = smap(lambda a: a.unflatten(-1, (2, -1)), u,
                  spec=u.spec[:-1] + (None, None))
    if ch is not None:
        halves = split(halves, -1, ch)
    return [smap(lambda a, i=i: a[..., i, :], halves,
                 spec=h.spec[:-1] + (ch,)) for i in (0, 1)]


def x_proj_sharded(p, xc, dtype):
    """``xc @ w_x``: ``w_x`` row-parallel on the channels, its partial
    sums all-reduced (one collective a chunk, or a decode step)."""
    from ..parallel.sharding import matmul, reduce
    return reduce(matmul(xc, p["w_x"], dtype))


def _scan_local(cfg, dtype, chunk_fn):
    """The per-shard chunk body: step sizes, discretization, the scan and
    the skip, on one coordinate's channels; the output in the input's
    dtype, the state float32."""
    st, dtr = cfg.ssm.d_state, _dt_rank(cfg)

    def body(xc, proj, w_dt, b_dt, a_log, d_skip, h0):
        dt_r, bmat, cmat = torch.split(proj, [dtr, st, st], dim=-1)
        dt_v = softplus(dt_r @ w_dt.to(dtype)
                        + b_dt.to(dtype)).to(torch.float32)
        a = -torch.exp(a_log.to(torch.float32))
        return chunk_fn(xc, dt_v, bmat, cmat, a, d_skip.to(torch.float32),
                        h0)
    return body


def _chunk_scan(xc, dt_v, bmat, cmat, a, d_skip, h0):
    xf = xc.to(torch.float32)
    a_bar = torch.exp(dt_v[..., None] * a)
    bx = (dt_v * xf)[..., None] * bmat.to(torch.float32)[:, :, None, :]
    h_all, h_last = _ssm_scan_chunk(a_bar, bx, h0)
    del a_bar, bx
    y = torch.einsum("bcds,bcs->bcd", h_all, cmat.to(torch.float32))
    return (y + d_skip * xf).to(xc.dtype), h_last


def _step_scan(xc, dt_v, bmat, cmat, a, d_skip, h0):
    xf = xc.to(torch.float32)
    a_bar = torch.exp(dt_v[..., None] * a)
    h = a_bar * h0 + (dt_v * xf)[..., None] * bmat.to(torch.float32)[:, None]
    y = torch.einsum("bds,bs->bd", h, cmat.to(torch.float32))
    return (y + d_skip * xf).to(xc.dtype), h


_LOCAL = ("conv_w", 1), ("conv_b", 0), ("w_dt", 1), ("b_dt", 0), \
    ("a_log", 0), ("d_skip", 0), ("w_x", 0), ("w_out", 0)


def mamba_apply_full_sharded(p, h, cfg, dtype, return_state: bool = False):
    """``mamba_apply_full`` on placed weights: ``h`` a ``Sharded`` (B, S, d)
    with S and d whole. Returns ``(out, (conv_state, ssm_state) or
    None)``: ``out`` (B, S, d) partial sums over the channels' axes, the
    states ``Sharded`` on their channels as the caches lay them out."""
    from ..parallel.sharding import gather, matmul, smap
    s = h.shape[1]
    chunk = check_chunks(s, cfg.ssm.chunk)
    ch = channel_entry(p, _LOCAL)
    xs, z = _in_proj_sharded(p, h, dtype, ch)
    bat = h.spec[0]
    k = cfg.ssm.d_conv

    def zeros(xb):
        return (torch.zeros((xb.shape[0], k - 1, xb.shape[2]), dtype=dtype,
                            device=xb.device),
                torch.zeros((xb.shape[0], xb.shape[2], cfg.ssm.d_state),
                            dtype=torch.float32, device=xb.device))
    conv, ssm_st = smap(zeros, xs, spec=[(bat, None, ch), (bat, ch, None)])
    body = _scan_local(cfg, dtype, _chunk_scan)

    def conv_silu(xb, cw, cb, cs):
        xc, cs = _conv1d_causal(xb, cw.to(dtype), cb.to(dtype), cs)
        return F.silu(xc), cs
    ys = []
    for lo in range(0, s, chunk):
        xc = smap(lambda a, lo=lo: a[:, lo:lo + chunk], xs, spec=xs.spec)
        xc, conv = smap(conv_silu, xc, p["conv_w"], p["conv_b"], conv,
                        spec=[xs.spec, conv.spec])
        proj = x_proj_sharded(p, xc, dtype)
        y, ssm_st = smap(body, xc, proj, p["w_dt"], p["b_dt"], p["a_log"],
                         p["d_skip"], ssm_st, spec=[xs.spec, ssm_st.spec])
        ys.append(y)
    y = smap(lambda zb, *yb: torch.cat(yb, dim=1) * F.silu(zb), z, *ys,
             spec=xs.spec)
    out = matmul(y, gather(p["w_out"], 1), dtype)
    return out, ((conv, ssm_st) if return_state else None)


def mamba_decode_sharded(p, h, cfg, dtype, conv_state, ssm_state):
    """``mamba_decode`` on placed weights: ``h`` (B, 1, d), the states
    ``Sharded`` on their channels. Returns ``(out, conv_state,
    ssm_state)``, ``out`` partial sums over the channels' axes, the states
    new blocks (the caller writes them into the cache)."""
    from ..parallel.sharding import gather, matmul, smap
    ch = channel_entry(p, _LOCAL)
    xs, z = _in_proj_sharded(p, h, dtype, ch)
    bat = h.spec[0]

    def conv_silu(xb, cw, cb, cs):
        xc, cs = _conv1d_causal(xb, cw.to(dtype), cb.to(dtype), cs)
        return F.silu(xc)[:, 0], cs
    xc, conv = smap(conv_silu, xs, p["conv_w"], p["conv_b"], conv_state,
                    spec=[(bat, ch), conv_state.spec])
    proj = x_proj_sharded(p, xc, dtype)
    y, st = smap(_scan_local(cfg, dtype, _step_scan), xc, proj, p["w_dt"],
                 p["b_dt"], p["a_log"], p["d_skip"], ssm_state,
                 spec=[(bat, ch), ssm_state.spec])
    y = smap(lambda yb, zb: (yb * F.silu(zb[:, 0]))[:, None], y, z,
             spec=xs.spec)
    return matmul(y, gather(p["w_out"], 1), dtype), conv, st
