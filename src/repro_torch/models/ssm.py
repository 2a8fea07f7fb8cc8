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
