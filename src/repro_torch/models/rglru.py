"""RG-LRU recurrent block (recurrentgemma / Griffin), mirroring
``src/repro/models/rglru.py``.

Real-gated linear recurrent unit:  h_t = a_t ⊙ h_{t-1} + √(1−a_t²) ⊙ (i_t ⊙ x_t)
with a_t = exp(−c · softplus(Λ) ⊙ r_t), r/i input-gated sigmoids. The
recurrence is elementwise-diagonal, so each sequence chunk is one
``common.linear_scan``, chunked like the SSM. The state is (B, width)
float32: O(1) decode.

With the weights placed on a mesh, ``rglru_apply_full_sharded`` and
``rglru_decode_sharded`` run the block on ``parallel.sharding.Sharded``
tensors, each ``"ff"`` shard on its own channels of the width: ``w_in``
and ``w_gate_branch`` column-parallel (their ``fsdp`` rows all-gathered
for the call), the conv and the recurrence local. ``w_r`` and ``w_i``
contract over the whole width while the conv's output is split on it, so
that output is all-gathered on its channels before the gate products:
one all-gather a chunk (a step in decode) serves both. ``w_out`` is
row-parallel: the output holds partial sums for the caller to reduce.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import linear_scan, softplus
from .params import Spec
# the reference keeps its own copy of the SSM's causal conv; it is one
from .ssm import _conv1d_causal, channel_entry, check_chunks

_C = 8.0   # Griffin's fixed recurrence sharpness


def _width(cfg) -> int:
    return cfg.griffin.lru_width or cfg.d_model


def rglru_specs(cfg) -> dict:
    d = cfg.d_model
    w = _width(cfg)
    return {
        "w_in": Spec((d, w), ("fsdp", "ff")),
        "w_gate_branch": Spec((d, w), ("fsdp", "ff")),
        "conv_w": Spec((cfg.griffin.conv_width, w), (None, "ff")),
        "conv_b": Spec((w,), ("ff",), init="zeros"),
        "w_r": Spec((w, w), ("fsdp", "ff")),
        "w_i": Spec((w, w), ("fsdp", "ff")),
        "lam": Spec((w,), ("ff",), init="ones", scale=1.0),
        "w_out": Spec((w, d), ("ff", "fsdp")),
    }


def _lru_gates(p, x, dtype, x_own=None):
    """The decay a_t and the gated input, float32. ``x_own`` (default
    ``x``) is the part of ``x`` on the gates' own channels: the products
    contract over all of ``x``."""
    r = torch.sigmoid(x @ p["w_r"].to(dtype)).to(torch.float32)
    i = torch.sigmoid(x @ p["w_i"].to(dtype)).to(torch.float32)
    log_a = -_C * softplus(p["lam"].to(torch.float32)) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i \
        * (x if x_own is None else x_own).to(torch.float32)
    return a, gated


def rglru_apply_full(p, x, cfg, dtype, conv_state=None, h0=None,
                     return_state: bool = False, chunk: int = 512):
    """Full-sequence path. x: (B,S,d). Returns (out, (conv_state, h) or
    None)."""
    b, s, d = x.shape
    w = _width(cfg)
    branch = F.gelu(x @ p["w_gate_branch"].to(dtype), approximate="tanh")
    u = x @ p["w_in"].to(dtype)
    chunk = check_chunks(s, chunk)
    if conv_state is None:
        conv_state = torch.zeros((b, cfg.griffin.conv_width - 1, w),
                                 dtype=dtype, device=x.device)
    if h0 is None:
        h0 = torch.zeros((b, w), dtype=torch.float32, device=x.device)
    conv_w, conv_b = p["conv_w"].to(dtype), p["conv_b"].to(dtype)
    ys = []
    for lo in range(0, s, chunk):
        uc, conv_state = _conv1d_causal(u[:, lo:lo + chunk], conv_w, conv_b,
                                        conv_state)
        a, gated = _lru_gates(p, uc, dtype)
        a_all, h_all = linear_scan(a, gated)
        h_all = h_all + a_all * h0[:, None]
        h0 = h_all[:, -1]
        ys.append(h_all.to(dtype))
    y = torch.cat(ys, dim=1)
    out = (y * branch) @ p["w_out"].to(dtype)
    return out, ((conv_state, h0) if return_state else None)


def rglru_decode(p, x, cfg, dtype, conv_state, h):
    """One token. x: (B,1,d); h: (B,w) float32. Returns (out, conv_state,
    h), the states new tensors."""
    branch = F.gelu(x @ p["w_gate_branch"].to(dtype), approximate="tanh")
    u = x @ p["w_in"].to(dtype)
    u, conv_state = _conv1d_causal(u, p["conv_w"].to(dtype),
                                   p["conv_b"].to(dtype), conv_state)
    a, gated = _lru_gates(p, u[:, 0], dtype)
    h = a * h + gated
    out = (h.to(dtype)[:, None] * branch) @ p["w_out"].to(dtype)
    return out, conv_state, h


# ---------------------------------------------------------------------------
# The partitioned program (placed weights under a mesh)
# ---------------------------------------------------------------------------

_LOCAL = (("w_in", 1), ("w_gate_branch", 1), ("conv_b", 0), ("w_r", 1),
          ("w_i", 1), ("lam", 0), ("w_out", 0))


def _branch_and_input(p, h, dtype, ch):
    """The GELU branch and the recurrence's input, column-parallel on the
    channels ``ch``."""
    from ..parallel.sharding import gather, matmul, smap
    branch = smap(lambda a, w: F.gelu(a @ w.to(dtype), approximate="tanh"),
                  h, gather(p["w_gate_branch"], 0), spec=h.spec[:-1] + (ch,))
    return branch, matmul(h, gather(p["w_in"], 0), dtype)


def _gates_sharded(p, uc, wr, wi, dtype):
    """``_lru_gates`` on ``uc`` split on its channels: ``uc`` all-gathered
    on them for the products (``wr``/``wi`` column blocks, ``fsdp`` rows
    gathered), each shard's own channels gated."""
    from ..parallel.sharding import gather, smap
    whole = gather(uc, -1)
    return smap(lambda xw, xo, r, i, lam: _lru_gates(
        {"w_r": r, "w_i": i, "lam": lam}, xw, dtype, xo), whole, uc, wr, wi,
        p["lam"], spec=[uc.spec, uc.spec])


def rglru_apply_full_sharded(p, h, cfg, dtype, return_state: bool = False,
                             chunk: int = 512):
    """``rglru_apply_full`` on placed weights: ``h`` a ``Sharded`` (B, S, d)
    with S and d whole. Returns ``(out, (conv_state, h) or None)``: ``out``
    (B, S, d) partial sums over the channels' axes, the states ``Sharded``
    on their channels as the caches lay them out."""
    from ..parallel.sharding import gather, matmul, smap
    s = h.shape[1]
    chunk = check_chunks(s, chunk)
    ch = channel_entry(p, _LOCAL)
    branch, u = _branch_and_input(p, h, dtype, ch)
    wr, wi = gather(p["w_r"], 0), gather(p["w_i"], 0)
    bat, k = h.spec[0], cfg.griffin.conv_width

    def zeros(ub):
        return (torch.zeros((ub.shape[0], k - 1, ub.shape[2]), dtype=dtype,
                            device=ub.device),
                torch.zeros((ub.shape[0], ub.shape[2]), dtype=torch.float32,
                            device=ub.device))
    conv, h0 = smap(zeros, u, spec=[(bat, None, ch), (bat, ch)])

    def conv_local(ub, cw, cb, cs):
        return _conv1d_causal(ub, cw.to(dtype), cb.to(dtype), cs)

    def scan(a, gated, h0):
        a_all, h_all = linear_scan(a, gated)
        h_all = h_all + a_all * h0[:, None]
        return h_all.to(dtype), h_all[:, -1]
    ys = []
    for lo in range(0, s, chunk):
        uc = smap(lambda a, lo=lo: a[:, lo:lo + chunk], u, spec=u.spec)
        uc, conv = smap(conv_local, uc, p["conv_w"], p["conv_b"], conv,
                        spec=[u.spec, conv.spec])
        a, gated = _gates_sharded(p, uc, wr, wi, dtype)
        y, h0 = smap(scan, a, gated, h0, spec=[u.spec, h0.spec])
        ys.append(y)
    y = smap(lambda br, *yb: torch.cat(yb, dim=1) * br, branch, *ys,
             spec=u.spec)
    out = matmul(y, gather(p["w_out"], 1), dtype)
    return out, ((conv, h0) if return_state else None)


def rglru_decode_sharded(p, h, cfg, dtype, conv_state, h_state):
    """``rglru_decode`` on placed weights: ``h`` (B, 1, d), the states
    ``Sharded`` on their channels. Returns ``(out, conv_state, h)``,
    ``out`` partial sums over the channels' axes, the states new blocks."""
    from ..parallel.sharding import gather, matmul, smap
    ch = channel_entry(p, _LOCAL)
    branch, u = _branch_and_input(p, h, dtype, ch)
    u, conv = smap(lambda ub, cw, cb, cs: _conv1d_causal(
        ub, cw.to(dtype), cb.to(dtype), cs), u, p["conv_w"], p["conv_b"],
        conv_state, spec=[u.spec, conv_state.spec])
    u = smap(lambda a: a[:, 0], u, spec=(h.spec[0], ch))
    a, gated = _gates_sharded(p, u, gather(p["w_r"], 0), gather(p["w_i"], 0),
                              dtype)
    hn = smap(lambda a_, g, hb: a_ * hb + g, a, gated, h_state,
              spec=h_state.spec)
    y = smap(lambda hb, br: hb.to(dtype)[:, None] * br, hn, branch,
             spec=branch.spec)
    return matmul(y, gather(p["w_out"], 1), dtype), conv, hn
