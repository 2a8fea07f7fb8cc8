"""RG-LRU recurrent block (recurrentgemma / Griffin), mirroring
``src/repro/models/rglru.py``.

Real-gated linear recurrent unit:  h_t = a_t ⊙ h_{t-1} + √(1−a_t²) ⊙ (i_t ⊙ x_t)
with a_t = exp(−c · softplus(Λ) ⊙ r_t), r/i input-gated sigmoids. The
recurrence is elementwise-diagonal, so each sequence chunk is one
``common.linear_scan``, chunked like the SSM. The state is (B, width)
float32: O(1) decode.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import linear_scan, softplus
from .params import Spec
# the reference keeps its own copy of the SSM's causal conv; it is one
from .ssm import _conv1d_causal, check_chunks

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


def _lru_gates(p, x, dtype):
    """The decay a_t and the gated input, float32."""
    r = torch.sigmoid(x @ p["w_r"].to(dtype)).to(torch.float32)
    i = torch.sigmoid(x @ p["w_i"].to(dtype)).to(torch.float32)
    log_a = -_C * softplus(p["lam"].to(torch.float32)) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i \
        * x.to(torch.float32)
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
