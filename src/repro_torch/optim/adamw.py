"""AdamW, mirroring ``src/repro/optim/adamw.py``.

Moments are float32 whatever the parameters' dtype (mixed-precision master
state); the step counter is an int32 0-d tensor. The update keeps the
reference's float order, leaf by leaf:

    g   = g32 · scale                       (global-norm clip)
    mu  = b1·mu + (1 − b1)·g
    nu  = b2·nu + (1 − b2)·g²
    upd = (mu / b1c) / (sqrt(nu / b2c) + eps)
    upd = upd + wd·p32                       (only leaves of ndim ≥ 2)
    p   = (p32 − lr·upd) → p.dtype

It runs in torch's idiom: in place, under ``torch.no_grad()``, one leaf at
a time, and a stacked leaf (ndim ≥ 3) one slice of its first dim at a time
(the same numbers, elementwise), so a float32 temporary is one slice: a
whole stacked expert matrix of granite-moe-3b is 1,006,632,960 elements,
4.03 GB a float32 temporary. The reference's ZeRO-1 sharding constraint on
the moments (``_shard_moment``) has no counterpart on one card;
``opt_state_specs`` keeps its logical axes for the dry-run tooling (ROADMAP
queue 1 item 11).

Leaves are visited in the reference's order (dict keys sorted, the order
``jax.tree.leaves`` gives), which fixes the order of ``global_norm``'s sum.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from ..models.params import Spec, is_spec, sorted_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def _moment_axes(spec: Spec) -> Tuple[Optional[str], ...]:
    """Logical axes for a moment leaf: the parameter's, with ``opt_shard``
    on the first free dimension (ZeRO-1)."""
    axes = list(spec.axes)
    for i, a in enumerate(axes):
        if a is None:
            axes[i] = "opt_shard"
            break
    return tuple(axes)


def opt_state_specs(param_specs) -> Any:
    """Spec tree for (mu, nu) mirroring the parameters, with ZeRO-1 axes."""
    def one(s: Spec) -> Spec:
        return Spec(s.shape, _moment_axes(s), init="zeros")
    return {
        "mu": tree_map(one, param_specs, is_spec),
        "nu": tree_map(one, param_specs, is_spec),
        "step": Spec((), (), init="zeros"),
    }


def adamw_init(params) -> Any:
    """Zero float32 moments beside each leaf, and the step counter (int32,
    0-d) on the first leaf's device."""
    dev = sorted_leaves(params)[0].device
    zeros = (lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device))
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to a tenth, in float32."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _slices(x: torch.Tensor):
    """A leaf as the views the update walks: one a first-dim slice for a
    stacked leaf (ndim ≥ 3), else the leaf."""
    return x.unbind(0) if x.dim() >= 3 else (x,)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of every leaf's squares, leaves summed in the
    reference's order."""
    total = None
    for x in sorted_leaves(tree):
        sq = sum(torch.sum(torch.square(part.to(torch.float32)))
                 for part in _slices(x))
        total = sq if total is None else total + sq.to(total.device)
    return torch.sqrt(total)


class PartialUpdateError(Exception):
    """An ``adamw_update`` that failed after its first in-place write."""


def _update_leaf(p, g, mu, nu, cfg: AdamWConfig, scale, b1c, b2c, lr):
    """One leaf's update in place, a first-dim slice at a time for a
    stacked leaf."""
    decay = bool(cfg.weight_decay) and p.dim() >= 2
    for ps, gs, ms, ns in zip(_slices(p), _slices(g), _slices(mu),
                              _slices(nu)):
        d = ps.device
        g32 = gs.to(torch.float32) * scale.to(d)
        ms.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        ns.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g32))
        del g32
        upd = (ms / b1c.to(d)) / (torch.sqrt(ns / b2c.to(d)) + cfg.eps)
        p32 = ps.to(torch.float32)
        if decay:
            upd = upd + cfg.weight_decay * p32
        ps.copy_(p32 - lr.to(d) * upd)
        del upd, p32


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step, in place: ``params`` and ``state`` are updated and
    returned with ``{"grad_norm", "lr"}``.

    Nothing is written until the norm and the schedule are known: an error
    before then leaves ``params`` and ``state`` as they were. An error once
    the first leaf is written leaves them half updated (``state["step"]``
    not yet advanced), and is raised as ``PartialUpdateError``, which is
    not a ``RuntimeError``, so ``runtime.fault.retry_with_backoff`` does
    not retry from that state."""
    step = state["step"] + 1
    lr = _schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    sf = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, sf)
    b2c = 1 - torch.pow(cfg.b2, sf)
    leaves = list(zip(sorted_leaves(params), sorted_leaves(grads),
                      sorted_leaves(state["mu"]), sorted_leaves(state["nu"])))
    try:
        for p, g, mu, nu in leaves:
            _update_leaf(p, g, mu, nu, cfg, scale, b1c, b2c, lr)
    except Exception as e:
        raise PartialUpdateError(
            "adamw_update failed after it began writing params and "
            "optimizer state in place; they are half updated, so the step "
            "cannot be retried: restore the last checkpoint") from e
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
