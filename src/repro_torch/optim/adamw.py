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
4.03 GB a float32 temporary. ``opt_state_specs`` keeps the reference's
ZeRO-1 axes, from which the dry run lays the moments out
(``launch/steps.py::abstract_train_args``).

ZeRO-1 on placed leaves (``parallel.sharding.Sharded``; ``place_opt_state``
and ``adamw_init(params, specs)`` lay the moments out by
``opt_state_specs``: the parameter's layout with ``opt_shard`` on its
first free dim). The schedule the reference's partitioner derives from
its moments' constraint, run explicitly: each gradient (partial sums over
the axes its leaf is replicated over, ``sharding.leaf_grads``) is
reduce-scattered to its moment's block where the moment splits one of
those axes, all-reduced over the rest, and relaid to the moment's layout;
the moments and the update are computed on that block; the new parameter
blocks go back to the parameter's layout (an all-gather over the
``opt_shard`` axes where the parameter is replicated over them) and are
written into each distinct storage once. ``global_norm`` sums each
distinct block once and runs one counted all-reduce.

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


def adamw_init(params, param_specs=None) -> Any:
    """Zero float32 moments beside each leaf, and the step counter (int32,
    0-d) on the first leaf's device. Placed ``params`` take their
    ``param_specs`` (the model's ``Spec`` tree): the moments are then laid
    out by ``opt_state_specs`` under the active rules, one zero block a
    distinct (device, block), and the counter lies on the mesh's first
    device."""
    from ..models.params import is_placed
    if is_placed(params):
        from ..parallel.sharding import mesh_rules, sharded_zeros
        if param_specs is None:
            raise ValueError("placed params need their param_specs to lay "
                             "the moments out")
        rules = mesh_rules()
        specs = opt_state_specs(param_specs)

        def zeros(s: Spec):
            return sharded_zeros(s.shape, torch.float32,
                                 rules.resolve(s.axes, s.shape), rules.mesh)
        return {"mu": tree_map(zeros, specs["mu"], is_spec),
                "nu": tree_map(zeros, specs["nu"], is_spec),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=rules.mesh.devices.flat[0])}
    dev = sorted_leaves(params)[0].device
    zeros = (lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device))
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def place_opt_state(state, param_specs) -> Any:
    """``state`` (whole moments, as ``adamw_init`` or a checkpoint gives
    them) laid out on the active mesh: each moment by its
    ``opt_state_specs`` spec (``models.params.place_params``), the step
    counter as it is."""
    from ..models.params import place_params
    specs = opt_state_specs(param_specs)
    return {"mu": place_params(state["mu"], specs["mu"]),
            "nu": place_params(state["nu"], specs["nu"]),
            "step": state["step"]}


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


def _sq(x: torch.Tensor) -> torch.Tensor:
    return sum(torch.sum(torch.square(part.to(torch.float32)))
               for part in _slices(x))


def _global_norm_sharded(leaves):
    """``global_norm`` of placed leaves (complete sums, no partial): each
    coordinate sums the squares of the blocks it holds first
    (``sharding.canonical``), one all-reduce over the mesh adds the
    coordinates' sums. A ``Sharded`` scalar every coordinate holds."""
    from ..parallel.sharding import (Sharded, canonical, mesh_coords,
                                     reduce, smap)
    mesh = leaves[0].mesh
    if any(x.partial for x in leaves):
        raise ValueError("global_norm of partial sums: reduce them first")
    blocks = {}
    for c in mesh_coords(mesh):
        dev = leaves[0].blocks[c].device
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for x in leaves:
            if canonical(x, c):
                total = total + _sq(x.blocks[c])
        blocks[c] = total
    axes = tuple(a for a in mesh.axis_names if mesh.shape[a] > 1)
    return smap(torch.sqrt, reduce(Sharded(mesh, (), (), blocks, axes)),
                spec=())


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of every leaf's squares, leaves summed in the
    reference's order. Of placed leaves: a ``Sharded`` scalar
    (``_global_norm_sharded``)."""
    from ..models.params import is_placed
    if is_placed(tree):
        return _global_norm_sharded(sorted_leaves(tree))
    total = None
    for x in sorted_leaves(tree):
        sq = _sq(x)
        total = sq if total is None else total + sq.to(total.device)
    return torch.sqrt(total)


class PartialUpdateError(Exception):
    """An ``adamw_update`` that failed after its first in-place write."""


def _update_leaf(p, g, mu, nu, cfg: AdamWConfig, scale, b1c, b2c, lr,
                 out=None):
    """One leaf's (or a block's) update, a first-dim slice at a time for a
    stacked leaf: the moments in place, the new parameter into ``out``
    (``p`` itself by default)."""
    decay = bool(cfg.weight_decay) and p.dim() >= 2
    out = p if out is None else out
    for ps, gs, ms, ns, os_ in zip(_slices(p), _slices(g), _slices(mu),
                                   _slices(nu), _slices(out)):
        d = ps.device
        g32 = gs.to(torch.float32) * scale.to(d)
        ms.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        ns.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g32))
        del g32
        upd = (ms / b1c.to(d)) / (torch.sqrt(ns / b2c.to(d)) + cfg.eps)
        p32 = ps.to(torch.float32)
        if decay:
            upd = upd + cfg.weight_decay * p32
        os_.copy_(p32 - lr.to(d) * upd)
        del upd, p32


def _to_layout(g, spec):
    """A gradient (``sharding.leaf_grads``: partial over its leaf's
    replicated axes) summed and laid out by ``spec``, its moment's:
    reduce-scattered along the dim ``spec`` splits over some of those axes
    (the ``opt_shard`` dim), all-reduced over the others, then relaid."""
    from ..parallel.sharding import reduce, relayout, spec_axes
    for d, e in enumerate(spec):
        axes = spec_axes(e)
        if g.spec[d] is None and axes and set(axes) <= set(g.partial):
            g = reduce(g, d, axes)
            break
    return relayout(reduce(g), spec)


def _update_sharded(p, g, mu, nu, cfg, scale, b1c, b2c, lr):
    """One placed leaf's ZeRO-1 update: ``g`` laid out like ``mu`` and
    ``nu``. Each distinct moment storage is updated once, on the
    parameter's cut to the moment's layout (a view where that is a local
    cut); the new blocks go back to the parameter's layout and into each
    distinct parameter storage once."""
    from ..parallel.sharding import Sharded, mesh_coords, relayout
    pm = relayout(p, mu.spec)
    new, blocks = {}, {}
    for c in mesh_coords(p.mesh):
        key = id(mu.blocks[c])
        if key not in new:
            pb = pm.blocks[c]
            new[key] = torch.empty_like(pb)
            _update_leaf(pb, g.blocks[c], mu.blocks[c], nu.blocks[c], cfg,
                         scale.blocks[c], b1c, b2c, lr, out=new[key])
        blocks[c] = new[key]
    del pm, new
    back = relayout(Sharded(p.mesh, mu.spec, p.shape, blocks), p.spec)
    done = set()
    for c, b in p.blocks.items():
        if id(b) not in done:
            done.add(id(b))
            b.copy_(back.blocks[c])


def _adamw_update_sharded(params, grads, state, cfg: AdamWConfig):
    """``adamw_update`` on placed leaves (see the module docstring). The
    collectives of the gradients and the norm run before any write."""
    from ..parallel.sharding import smap
    step = state["step"] + 1
    lr = _schedule(cfg, step)
    sf = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, sf)
    b2c = 1 - torch.pow(cfg.b2, sf)
    mus, nus = sorted_leaves(state["mu"]), sorted_leaves(state["nu"])
    gm = [_to_layout(g, mu.spec) for g, mu in zip(sorted_leaves(grads), mus)]
    gnorm = global_norm(gm)
    scale = smap(lambda n: torch.clamp(cfg.clip_norm / (n + 1e-9), max=1.0),
                 gnorm, spec=())
    try:
        for p, g, mu, nu in zip(sorted_leaves(params), gm, mus, nus):
            _update_sharded(p, g, mu, nu, cfg, scale, b1c, b2c, lr)
    except Exception as e:
        raise PartialUpdateError(
            "adamw_update failed after it began writing params and "
            "optimizer state in place; they are half updated, so the step "
            "cannot be retried: restore the last checkpoint") from e
    state["step"] = step
    return params, state, {"grad_norm": gnorm.first(), "lr": lr}


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step, in place: ``params`` and ``state`` are updated and
    returned with ``{"grad_norm", "lr"}``.

    Nothing is written until the norm and the schedule are known: an error
    before then leaves ``params`` and ``state`` as they were. An error once
    the first leaf is written leaves them half updated (``state["step"]``
    not yet advanced), and is raised as ``PartialUpdateError``, which is
    not a ``RuntimeError``, so ``runtime.fault.retry_with_backoff`` does
    not retry from that state. Placed leaves take the ZeRO-1 update
    (``_adamw_update_sharded``): ``grads`` as ``sharding.leaf_grads``
    gives them, ``state`` as ``adamw_init(params, specs)`` lays it out."""
    from ..models.params import is_placed
    if is_placed(params):
        return _adamw_update_sharded(params, grads, state, cfg)
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
