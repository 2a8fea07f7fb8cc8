"""Step functions: train, prefill and serve, mirroring
``src/repro/launch/steps.py``.

The reference jits each step with shardings from its logical-axis rules;
here each step runs eagerly on the parameters' device. The sharding trees
and the abstract argument constructors (``batch_shardings``,
``cache_shardings``, ``_CACHE_AXES``, ``abstract_*_args``,
``prefill_out_shardings``) serve only the XLA dry-run and are not ported
(ROADMAP queue 1 item 11).
"""
from __future__ import annotations

import torch

from ..models.params import tree_leaves, tree_unflatten
from ..optim import AdamWConfig, adamw_update


def make_train_step(model, opt_cfg: AdamWConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradient by autograd (every parameter leaf
    is made to require grad), then one in-place AdamW update
    (``optim.adamw_update``). Nothing is written before the backward has
    finished, so a step that raises there leaves params and state as they
    were; one that fails inside the update raises
    ``optim.PartialUpdateError``, which the retry does not catch.
    ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors.
    The reference's ``param_specs`` (ZeRO-1 constraints) have no use on
    one card."""

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        with torch.enable_grad():
            loss = model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree_unflatten(params, [
            g if g is not None else torch.zeros_like(p)
            for p, g in zip(leaves, grads)])
        params, opt_state, metrics = adamw_update(params, grads, opt_state,
                                                  opt_cfg)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def make_prefill_step(model, s_max: int):
    def prefill_step(params, batch):
        with torch.inference_mode():
            return model.prefill(params, batch, s_max)
    return prefill_step


def make_serve_step(model):
    def serve_step(params, cache, tokens):
        with torch.inference_mode():
            return model.decode_step(params, cache, tokens)
    return serve_step
