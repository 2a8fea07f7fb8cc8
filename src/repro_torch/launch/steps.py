"""Step functions and their abstract arguments, mirroring
``src/repro/launch/steps.py``.

The reference jits each step with shardings from its logical-axis rules;
here each step runs eagerly on the parameters' device. The same steps run
in the dry run (``launch/dryrun.py``) on ``meta`` tensors at a cell's
global shapes, so what the dry run counts is what a launch executes. Its
arguments come from ``abstract_train_args``, ``abstract_decode_args`` and
``abstract_prefill_args``: meta tensors, each carrying its layout under
the active ``sharding_rules`` as its ``sharding`` attribute
(``models.params.meta_tensor``). ``batch_shardings``, ``cache_shardings``
and ``prefill_out_shardings`` give the reference's layout trees, and
``with_shardings`` attaches such a tree to its tensors.
"""
from __future__ import annotations

import torch

from ..configs.base import ShapeCase
from ..models.params import (abstract_params, is_placed, meta_tensor,
                             torch_dtype, tree_items, tree_leaves, tree_map,
                             tree_unflatten)
from ..optim import AdamWConfig, adamw_update, opt_state_specs
from ..parallel.sharding import (NamedSharding, grad_leaves, leaf_grads,
                                 mesh_rules)


def make_train_step(model, opt_cfg: AdamWConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradient by autograd (every parameter leaf
    is made to require grad), then one in-place AdamW update
    (``optim.adamw_update``). Nothing is written before the backward has
    finished, so a step that raises there leaves params and state as they
    were; one that fails inside the update raises
    ``optim.PartialUpdateError``, which the retry does not catch.
    ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors.

    Placed params (``Model.place``) run the partitioned step: the loss on
    each coordinate's blocks (``Model.loss`` → a ``Sharded`` scalar), one
    backward through the collectives' duals giving each placed leaf's
    gradient laid out like the leaf (``parallel.sharding.leaf_grads``),
    and the ZeRO-1 update on moments laid out by ``opt_state_specs``
    (the reference's ``param_specs`` constraints, run explicitly)."""

    def train_step(params, opt_state, batch):
        if is_placed(params):
            return _placed_step(params, opt_state, batch)
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

    def _placed_step(params, opt_state, batch):
        live = [grad_leaves(p) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = model.loss(tree_unflatten(params, live), batch)
            grads = leaf_grads(loss, live)
        del live
        params, opt_state, metrics = adamw_update(
            params, tree_unflatten(params, grads), opt_state, opt_cfg)
        metrics["loss"] = loss.first().detach()
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


# ---------------------------------------------------------------------------
# Sharding trees for non-param inputs
# ---------------------------------------------------------------------------

def batch_shardings(batch_specs) -> dict:
    """``{name: NamedSharding}`` for ``Model.input_specs``'s ``{name:
    (shape, dtype)}``: the leading axis is ``batch``, the rest whole."""
    rules = mesh_rules()
    out = {}
    for k, (shape, _) in batch_specs.items():
        axes = ("batch",) + (None,) * (len(shape) - 1)
        out[k] = NamedSharding(rules.mesh, rules.resolve(axes, shape))
    return out


_CACHE_AXES = {
    # leaf-name -> logical axes by rank (leading layer-stack dims get None)
    "k": ("batch", "seq_shard", None, None),
    "v": ("batch", "seq_shard", None, None),
    "ck": ("batch", None, "heads", None),
    "cv": ("batch", None, "heads", None),
    "latent": ("batch", "seq_shard", None),
    "krope": ("batch", "seq_shard", None),
    "conv": ("batch", None, "ff"),
    "ssm": ("batch", "ff", None),
    "h": ("batch", "ff"),
    "slot_pos": None,
    "pos": None,
}


def abstract_cache(cache):
    """A cache tree as meta tensors: a tensor leaf's shape and dtype, and
    ``pos`` (a Python int in the port's caches) as the 0-d int32 counter
    the reference carries."""
    return tree_map(lambda leaf: meta_tensor(leaf.shape, leaf.dtype)
                    if isinstance(leaf, torch.Tensor)
                    else meta_tensor((), torch.int32), cache)


def cache_shardings(cache_shapes):
    """``NamedSharding`` tree for a decode cache of meta tensors (or any
    leaves with ``shape``), each leaf's logical axes from ``_CACHE_AXES``
    by its name, a leading layer-stack dim whole."""
    rules = mesh_rules()

    def one(name, leaf):
        axes = _CACHE_AXES.get(name)
        if axes is None:
            return NamedSharding(rules.mesh, ())
        full = (None,) * (len(leaf.shape) - len(axes)) + tuple(axes)
        return NamedSharding(rules.mesh, rules.resolve(full, leaf.shape))

    # a leaf's name: the last key of its path that is not a list index
    return tree_unflatten(cache_shapes, [
        one(next((k for k in reversed(path.split("/")) if not k.isdigit()),
                 None), leaf)
        for path, leaf in tree_items(cache_shapes)])


def with_shardings(tree, shardings):
    """Meta copies of ``tree``'s leaves, each carrying its sharding."""
    flat = tree_leaves(shardings)
    return tree_unflatten(tree, [meta_tensor(t.shape, t.dtype, sh) for t, sh
                                 in zip(tree_leaves(tree), flat)])


# ---------------------------------------------------------------------------
# Abstract (no-allocation) argument builders for the dry run
# ---------------------------------------------------------------------------

def _abstract_batch(model, case: ShapeCase) -> dict:
    binput = model.input_specs(case)
    bshard = batch_shardings(binput)
    return {k: meta_tensor(shape, dtype, bshard[k])
            for k, (shape, dtype) in binput.items()}


def abstract_train_args(model, case: ShapeCase):
    """``(params, opt_state, batch)`` of a train cell as meta tensors with
    their layouts: parameters in ``param_dtype``, float32 moments laid out
    on the ZeRO-1 axes (``opt_state_specs``: ``opt_shard`` on each
    parameter's first free dim, as ``src/repro/launch/steps.py:108-120``
    gives them), the int32 step counter."""
    specs = model.specs()
    aparams = abstract_params(specs, torch_dtype(model.cfg.param_dtype))
    aopt = abstract_params(opt_state_specs(specs), torch.float32)
    aopt["step"] = meta_tensor((), torch.int32, aopt["step"].sharding)
    return aparams, aopt, _abstract_batch(model, case)


def abstract_decode_args(model, case: ShapeCase):
    """``(params, cache, tokens)`` of a decode cell: the cache at the cell's
    batch and sequence (``pos`` the int32 counter), tokens (B, 1)."""
    aparams = model.abstract_params()
    cache = abstract_cache(model.cache_zeros(case.global_batch, case.seq_len,
                                             device="meta"))
    acache = with_shardings(cache, cache_shardings(cache))
    return aparams, acache, _abstract_batch(model, case)["tokens"]


def abstract_prefill_args(model, case: ShapeCase):
    """``(params, batch)`` of a prefill cell."""
    return model.abstract_params(), _abstract_batch(model, case)


def prefill_out_shardings(model, case: ShapeCase, step, outputs=None):
    """``(logits, cache)`` output shardings: the last logits on ``batch``,
    the cache as ``cache_shardings`` lays it out. ``outputs`` is the step's
    result on ``abstract_prefill_args`` (run here, on meta, when not
    given)."""
    rules = mesh_rules()
    if outputs is None:
        outputs = step(*abstract_prefill_args(model, case))
    logits, cache = outputs
    logits_sh = NamedSharding(rules.mesh,
                              rules.resolve(("batch", None), logits.shape))
    return logits_sh, cache_shardings(abstract_cache(cache))
