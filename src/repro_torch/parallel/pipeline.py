"""GPipe-style pipeline parallelism over one axis of the in-process mesh,
mirroring ``src/repro/parallel/pipeline.py``.

``pipeline_apply`` runs ``n_stages`` stage functions over microbatches with
the fill/drain schedule: stage ``s`` holds slice ``s`` of the stacked
parameters on the axis's device ``s``; at tick ``t`` it runs microbatch
``t − s`` (stage 0 takes it from the input, the others from their buffer),
and the activations move one stage on with ``mesh.ppermute`` (a fresh copy
on the next stage's device, the reference's neighbour-only ring). Bubble
fraction = (S − 1)/(M + S − 1). The reference computes every stage every
tick and masks the idle ones; here an idle stage computes nothing, with the
same outputs.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models.params import tree_map
from . import mesh as _mesh


def pipeline_apply(stage_fn: Callable, params_stacked, x_microbatches,
                   mesh, axis: str = "pipe"):
    """Run a homogeneous-stage pipeline.

    stage_fn(params_slice, x) -> x      one stage's computation
    params_stacked: leaves (n_stages, ...), slice s placed on stage s
    x_microbatches: (n_micro, mb, ...) input microbatches
    Returns (n_micro, mb, ...): the last stage's outputs, on the axis's
    first device (the reference's replicated result)."""
    devices = mesh.axis_devices(axis)
    n_stages = len(devices)
    stage_params = [tree_map(lambda a, s=s: a[s].to(devices[s]),
                             params_stacked) for s in range(n_stages)]
    xs = x_microbatches.to(devices[0])
    n_micro = xs.shape[0]
    buf = [torch.zeros_like(xs[0], device=d) for d in devices]
    outs = [None] * n_micro
    perm = _mesh.ring_perm(n_stages)
    for t in range(n_micro + n_stages - 1):
        ys = []
        for s in range(n_stages):
            m = t - s
            if 0 <= m < n_micro:
                y = stage_fn(stage_params[s], xs[m] if s == 0 else buf[s])
                if s == n_stages - 1:
                    outs[m] = y
            else:
                y = buf[s]
            ys.append(y)
        buf = _mesh.ppermute(ys, perm)
    return torch.stack([o.to(devices[0]) for o in outs])
