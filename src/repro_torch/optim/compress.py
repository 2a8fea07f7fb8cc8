"""Gradient compression: int8 quantization with error feedback, mirroring
``src/repro/optim/compress.py``.

The reference quantizes each shard's gradients to int8 on one shared
absmax scale, sums the int8 lattices in int32 over a mesh axis under
``shard_map``, dequantizes the mean and carries each shard's quantization
residual into its next step. Here the shards are the in-process mesh's
(``parallel.mesh``): ``compressed_psum_mean`` takes one grad tree a shard
of the axis and returns one mean tree and one error tree a shard.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..models.params import tree_leaves, tree_unflatten
from ..parallel import mesh as _mesh


def compress_int8(x: torch.Tensor, scale: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` as int8 on ``scale`` (default: its own absmax / 127)."""
    if scale is None:
        scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    scale = scale.to(x.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum_mean(grads: List, mesh, axis: str, error=None):
    """Quantize → psum (int8 lattices summed in int32) → dequantize, with
    error feedback, over ``axis`` of ``mesh``.

    ``grads`` holds one grad tree a shard along ``axis``, ``error`` (or
    None) one residual tree a shard. Every shard quantizes on one scale,
    the max over the shards of each leaf's absmax (the reference's
    ``pmax``), so the int32 sum of the lattices is exact. Returns
    ``(means, errors)``: the mean tree replicated on every shard's device,
    and each shard's new residual ``g − dequantized(q)``."""
    n = mesh.shape[axis]
    if len(grads) != n:
        raise ValueError(f"compressed_psum_mean: {len(grads)} grad trees for "
                         f"the {n} shards of axis {axis!r}")
    flat = [tree_leaves(g) for g in grads]
    errs = [tree_leaves(e) for e in error] if error is not None else None
    means = [[] for _ in range(n)]
    new_e = [[] for _ in range(n)]
    for j in range(len(flat[0])):
        gs = [flat[d][j].to(torch.float32) for d in range(n)]
        if errs is not None:
            gs = [g + errs[d][j] for d, g in enumerate(gs)]
        first = gs[0].device
        gmax = torch.stack([torch.max(torch.abs(g)).to(first) for g in gs]
                           ).max()
        scale = gmax / 127.0 + 1e-12
        packed = [compress_int8(g, scale) for g in gs]
        total = _mesh.psum([q.to(torch.int32) for q, _ in packed])
        mean = total.to(torch.float32) * scale / n
        for d, (q, q_scale) in enumerate(packed):
            means[d].append(mean.to(gs[d].device, copy=True))
            new_e[d].append(gs[d] - decompress_int8(q, q_scale))
    return ([tree_unflatten(grads[d], means[d]) for d in range(n)],
            [tree_unflatten(grads[d], new_e[d]) for d in range(n)])
