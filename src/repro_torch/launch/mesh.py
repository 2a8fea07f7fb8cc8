"""Host mesh construction, mirroring ``src/repro/launch/mesh.py``.

A function, not a module constant: importing this module touches no
device. ``make_production_mesh`` (the (16, 16) and (2, 16, 16) TPU pod
meshes) serves only the XLA dry-run and is not ported (ROADMAP queue 1
item 11).
"""
from __future__ import annotations

import torch

from ..parallel.mesh import Mesh, make_mesh


def make_host_mesh(model_parallel: int = 1, devices=None) -> Mesh:
    """A ``("data", "model")`` mesh of shape ``(n // model_parallel,
    model_parallel)`` over ``devices`` (default: every card of this host,
    so (1, 1) on one H100)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_host_mesh defaults to the CUDA devices "
                               "and none is available; pass devices=")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = len(devices)
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} does not divide "
                         f"the {n} devices")
    return make_mesh((n // model_parallel, model_parallel),
                     ("data", "model"), devices)
