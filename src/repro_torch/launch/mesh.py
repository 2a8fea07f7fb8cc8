"""Mesh construction, mirroring ``src/repro/launch/mesh.py``.

Functions, not module constants: importing this module touches no
device.
"""
from __future__ import annotations

import math

import torch

from ..core.formats import resolve_device
from ..parallel.mesh import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production meshes the dry run lays its cells out on: 16 x 16 =
    256 devices a pod on ``("data", "model")``, or two pods, (2, 16, 16) =
    512 on ``("pod", "data", "model")``. Its devices are ``meta``: the dry
    run reads only the mesh's shape."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, [torch.device("meta")] * math.prod(shape))


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


def launch_mesh(model_parallel: int = 1, device=None, devices=None) -> Mesh:
    """The mesh ``launch/train.py`` and ``launch/serve.py`` run under:
    ``make_host_mesh(model_parallel, devices)``. Without ``devices``: every
    card where ``device`` is the card (``None`` or ``"cuda"``), else
    ``[device]`` (``"cpu"``, ``"cuda:1"``). A ``device`` of another type
    than ``devices`` raises ``ValueError``."""
    if devices is None:
        dev = resolve_device(device)
        if dev.type != "cuda" or dev.index is not None:
            devices = [dev]
    elif device is not None and \
            torch.device(device).type != torch.device(devices[0]).type:
        raise ValueError(f"--device {device} and devices {devices} differ")
    return make_host_mesh(model_parallel, devices)
