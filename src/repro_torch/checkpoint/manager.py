"""Atomic checkpoints in the reference's layout, mirroring
``src/repro/checkpoint/manager.py``.

Layout (one directory per step):
    <root>/step_00000100.tmp/...     (written first)
    <root>/step_00000100/            (atomic rename after fsync)
        manifest.json                step, time, extra, every leaf's shape
                                     and dtype
        shard_0.npz                  ``params/<path>`` and ``opt/<path>``

``<path>`` is the reference's ``_flatten`` key: dict keys and list indices
joined by ``/`` (``segments/0/u0/attn/wq``), as ``models.params.tree_items``
gives it. A directory without a manifest or with the ``.tmp`` suffix is a
partial write and is ignored; ``keep_n`` newest steps are kept. Leaves are
saved whole from any device and restored onto the device asked for.

Placed trees (``parallel.sharding.Sharded`` leaves, a training step's
params and ZeRO-1 moments on a mesh) keep the same format: ``save``
assembles each leaf on the host from its distinct blocks, each copied
from its device once (no device gather), and ``restore`` places each leaf
by the layout of its placed ``*_like`` leaf, on that leaf's mesh. So a
checkpoint written on one mesh restores onto another, or whole, bit for
bit, as the reference's ``restore(shardings=)`` does, and checkpoints
still cross packages.

numpy has no bfloat16 (and the card's machine has no ``ml_dtypes``): a
bfloat16 leaf is stored as its raw 2-byte records (numpy ``|V2``, as the
reference's ``np.savez`` of an ``ml_dtypes`` array writes them) with
``"dtype": "bfloat16"`` in the manifest, and read back bit for bit, so the
reference's bfloat16 checkpoints restore here too.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..models.params import tree_items, tree_unflatten

_RAW16 = np.dtype("V2")


def _host(x) -> torch.Tensor:
    """A placed leaf whole on the host: each distinct block (by its place
    in the leaf) copied from its device once."""
    out = torch.empty(x.shape, dtype=x.dtype)
    done = set()
    for c, b in x.blocks.items():
        idx = x.index(c)
        key = tuple((s.start, s.stop) for s in idx)
        if key not in done:
            done.add(key)
            out[idx] = b.detach().cpu()
    return out


def _to_numpy(x) -> np.ndarray:
    from ..parallel.sharding import Sharded
    if isinstance(x, Sharded):
        x = _host(x)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(_RAW16)
        return x.numpy()
    return np.asarray(x)


def _dtype_name(x) -> str:
    from ..parallel.sharding import Sharded
    if isinstance(x, (torch.Tensor, Sharded)):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        bits = np.asarray(arr, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(arr, order="C"))


class CheckpointManager:
    def __init__(self, root: str, keep_n: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n

    # -- save ----------------------------------------------------------------
    def save(self, step: int, params: Any, opt_state: Any,
             extra: Optional[dict] = None) -> Path:
        tmp = self.root / f"step_{step:08d}.tmp"
        final = self.root / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

        leaves = {f"{prefix}/{k}": v
                  for prefix, tree in (("params", params), ("opt", opt_state))
                  for k, v in tree_items(tree, sort=True)}
        np.savez(tmp / "shard_0.npz",
                 **{k: _to_numpy(v) for k, v in leaves.items()})

        manifest = {
            "step": step,
            "time": time.time(),
            "extra": extra or {},
            "leaves": {k: {"shape": list(v.shape), "dtype": _dtype_name(v)}
                       for k, v in leaves.items()},
        }
        mpath = tmp / "manifest.json"
        mpath.write_text(json.dumps(manifest, indent=1))
        with open(mpath) as f:      # fsync before the atomic publish
            os.fsync(f.fileno())
        os.replace(tmp, final)      # atomic: either fully there or not at all
        self._gc()
        return final

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep_n]:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def all_steps(self):
        out = []
        for p in self.root.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue            # incomplete write — ignored by design
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, params_like: Any, opt_like: Any,
                device=None):
        """The checkpoint of ``step`` in the structure and dtypes of
        ``(params_like, opt_like)``, on ``device`` (the card unless the
        caller asks for another). A placed leaf of the ``*_like`` trees
        (``Sharded``) gives its leaf's layout: the leaf is placed by its
        spec on its mesh (``sharding.shard``), whatever mesh wrote it.
        Returns ``(params, opt_state, extra)``."""
        from ..core.formats import resolve_device
        from ..parallel.sharding import Sharded, shard
        dev = resolve_device(device)
        d = self.root / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        data = np.load(d / "shard_0.npz")

        def one(key, like):
            arr = _from_numpy(data[key], manifest["leaves"][key]["dtype"])
            if isinstance(like, Sharded):
                return shard(arr.to(like.dtype), like.spec, like.mesh)
            return arr.to(device=dev, dtype=like.dtype)

        def rebuild(tree, prefix):
            return tree_unflatten(tree, [one(f"{prefix}/{path}", like)
                                         for path, like in tree_items(tree)])

        params = rebuild(params_like, "params")
        opt = rebuild(opt_like, "opt")
        return params, opt, manifest["extra"]
