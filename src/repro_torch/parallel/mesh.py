"""An in-process device mesh and the collectives the distributed SpGEMM
schedules use, in place of ``jax.sharding.Mesh``, ``shard_map`` and the
``jax.lax`` collectives of ``src/repro/core/distributed.py``.

The reference runs one program a device under ``shard_map``. Here one host
program drives every shard: a sharded value is a list with one tensor a
device of the mesh axis, and a collective maps such lists to lists:

  * ``ppermute(shards, perm)`` — ``out[dst] = shards[src]`` for each
    ``(src, dst)`` pair, zeros where nothing arrives. Each arrival is a
    fresh buffer on its destination (``Tensor.to(..., copy=True)``), so no
    two shards alias, even when every device of the mesh is ``cuda:0``.
  * ``ppermute_start(shards, perm)`` — the same copies issued on a side
    stream of each destination device, after the work already queued on
    the sources; ``.wait()`` makes the current streams wait for them and
    returns the shards. It lets a schedule copy the next operand panel
    while the current panel's products are formed (``overlap=True``).
  * ``psum(shards)`` — the sum on the first device, added in device
    order, device 0 first.
  * ``ring_all_to_all(shards)`` — chunk ``i`` of shard ``d`` ends as chunk
    ``d`` of shard ``i``, by ``n - 1`` whole-buffer rotations around the
    ring (the reference's collective of the same name).

A ``Mesh`` is an array of torch devices with axis names; a device may
repeat, so four shards of one card are ``make_mesh((4,), ("x",))`` on a
one-card machine. Its ``shape`` maps each axis name to its size, as
JAX's does. A mesh may have any number of axes: ``axis_groups(axis)`` lists
the device groups along one axis, and the sharded paths run on the first
group (``axis_devices``), the other axes replicating. ``make_mesh`` defaults to the CUDA devices; a CPU mesh exists
only where the caller passes CPU devices.

The partitioned LM program (``parallel.sharding.Sharded``) adds three
collectives over the groups of one or more mesh axes:

  * ``all_gather(groups, dim)`` — each group's shards concatenated along
    ``dim``, in group order, on every shard of the group.
  * ``reduce_scatter(groups, dim)`` — each group's shards summed in group
    order (shard 0 first) and cut along ``dim``: piece ``i`` on shard ``i``.
  * ``all_reduce(groups)`` — the sum, in the same order, on every shard.

Each takes every group of its axes at once, as one SPMD op of the
reference's program is: it adds one op of its kind, and one device's
output bytes, to ``collectives()`` (the reference dry run's kinds and
measure, ``src/repro/launch/dryrun.py:47-72``). Under autograd each is one
``torch.autograd.Function`` whose backward runs its dual collective on the
gradients, counted the same way: an all-gather's backward is a
reduce-scatter and the reverse, an all-reduce's an all-reduce. So a
shard's gradient of a value every shard holds is a partial sum, whose
total over the shards is the gradient (the transposes of
``shard_map``'s collectives). On ``meta`` tensors (the
dry run) each group holds one shard standing for all ``size`` of them:
the op computes its output's shape, counts it, and loops over nothing.
``ppermute`` counts as a ``collective-permute`` and ``psum`` as an
``all-reduce``.

``moved_bytes()`` reads, and ``reset_moved_bytes()`` zeroes, the bytes the
collectives have copied between shards (the tensors' sizes: what
``ppermute`` delivers, what ``psum`` brings to the first device, each
piece another shard's ``all_gather`` or ``reduce_scatter`` reads and each
copy of an ``all_reduce``'s sum), and what ``place`` copies to another
device (a block already on its device is taken as a view and counts
nothing). ``collectives()`` reads, and ``reset_collectives()`` zeroes, the
op counter.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

Shards = List[torch.Tensor]


class Mesh:
    """Devices laid out on named axes: ``Mesh(devices, axis_names)`` with
    ``devices`` a (nested) sequence of ``torch.device`` or device strings
    whose nesting depth is the number of axes."""

    def __init__(self, devices, axis_names):
        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        axis_names = tuple(axis_names)
        given = np.array(devices, dtype=object)
        arr = np.empty(given.shape, dtype=object)
        for pos, dev in np.ndenumerate(given):
            arr[pos] = torch.device(dev)
        if arr.ndim != len(axis_names) or arr.size == 0:
            raise ValueError(f"a mesh of shape {arr.shape} needs "
                             f"{arr.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        if len({d.type for d in arr.reshape(-1)}) != 1:
            raise ValueError("a mesh's devices must be of one type, got "
                             f"{sorted({str(d) for d in arr.reshape(-1)})}")
        self.devices = arr
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, arr.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_groups(self, axis: str) -> List[List[torch.device]]:
        """One device list along ``axis`` for each coordinate of the other
        axes, in row-major order of those coordinates: the groups a
        collective over ``axis`` runs in under ``shard_map``."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r} (axes "
                             f"{self.axis_names})")
        i = self.axis_names.index(axis)
        lanes = np.moveaxis(self.devices, i, -1).reshape(-1,
                                                         self.shape[axis])
        return [list(row) for row in lanes]

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis, in
        order. The sharded paths run on them, and the other axes replicate,
        as ``n_dev = mesh.shape[axis]`` under ``shard_map`` has every group
        along ``axis`` compute the same result."""
        return self.axis_groups(axis)[0]

    def device_at(self, coords) -> torch.device:
        """The device at ``coords`` (``{axis: index}``), index 0 on every
        axis ``coords`` does not name."""
        return self.devices[tuple(coords.get(a, 0) for a in self.axis_names)]

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, "
                f"devices={[str(d) for d in self.devices.reshape(-1)]})")


def make_mesh(shape: Sequence[int], axis_names, devices=None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (any sequence of ``prod(shape)``
    devices, laid out row-major). Without ``devices``: the first
    ``prod(shape)`` CUDA devices, or that many repeats of ``cuda:0`` on a
    one-card machine; no CUDA raises ``RuntimeError``."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh defaults to CUDA devices and none "
                               "is available; pass devices=['cpu'] * n for "
                               "a mesh of the plain torch versions")
        count = torch.cuda.device_count()
        if count >= n:
            devices = [torch.device("cuda", i) for i in range(n)]
        elif count == 1:
            devices = [torch.device("cuda", 0)] * n
        else:
            raise ValueError(f"{n} shards over {count} cards: pass devices=")
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"mesh shape {shape} needs {n} devices, got "
                         f"{len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr.reshape(shape), axis_names)


_MOVED = [0]
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
_OPS = {k: [0, 0] for k in KINDS}


def moved_bytes() -> int:
    """Bytes the collectives have copied since the last reset."""
    return _MOVED[0]


def reset_moved_bytes() -> None:
    _MOVED[0] = 0


def collectives() -> Tuple[dict, dict]:
    """``(bytes, count)`` by kind since the last reset: one device's output
    bytes of every collective op, and the ops."""
    return ({k: v[0] for k, v in _OPS.items()},
            {k: v[1] for k, v in _OPS.items()})


def reset_collectives() -> None:
    for v in _OPS.values():
        v[0] = v[1] = 0


def _count(kind: str, out: torch.Tensor) -> None:
    _OPS[kind][0] += out.numel() * out.element_size()
    _OPS[kind][1] += 1


def ring_perm(n: int) -> List[Tuple[int, int]]:
    """Each device to its successor on the ring."""
    return [(i, (i + 1) % n) for i in range(n)]


def _copy(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    _MOVED[0] += x.numel() * x.element_size()
    return x.to(dev, non_blocking=True, copy=True)


def arrive(x: torch.Tensor, dev) -> torch.Tensor:
    """``x`` read by a shard on ``dev`` that does not hold it: moved there
    (a view where it lies there already, the reader copying it into its
    output), counted in ``moved_bytes``."""
    _MOVED[0] += x.numel() * x.element_size()
    return x.to(dev, non_blocking=True)


def place(x: torch.Tensor, dev) -> torch.Tensor:
    """``x`` on ``dev``: ``x`` itself (a view stays a view) where it lies
    there already, else a copy, counted in ``moved_bytes``."""
    dev = torch.device(dev)
    return x if x.device == dev else _copy(x, dev)


def _receivers(shards: Shards, perm):
    dst_of = {}
    for src, dst in perm:
        if dst in dst_of:
            raise ValueError(f"ppermute: device {dst} receives twice")
        dst_of[dst] = src
    return dst_of


def ppermute(shards: Shards, perm) -> Shards:
    """``out[dst] = shards[src]`` for each ``(src, dst)`` in ``perm``, each
    a fresh copy on ``shards[dst]``'s device; zeros where nothing
    arrives."""
    dst_of = _receivers(shards, perm)
    _count("collective-permute", shards[0])
    return [_copy(shards[dst_of[d]], x.device) if d in dst_of
            else torch.zeros_like(x) for d, x in enumerate(shards)]


class Pending:
    """Copies of a ``ppermute_start`` in flight; ``wait()`` returns them."""

    def __init__(self, shards: Shards, streams):
        self._shards = shards
        self._streams = streams

    def wait(self) -> Shards:
        for dev, side in self._streams:
            torch.cuda.current_stream(dev).wait_stream(side)
        return self._shards


def ppermute_start(shards: Shards, perm) -> Pending:
    """``ppermute`` issued on a side stream of each CUDA destination, after
    the work already queued on the source's current stream. The sources
    stay valid until the copies end and the arrivals until their readers
    on the current streams end (``record_stream``). CPU shards are copied
    at once."""
    dst_of = _receivers(shards, perm)
    _count("collective-permute", shards[0])
    out, streams = [], []
    for d, x in enumerate(shards):
        if d not in dst_of:
            out.append(torch.zeros_like(x))
            continue
        src = shards[dst_of[d]]
        if x.device.type != "cuda":
            out.append(_copy(src, x.device))
            continue
        ready = torch.cuda.current_stream(src.device).record_event()
        side = torch.cuda.Stream(device=x.device)
        with torch.cuda.stream(side):
            side.wait_event(ready)
            got = _copy(src, x.device)
        src.record_stream(side)
        got.record_stream(torch.cuda.current_stream(x.device))
        out.append(got)
        streams.append((x.device, side))
    return Pending(out, streams)


def psum(shards: Shards) -> torch.Tensor:
    """The shards' sum on the first shard's device, added in device order
    (device 0 first), as a new tensor."""
    acc = shards[0].clone()
    for x in shards[1:]:
        acc += arrive(x, acc.device)
    _count("all-reduce", acc)
    return acc


def _all_gather(groups: Sequence[Shards], dim: int, n: int) -> List[Shards]:
    x0 = groups[0][0]
    if x0.is_meta:
        shape = list(x0.shape)
        shape[dim] *= n
        out = [[x0.new_empty(shape) for _ in g] for g in groups]
    else:
        out = [[torch.cat([y if j == i else arrive(y, x.device)
                           for j, y in enumerate(g)], dim)
                for i, x in enumerate(g)] for g in groups]
    _count("all-gather", out[0][0])
    return out


def _reduce_scatter(groups: Sequence[Shards], dim: int,
                    n: int) -> List[Shards]:
    x0 = groups[0][0]
    if x0.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x0.shape)} "
                         f"does not split {n} ways")
    c = x0.shape[dim] // n
    if x0.is_meta:
        out = [[x0.narrow(dim, 0, c).clone() for _ in g] for g in groups]
    else:
        out = []
        for g in groups:
            row = []
            for i, x in enumerate(g):
                acc = None
                for j, y in enumerate(g):
                    part = y.narrow(dim, i * c, c)
                    part = part if j == i else arrive(part, x.device)
                    acc = part.clone() if acc is None else acc + part
                row.append(acc)
            out.append(row)
    _count("reduce-scatter", out[0][0])
    return out


def _all_reduce(groups: Sequence[Shards], dim: int, n: int) -> List[Shards]:
    x0 = groups[0][0]
    if x0.is_meta:
        out = [[x.clone() for x in g] for g in groups]
    else:
        out = []
        for g in groups:
            acc = g[0].clone()
            for y in g[1:]:
                acc += arrive(y, acc.device)
            out.append([acc] + [_copy(acc, x.device) for x in g[1:]])
    _count("all-reduce", out[0][0])
    return out


_RUN = {"all-gather": _all_gather, "reduce-scatter": _reduce_scatter,
        "all-reduce": _all_reduce}
# the collective whose op is each one's transpose: its backward
_DUAL = {"all-gather": "reduce-scatter", "reduce-scatter": "all-gather",
         "all-reduce": "all-reduce"}


def _regroup(flat, lens) -> List[list]:
    out, i = [], 0
    for n in lens:
        out.append(list(flat[i:i + n]))
        i += n
    return out


class _Collective(torch.autograd.Function):
    """One collective op over every group at once, under autograd: the
    shards go in flat (``lens`` the groups' sizes), and the backward runs
    the dual collective (``_DUAL``) on the outputs' gradients, counted
    like a forward op. A gradient autograd does not deliver is zeros."""

    @staticmethod
    def forward(ctx, kind, dim, n, lens, *flat):
        ctx.kind, ctx.dim, ctx.n, ctx.lens = kind, dim, n, lens
        out = _RUN[kind](_regroup(flat, lens), dim, n)
        return tuple(x for g in out for x in g)

    @staticmethod
    def backward(ctx, *grads):
        out = _RUN[_DUAL[ctx.kind]](_regroup(grads, ctx.lens), ctx.dim,
                                    ctx.n)
        return (None, None, None, None) + tuple(x for g in out for x in g)


def _collective(kind: str, groups: Sequence[Shards], dim: int,
                size: int) -> List[Shards]:
    n = size or len(groups[0])
    flat = [x for g in groups for x in g]
    if not (torch.is_grad_enabled() and any(x.requires_grad for x in flat)):
        return _RUN[kind](groups, dim, n)
    lens = [len(g) for g in groups]
    return _regroup(_Collective.apply(kind, dim, n, lens, *flat), lens)


def all_gather(groups: Sequence[Shards], dim: int,
               size: int = 0) -> List[Shards]:
    """Each group's shards concatenated along ``dim`` in group order, a
    fresh tensor on each shard's device. ``size``: the group's size where a
    meta group holds one shard standing for all. Its backward is a
    ``reduce_scatter`` of the gradients along ``dim``."""
    return _collective("all-gather", groups, dim, size)


def reduce_scatter(groups: Sequence[Shards], dim: int,
                   size: int = 0) -> List[Shards]:
    """Each group's shards summed in group order (shard 0 first) and cut
    into ``n`` pieces along ``dim``: piece ``i`` on shard ``i``. Its
    backward is an ``all_gather`` of the gradients along ``dim``."""
    return _collective("reduce-scatter", groups, dim, size)


def all_reduce(groups: Sequence[Shards], size: int = 0) -> List[Shards]:
    """Each group's sum, added in group order (shard 0 first) on shard 0's
    device, then copied to every other shard of the group. Its backward is
    an ``all_reduce`` of the gradients."""
    return _collective("all-reduce", groups, 0, size)


def ring_all_to_all(shards: Shards) -> Shards:
    """All-to-all over the ring: shard ``d`` is ``(n, chunk, ...)`` with
    chunk ``i`` bound for device ``i``; the result's shard ``d`` holds in
    chunk ``i`` what device ``i`` sent it. Each device keeps its own chunk,
    then the whole buffers rotate ``n - 1`` times, each device taking its
    chunk from the buffer visiting it."""
    n = len(shards)
    for x in shards:
        if x.shape[0] != n:
            raise ValueError(f"ring_all_to_all: {n} shards need a leading "
                             f"axis of {n}, got {tuple(x.shape)}")
    out = [torch.empty_like(x) for x in shards]
    for d in range(n):
        out[d][d] = shards[d][d]
    buf, perm = shards, ring_perm(n)
    for i in range(n - 1):
        buf = ppermute(buf, perm)
        for d in range(n):
            out[d][(d - i - 1) % n] = buf[d][d]
    return out
