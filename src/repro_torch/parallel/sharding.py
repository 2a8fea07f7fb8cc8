"""Sharding, mirroring ``src/repro/parallel/sharding.py``: the LM stack's
logical-axis rules, and the distributed SpGEMM operands' placement
(``spgemm_operand_specs``, ``put_spgemm_operands``).

A spec is a tuple with one entry an array axis: the mesh axis name the
axis is split over, a tuple of names (split over their product, the first
outermost), or ``None`` (JAX's ``PartitionSpec``). ``()`` is replicated.

Logical-axis rules (MaxText-style). Model code names each array axis
logically ("batch", "ff", "heads", "expert", ...); a ``ShardingRules``
maps logical names to mesh axes, and ``resolve`` turns an array's logical
axes into a spec, dropping a mapping that does not divide the dimension
(yi-34b's 56 heads on a 16-way model axis are then replicated). Rules are
set for a thread by the ``sharding_rules`` context, as the reference sets
them. The resolved specs give each argument's per-device layout and bytes
(``shard_shape``; the dry run, ``launch/dryrun.py``). Values change under
a mesh only where the reference's do: the MoE layer groups its tokens by
data shard (``axis_size("batch")``) and runs its ``'sort'`` region shard
by shard (``shard_block`` slices its inputs as ``shard_map`` would;
``models/ffn.py``).

The port has no partitioner for a constraint to steer: ``maybe_shard``
only checks its spec, as the reference's ``with_sharding_constraint``
would, and returns its input. The partitioned program lays itself out
explicitly instead. A ``Sharded`` is a tensor laid out on a mesh by a
spec, one block a mesh coordinate (``shard`` places one, ``smap`` computes
block by block), and its layout changes only through counted collectives
(``gather``, ``reduce``; ``relayout`` picks them) or local cuts
(``split``). All of them run under autograd: a collective's backward is
its dual (``parallel.mesh``), so a value every coordinate holds gets
partial cotangents. ``grad_leaves`` makes each coordinate's block of a
placed leaf an autograd leaf of its own and ``leaf_grads`` gives, from
one backward, each leaf's gradient laid out like it, partial over the
axes it is replicated over. ``logical_to_pspec`` and ``maybe_shard`` keep
the reference's API: no code of the port calls them.

A ``ShardedEll`` is an ELLPACK operand placed on a mesh: one ``(val,
idx)`` pair a device, split along one plane axis or held whole by every
device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.formats import EllCols, EllRows
from .mesh import Mesh

Spec = Tuple

# Default logical -> mesh mapping for the production mesh: "batch"-like axes
# go to data(+pod) parallelism, width-like axes to tensor parallelism;
# "seq_shard" shards the decode cache's sequence, "expert" the MoE experts.
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "ff": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "qkv_flat": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "expert_ff": ("model",),
    "seq_shard": ("model",),   # decode KV-cache sequence axis (flash-decode)
    "seq_act": ("model",),     # Megatron-SP: residual-stream seq sharding
    "fsdp": ("data",),         # ZeRO-3: weights sharded over the data axis
    "opt_shard": ("data",),    # ZeRO-1: optimizer state sharded over data
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Optional[Mesh]
    rules: Dict[str, Tuple[str, ...]]

    def axis_size(self, mesh_axis: str) -> int:
        if self.mesh is None or mesh_axis not in self.mesh.shape:
            return 1
        return self.mesh.shape[mesh_axis]

    def resolve(self, logical_axes: Sequence[Optional[str]],
                shape: Sequence[int]) -> Spec:
        """Logical axes -> spec, greedy in each rule's order: a mesh axis
        already used by an earlier array axis or absent from the mesh is
        skipped, and one whose size (times the axes already chosen for
        this array axis) does not divide the dimension is dropped."""
        if len(logical_axes) != len(shape):
            raise ValueError(f"logical axes {tuple(logical_axes)} do not "
                             f"match shape {tuple(shape)}")
        used: set = set()
        parts = []
        for dim, name in zip(shape, logical_axes):
            if name is None or self.mesh is None:
                parts.append(None)
                continue
            chosen = []
            size = 1
            for ax in self.rules.get(name, ()):
                if ax in used or ax not in self.mesh.shape:
                    continue
                nxt = size * self.mesh.shape[ax]
                if dim % nxt == 0:
                    chosen.append(ax)
                    size = nxt
            if chosen:
                used.update(chosen)
                parts.append(tuple(chosen) if len(chosen) > 1 else chosen[0])
            else:
                parts.append(None)
        return tuple(parts)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``)."""
    mesh: Mesh
    spec: Spec

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return shard_shape(self.spec, shape, self.mesh)


def _split(entry, mesh: Mesh) -> int:
    """How many ways one spec entry splits its axis."""
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(mesh.shape[n] for n in names)


def shard_shape(spec: Spec, shape: Sequence[int],
                mesh: Mesh) -> Tuple[int, ...]:
    """One device's block of an array of ``shape`` laid out by ``spec``
    (entries past the spec's length are whole). Every split must divide
    its dimension, as ``resolve`` guarantees."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} is longer than shape {tuple(shape)}")
    out = []
    for i, dim in enumerate(shape):
        n = _split(spec[i], mesh) if i < len(spec) else 1
        if dim % n:
            raise ValueError(f"spec {spec} splits dim {i} of {tuple(shape)} "
                             f"{n} ways")
        out.append(dim // n)
    return tuple(out)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one spec entry names, outermost first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def entry_pos(entry, mesh: Mesh, coords: Dict[str, int]) -> int:
    """The index of the block along one array axis split by ``entry`` that
    the device at ``coords`` holds (its axes' coordinates, outermost
    first)."""
    pos = 0
    for ax in spec_axes(entry):
        pos = pos * mesh.shape[ax] + coords.get(ax, 0)
    return pos


def shard_block(x: torch.Tensor, spec: Spec, mesh: Mesh,
                coords: Dict[str, int]) -> torch.Tensor:
    """The block of ``x`` laid out by ``spec`` that the device at ``coords``
    (``{axis: index}``, 0 on the axes it does not name) holds, as a view of
    ``x``: ``shard_map``'s in-spec slicing."""
    block = shard_shape(spec, x.shape, mesh)
    for i, entry in enumerate(spec):
        if entry is not None:
            x = x.narrow(i, entry_pos(entry, mesh, coords) * block[i],
                         block[i])
    return x


_state = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_state, "rules", None)


def mesh_rules() -> ShardingRules:
    """The active rules, which must have a mesh (``sharding_rules(mesh)``):
    the layouts of the dry run's trees need one."""
    r = current_rules()
    if r is None or r.mesh is None:
        raise RuntimeError("no sharding_rules(mesh) is active")
    return r


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    """Make ``rules`` (``None``: none) this thread's within the block; the
    previous ones come back after it. A recompute that autograd runs on
    its own thread (an activation checkpoint's backward on the card)
    re-enters the rules of its forward so."""
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def sharding_rules(mesh: Optional[Mesh],
                   rules: Optional[Dict[str, Tuple[str, ...]]] = None):
    """Set the rules for this thread within the block (``DEFAULT_RULES``
    unless ``rules`` is given); the previous ones come back after it."""
    return use_rules(ShardingRules(mesh, dict(rules or DEFAULT_RULES)))


def logical_to_pspec(logical_axes: Sequence[Optional[str]],
                     shape: Sequence[int]) -> Spec:
    r = current_rules()
    if r is None or r.mesh is None:
        return ()
    return r.resolve(logical_axes, shape)


def maybe_shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical axes. The
    eager program has no partitioner for a constraint to steer, so this
    returns ``x``; under a mesh it resolves the spec, so logical axes that
    do not match ``x``'s rank raise."""
    r = current_rules()
    if r is not None and r.mesh is not None:
        r.resolve(logical_axes, x.shape)
    return x


def named_sharding(logical_axes: Sequence[Optional[str]],
                   shape: Sequence[int]) -> Optional[NamedSharding]:
    r = current_rules()
    if r is None or r.mesh is None:
        return None
    return NamedSharding(r.mesh, r.resolve(logical_axes, shape))


def axis_size(logical_name: str) -> int:
    """Product of mesh-axis sizes a logical axis maps to (1 without mesh)."""
    r = current_rules()
    if r is None or r.mesh is None:
        return 1
    total = 1
    for ax in r.rules.get(logical_name, ()):
        total *= r.axis_size(ax)
    return total


# ---------------------------------------------------------------------------
# The partitioned program: tensors laid out on a mesh, and their layouts
# ---------------------------------------------------------------------------

Coord = Tuple[int, ...]


def _meta(mesh: Mesh) -> bool:
    return mesh.devices.flat[0].type == "meta"


def mesh_coords(mesh: Mesh) -> List[Coord]:
    """The coordinates a partitioned program runs at, row-major. On a mesh
    of ``meta`` devices one, all zeros, stands for each: the dry run traces
    one device's program."""
    if _meta(mesh):
        return [(0,) * len(mesh.axis_names)]
    return list(np.ndindex(*mesh.devices.shape))


def _at(mesh: Mesh, c: Coord) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, c))


def _entry(axes: Sequence[str]):
    """A spec entry naming ``axes`` (None for none)."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


class Sharded:
    """A tensor of global ``shape`` laid out on ``mesh`` by ``spec`` (a
    ``jax.Array`` under a ``NamedSharding``): ``blocks[c]`` is the block the
    device at mesh coordinate ``c`` holds, ``shard_block``'s cut of
    ``shard_shape``'s shape, on that device. Where a tensor is placed
    (``shard``, ``sharded_zeros``), coordinates holding one block on one
    device (a replicated axis, a device repeated in the mesh) share its
    storage; a computed one (``smap``) has a block a coordinate, as each
    device of the reference's program computes its own. ``partial`` names
    the mesh axes over which the blocks are partial sums still to be added
    (a row-parallel product's output; ``reduce``). On a meta mesh one
    coordinate stands for all (``mesh_coords``)."""

    def __init__(self, mesh: Mesh, spec: Spec, shape: Sequence[int],
                 blocks: Dict[Coord, torch.Tensor],
                 partial: Tuple[str, ...] = ()):
        self.mesh = mesh
        self.shape = tuple(shape)
        self.spec = tuple(spec) + (None,) * (len(self.shape) - len(spec))
        self.blocks = blocks
        self.partial = tuple(partial)

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.blocks.values())).dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, spec={self.spec}, "
                f"partial={self.partial}, mesh={self.mesh.shape})")

    def __getitem__(self, i: int) -> "Sharded":
        """Layer ``i`` of a stacked leaf (its first dim whole): a view of
        each block."""
        if not isinstance(i, int) or self.spec[0] is not None:
            raise TypeError(f"a Sharded takes an int index on a whole first "
                            f"dim, not {i!r} on spec {self.spec}")
        return Sharded(self.mesh, self.spec[1:], self.shape[1:],
                       {c: b[i] for c, b in self.blocks.items()},
                       self.partial)

    def unbind(self, dim: int = 0) -> List["Sharded"]:
        """The layers of a stacked leaf (its first dim whole), each block
        split once with ``unbind``, whose backward stacks the layers'
        gradients once (indexing layer by layer would add a zero-filled
        block-sized gradient for every layer)."""
        if dim != 0 or self.spec[0] is not None:
            raise TypeError(f"unbind splits a whole first dim, not dim "
                            f"{dim} of spec {self.spec}")
        parts = {c: b.unbind(0) for c, b in self.blocks.items()}
        return [Sharded(self.mesh, self.spec[1:], self.shape[1:],
                        {c: p[i] for c, p in parts.items()}, self.partial)
                for i in range(self.shape[0])]

    def first(self) -> torch.Tensor:
        """The block of the mesh's first coordinate."""
        return self.blocks[mesh_coords(self.mesh)[0]]

    def index(self, c: Coord) -> Tuple[slice, ...]:
        """Where block ``c`` lies in the whole tensor."""
        n = shard_shape(self.spec, self.shape, self.mesh)
        at = _at(self.mesh, c)
        return tuple(slice(entry_pos(e, self.mesh, at) * k,
                           (entry_pos(e, self.mesh, at) + 1) * k)
                     for e, k in zip(self.spec, n))

    def whole(self) -> torch.Tensor:
        """The tensor assembled on the mesh's first device (a meta tensor on
        a meta mesh): each distinct block once, those the first coordinate
        does not hold counted in ``moved_bytes``."""
        from .mesh import arrive
        if self.partial:
            raise ValueError(f"partial sums over {self.partial}: reduce "
                             "them first")
        first = self.mesh.devices.flat[0]
        if _meta(self.mesh):
            return torch.empty(self.shape, dtype=self.dtype, device="meta")
        out = torch.empty(self.shape, dtype=self.dtype, device=first)
        coords = mesh_coords(self.mesh)
        key = (lambda c: tuple((s.start, s.stop) for s in self.index(c)))
        own, done = key(coords[0]), set()
        for c in coords:
            k = key(c)
            if k in done:
                continue
            done.add(k)
            b = self.blocks[c]
            out[self.index(c)] = b if k == own else arrive(b, first)
        return out


def _assemble(mesh: Mesh, spec: Spec, blocks: Dict[Coord, torch.Tensor],
              partial=()) -> Sharded:
    """A ``Sharded`` from its blocks: the global shape is a block's times the
    ways ``spec`` splits each dim."""
    b = next(iter(blocks.values()))
    spec = tuple(spec) + (None,) * (b.dim() - len(spec))
    return Sharded(mesh, spec, tuple(n * _split(e, mesh)
                                     for n, e in zip(b.shape, spec)),
                   blocks, partial)


def _placed(shape, spec: Spec, mesh: Mesh, make) -> Sharded:
    """One block a distinct (device, block) of each coordinate, from
    ``make(device, coords)``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    made, blocks = {}, {}
    for c in mesh_coords(mesh):
        at = _at(mesh, c)
        dev = mesh.devices[c]
        key = (dev, tuple(entry_pos(e, mesh, at) for e in spec))
        if key not in made:
            made[key] = make(dev, at)
        blocks[c] = made[key]
    return Sharded(mesh, spec, shape, blocks)


def shard(x: torch.Tensor, spec: Spec, mesh: Mesh) -> Sharded:
    """``x`` placed on ``mesh`` by ``spec``: each block a contiguous copy of
    its own on its device, or ``x`` itself where a block is all of ``x`` and
    ``x`` lies on that device already, so dropping ``x`` frees it beyond
    what the spec replicates. A placement is not a collective and counts
    nothing. On a meta mesh: one empty meta block."""
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    block = shard_shape(spec, x.shape, mesh)

    def make(dev, at):
        if dev.type == "meta":
            return torch.empty(block, dtype=x.dtype, device="meta")
        if tuple(x.shape) == block and x.device == dev:
            return x
        return shard_block(x, spec, mesh, at).to(
            dev, copy=True, memory_format=torch.contiguous_format)
    return _placed(x.shape, spec, mesh, make)


def sharded_zeros(shape, dtype, spec: Spec, mesh: Mesh) -> Sharded:
    """Zeros laid out by ``spec``, one block a distinct (device, block)."""
    block = shard_shape(spec, shape, mesh)
    return _placed(tuple(shape), spec, mesh,
                   lambda dev, at: torch.zeros(block, dtype=dtype,
                                               device=dev))


def smap(fn, *args, spec, partial=(), at: bool = False):
    """``fn`` block by block: at each coordinate of the first ``Sharded``
    argument's mesh it gets every ``Sharded`` argument's block there (the
    others as they are) and, with ``at``, the coordinate as ``at={axis:
    index}``. ``spec`` lays the result out (a list of specs where ``fn``
    returns a tuple), ``partial`` marks its blocks as partial sums."""
    mesh = next(a.mesh for a in args if isinstance(a, Sharded))
    outs = {}
    for c in mesh_coords(mesh):
        vals = [a.blocks[c] if isinstance(a, Sharded) else a for a in args]
        outs[c] = fn(*vals, **({"at": _at(mesh, c)} if at else {}))
    if isinstance(spec, list):
        return tuple(_assemble(mesh, sp, {c: o[i] for c, o in outs.items()},
                               partial) for i, sp in enumerate(spec))
    return _assemble(mesh, spec, outs, partial)


def _groups(mesh: Mesh, axes: Sequence[str]):
    """The coordinates that differ only on ``axes``, a group each, in block
    order along them; and the groups' size (a meta mesh's one group holds
    one coordinate standing for all)."""
    n = math.prod(mesh.shape[a] for a in axes)
    coords = mesh_coords(mesh)
    if _meta(mesh):
        return [coords], n
    idx = {mesh.axis_names.index(a) for a in axes}
    groups: Dict[Coord, List[Coord]] = {}
    for c in coords:
        groups.setdefault(tuple(v for i, v in enumerate(c) if i not in idx),
                          []).append(c)
    entry = _entry(axes)
    return [sorted(g, key=lambda c: entry_pos(entry, mesh, _at(mesh, c)))
            for g in groups.values()], n


def _run(x: Sharded, axes, coll) -> Dict[Coord, torch.Tensor]:
    """``coll(blocks by group, size)`` over ``axes``' groups, its results
    back at their coordinates."""
    groups, n = _groups(x.mesh, axes)
    outs = coll([[x.blocks[c] for c in g] for g in groups], n)
    return {c: o for g, og in zip(groups, outs) for c, o in zip(g, og)}


def gather(x: Sharded, dim: int) -> Sharded:
    """``x`` with ``dim`` whole: an all-gather over the axes its spec splits
    ``dim`` over; nothing where ``dim`` is whole or those axes hold one
    device."""
    from .mesh import all_gather
    dim %= x.ndim
    axes = spec_axes(x.spec[dim])
    if not axes:
        return x
    spec = x.spec[:dim] + (None,) + x.spec[dim + 1:]
    if math.prod(x.mesh.shape[a] for a in axes) == 1:
        return Sharded(x.mesh, spec, x.shape, x.blocks, x.partial)
    return Sharded(x.mesh, spec, x.shape,
                   _run(x, axes, lambda g, n: all_gather(g, dim, n)),
                   x.partial)


def reduce(x: Sharded, dim: Optional[int] = None,
           axes: Optional[Sequence[str]] = None) -> Sharded:
    """``x``'s partial sums added over ``axes`` (default: all of
    ``x.partial``; the rest stay partial): a reduce-scatter that splits
    ``dim`` over those axes, or with ``dim`` None an all-reduce."""
    from .mesh import all_reduce, reduce_scatter
    axes = x.partial if axes is None else tuple(axes)
    if set(axes) - set(x.partial):
        raise ValueError(f"reduce over {axes}: {x} is partial over "
                         f"{x.partial}")
    rest = tuple(a for a in x.partial if a not in axes)
    if not axes:
        return x
    spec = list(x.spec)
    if dim is not None:
        dim %= x.ndim
        if spec[dim] is not None:
            raise ValueError(f"reduce-scatter along dim {dim}, split as "
                             f"{spec[dim]!r} already")
        spec[dim] = _entry(axes)
    if math.prod(x.mesh.shape[a] for a in axes) == 1:
        return Sharded(x.mesh, spec, x.shape, x.blocks, rest)
    coll = ((lambda g, n: all_reduce(g, n)) if dim is None
            else (lambda g, n: reduce_scatter(g, dim, n)))
    return Sharded(x.mesh, spec, x.shape, _run(x, axes, coll), rest)


def split(x: Sharded, dim: int, entry) -> Sharded:
    """``x`` (whole along ``dim``, the same on every device of ``entry``'s
    axes) cut along ``dim`` by ``entry``: each coordinate keeps its piece,
    as a view. No communication."""
    dim %= x.ndim
    if x.spec[dim] is not None:
        raise ValueError(f"dim {dim} is split already ({x.spec[dim]!r})")
    n = _split(entry, x.mesh)
    if x.shape[dim] % n:
        raise ValueError(f"{entry!r} does not split dim {dim} of {x.shape}")
    blocks = {}
    for c, b in x.blocks.items():
        k = b.shape[dim] // n
        blocks[c] = b.narrow(dim, entry_pos(entry, x.mesh,
                                            _at(x.mesh, c)) * k, k)
    spec = x.spec[:dim] + (entry,) + x.spec[dim + 1:]
    return Sharded(x.mesh, spec, x.shape, blocks, x.partial)


def relayout(x: Sharded, spec: Spec) -> Sharded:
    """``x`` laid out by ``spec``. Partial sums are added first: a
    reduce-scatter along the dim ``spec`` splits over ``x.partial`` (where
    ``x`` holds that dim whole), else an all-reduce. Then each dim whose
    entry differs is gathered (where ``x`` splits it) and cut (where
    ``spec`` does), a cut waiting until no other dim is split over its
    axes (moving a split from one dim to another)."""
    spec = tuple(spec) + (None,) * (x.ndim - len(spec))
    if x.partial:
        dims = [d for d, e in enumerate(spec)
                if spec_axes(e) == x.partial and x.spec[d] is None]
        x = reduce(x, dims[0] if dims else None)
    pending = []
    for d in range(x.ndim):
        if x.spec[d] != spec[d]:
            x = gather(x, d)
            if spec[d] is not None:
                pending.append(d)
        # a cut waits while another dim is still split over its axes
        for p in list(pending):
            busy = {a for i, e in enumerate(x.spec) if i != p
                    for a in spec_axes(e)}
            if not busy & set(spec_axes(spec[p])):
                x = split(x, p, spec[p])
                pending.remove(p)
    return x


def add(a: Sharded, b: Sharded) -> Sharded:
    """``a + b`` block by block; both laid out alike."""
    if a.spec != b.spec or a.partial != b.partial:
        raise ValueError(f"add: {a} and {b} are laid out differently")
    return smap(torch.add, a, b, spec=a.spec, partial=a.partial)


def matmul(x: Sharded, w: Sharded, dtype) -> Sharded:
    """``x (..., K) @ w (K, N)`` block by block, ``w`` cast to ``dtype``.
    ``K`` is whole on both or split alike; split, the blocks are partial
    sums over its axes (a row-parallel product)."""
    if x.spec[-1] != w.spec[0] or x.partial:
        raise ValueError(f"matmul: {x} against {w}")
    return smap(lambda a, b: a @ b.to(dtype), x, w,
                spec=x.spec[:-1] + (w.spec[1],), partial=spec_axes(w.spec[0]))


def replicated_axes(x: Sharded) -> Tuple[str, ...]:
    """The mesh axes of more than one device that ``x``'s spec does not
    split: the coordinates along them hold the same blocks."""
    named = {a for e in x.spec for a in spec_axes(e)}
    return tuple(a for a in x.mesh.axis_names
                 if a not in named and x.mesh.shape[a] > 1)


def canonical(x: Sharded, c: Coord) -> bool:
    """Whether ``c`` is the first coordinate holding its block of ``x``
    (index 0 along every axis ``x`` is replicated over): summing the
    blocks of the canonical coordinates counts each block once."""
    at = _at(x.mesh, c)
    return all(at[a] == 0 for a in replicated_axes(x))


def grad_leaves(x: Sharded) -> Sharded:
    """``x`` with each coordinate's block an autograd leaf of its own (a
    ``detach`` sharing the block's storage, made to require grad), so a
    backward gives each coordinate its own gradient: the coordinates
    sharing a storage (a replicated axis, a device repeated in the mesh)
    are not summed by autograd, and ``leaf_grads`` adds them with one
    counted all-reduce on any mesh, cards or repeats alike."""
    return Sharded(x.mesh, x.spec, x.shape,
                   {c: b.detach().requires_grad_(True)
                    for c, b in x.blocks.items()}, x.partial)


def leaf_grads(loss: Sharded, leaves: Sequence[Sharded]) -> List[Sharded]:
    """The gradient of ``loss`` (a scalar every coordinate holds) in each
    of ``leaves`` (``grad_leaves``), by one backward seeded at the mesh's
    first coordinate: the collectives' backwards spread it, and a value
    every coordinate holds gets partial sums whose total is its gradient.
    Each gradient is laid out like its leaf, partial over the leaf's
    ``replicated_axes`` (``reduce`` adds them: one counted all-reduce, or
    a reduce-scatter to a finer layout). A block the loss does not reach
    gets zeros."""
    coords = mesh_coords(loss.mesh)
    flat = [b for x in leaves for b in (x.blocks[c] for c in coords)]
    got = torch.autograd.grad([loss.first()], flat, allow_unused=True)
    out, i = [], 0
    for x in leaves:
        blocks = {}
        for c in coords:
            g = got[i]
            blocks[c] = torch.zeros_like(flat[i]) if g is None else g
            i += 1
        out.append(Sharded(x.mesh, x.spec, x.shape, blocks,
                           replicated_axes(x)))
    return out


def index_owner(i: int, block: int) -> Tuple[int, int]:
    """The block holding index ``i`` of an axis cut into blocks of
    ``block``, and ``i``'s place in it."""
    return divmod(i, block)


def write_index(x: Sharded, dim: int, i: int, value: Sharded) -> None:
    """``x``'s index ``i`` along ``dim`` set, in place, to ``value``'s only
    one (``value`` whole along ``dim``), on the coordinates whose block
    holds ``i`` (``index_owner``)."""
    entry = x.spec[dim]
    for c, b in x.blocks.items():
        j = i
        if entry is not None:
            owner, j = index_owner(i, b.shape[dim])
            if entry_pos(entry, x.mesh, _at(x.mesh, c)) != owner:
                continue
        b.select(dim, j).copy_(value.blocks[c].select(dim, 0))


def write_prefix(x: Sharded, dim: int, value: Sharded) -> None:
    """``x``'s first ``value.shape[dim]`` indices along ``dim`` set, in
    place, to ``value`` (whole along ``dim``): each block takes the part
    that falls in it."""
    entry = x.spec[dim]
    for c, b in x.blocks.items():
        k = b.shape[dim]
        lo = (entry_pos(entry, x.mesh, _at(x.mesh, c)) * k
              if entry is not None else 0)
        hi = min(lo + k, value.shape[dim])
        if hi > lo:
            b.narrow(dim, 0, hi - lo).copy_(
                value.blocks[c].narrow(dim, lo, hi - lo))


# ---------------------------------------------------------------------------
# Distributed SpGEMM operand sharding (core/distributed.spgemm_coo_sharded)
# ---------------------------------------------------------------------------

def spgemm_operand_specs(axis: str, *, schedule: str = "ring",
                         batched: bool = False):
    """Specs of the (A, B) ELLPACK planes under a distributed schedule: B's
    slab axis is always split over ``axis`` (its panels rotate); A's is
    split under ``'ring'`` and ``'summa'`` (whose grid is index arithmetic
    over the same 1-D slab split) and whole on every device under
    ``'cstat'``. ``batched`` puts an unsplit batch axis first."""
    lead = (None,) if batched else ()
    spec_b = (*lead, None, axis)
    spec_a = (*lead, None, None) if schedule == "cstat" else (*lead, axis,
                                                              None)
    return spec_a, spec_b


@dataclasses.dataclass(frozen=True)
class ShardedEll:
    """An ELLPACK operand on a mesh axis: ``val[d]``/``idx[d]`` on its
    ``d``-th device, split along plane axis ``dim`` in device order
    (``None``: every device holds the whole planes). ``extent`` is the
    operand's ``n_rows`` (``rows``: an ``EllRows``) or ``n_cols``."""

    val: Tuple[torch.Tensor, ...]
    idx: Tuple[torch.Tensor, ...]
    dim: Optional[int]
    extent: int
    rows: bool

    @property
    def ndim(self) -> int:
        return self.val[0].dim()

    @property
    def k(self) -> int:
        """The whole operand's slab count, as ``EllRows.k``/``EllCols.k``."""
        ax = self.ndim - (2 if self.rows else 1)
        return (sum(v.shape[ax] for v in self.val) if self.dim == ax
                else self.val[0].shape[ax])

    @property
    def n_rows(self) -> int:
        return self.extent if self.rows else self.val[0].shape[-2]

    @property
    def n_cols(self) -> int:
        return self.val[0].shape[-1] if self.rows else self.extent

    def whole(self):
        """The operand as one ``EllRows``/``EllCols`` on the first device."""
        dev = self.val[0].device
        if self.dim is None:
            val, idx = self.val[0], self.idx[0]
        else:
            val = torch.cat([v.to(dev) for v in self.val], self.dim)
            idx = torch.cat([i.to(dev) for i in self.idx], self.dim)
        return (EllRows(val=val, idx=idx, n_rows=self.extent) if self.rows
                else EllCols(val=val, idx=idx, n_cols=self.extent))


def split_operand(x, devices, dim: Optional[int]) -> ShardedEll:
    """``x`` (``EllRows``/``EllCols``, its split axis already a multiple of
    ``len(devices)``) as a ``ShardedEll``: a contiguous copy of each piece
    on its device, or of the whole planes where ``dim`` is None. A
    ``ShardedEll`` already laid out so is returned as it is."""
    devices = list(devices)
    if isinstance(x, ShardedEll):
        if x.dim == dim and [v.device for v in x.val] == devices:
            return x
        x = x.whole()
    rows = isinstance(x, EllRows)
    extent = x.n_rows if rows else x.n_cols
    n = len(devices)

    def parts(t):
        if dim is None:
            return [t] * n
        return list(torch.chunk(t, n, dim))

    val = tuple(p.to(d, copy=True).contiguous()
                for p, d in zip(parts(x.val), devices))
    idx = tuple(p.to(d, copy=True).contiguous()
                for p, d in zip(parts(x.idx), devices))
    return ShardedEll(val=val, idx=idx, dim=dim, extent=extent, rows=rows)


def spec_dim(spec, axis: str) -> Optional[int]:
    """The plane axis a spec splits over ``axis`` (``None``: whole)."""
    return spec.index(axis) if axis in spec else None


def put_spgemm_operands(a, b, mesh: Mesh, axis: str, *,
                        schedule: str = "ring"):
    """Pad the operands' slab axes to the mesh axis's size and split them
    onto its devices as ``schedule`` wants them (``spgemm_operand_specs``),
    once: the sharded entry points take the pair as it is, and give the
    ``Coo`` they give for the whole operands. Returns ``(ShardedEll,
    ShardedEll)``."""
    from ..core.distributed import pad_slabs_a, pad_slabs_b
    devices = mesh.axis_devices(axis)
    n_dev = len(devices)
    a, b = pad_slabs_a(a, n_dev), pad_slabs_b(b, n_dev)
    spec_a, spec_b = spgemm_operand_specs(axis, schedule=schedule,
                                          batched=a.val.dim() == 3)
    return (split_operand(a, devices, spec_dim(spec_a, axis)),
            split_operand(b, devices, spec_dim(spec_b, axis)))
