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
them. The port runs one eager program, with no partitioner: the resolved
specs give each argument's per-device layout and bytes (``shard_shape``;
the dry run, ``launch/dryrun.py``), and ``maybe_shard`` only checks its
spec, as the reference's ``with_sharding_constraint`` would, and returns
its input. Values change under a mesh only where the reference's do: the
MoE layer groups its tokens by data shard (``axis_size("batch")``) and
runs its ``'sort'`` region shard by shard (``shard_block`` slices its
inputs as ``shard_map`` would; ``models/ffn.py``). ``logical_to_pspec``
and ``maybe_shard`` keep the reference's API: no code of the port calls
them.

A ``ShardedEll`` is an ELLPACK operand placed on a mesh: one ``(val,
idx)`` pair a device, split along one plane axis or held whole by every
device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

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


def shard_block(x: torch.Tensor, spec: Spec, mesh: Mesh,
                coords: Dict[str, int]) -> torch.Tensor:
    """The block of ``x`` laid out by ``spec`` that the device at ``coords``
    (``{axis: index}``, 0 on the axes it does not name) holds, as a view of
    ``x``: ``shard_map``'s in-spec slicing."""
    block = shard_shape(spec, x.shape, mesh)
    for i, entry in enumerate(spec):
        pos = 0
        for ax in spec_axes(entry):
            pos = pos * mesh.shape[ax] + coords.get(ax, 0)
        if entry is not None:
            x = x.narrow(i, pos * block[i], block[i])
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
