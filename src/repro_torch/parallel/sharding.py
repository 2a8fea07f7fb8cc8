"""Operand sharding of the distributed SpGEMM, mirroring the SpGEMM half of
``src/repro/parallel/sharding.py`` (``spgemm_operand_specs``,
``put_spgemm_operands``); the logical-axis rules of the LM stack are not
ported.

A spec is a tuple with one entry a plane axis: the mesh axis name the
axis is split over, or ``None`` (JAX's ``PartitionSpec``). A
``ShardedEll`` is an ELLPACK operand placed on a mesh: one ``(val, idx)``
pair a device, split along one plane axis or held whole by every device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.formats import EllCols, EllRows
from .mesh import Mesh


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
