"""The symbolic phase as a value: the output structure of C = A·B, and the
operands' sparsity fingerprint, mirroring ``src/repro/plan/structure.py``.

Two-phase SpGEMM splits the multiply into a symbolic pass (which output
coordinates exist) and a numeric pass (their values). Workloads that multiply
one sparsity pattern many times keep the symbolic result: ``make_structure``
computes it once as a frozen :class:`SpgemmStructure`, and
``core.spgemm.spgemm_coo_numeric`` runs only the multiply and one slot sum on
every later call.

``fingerprint`` hashes the ELLPACK *index* planes, the logical shapes and the
value dtypes (values excluded): two operand pairs share a fingerprint iff
they have the same sparsity pattern in the same slots and the same value
dtypes, the condition under which a ``Plan`` or a structure built for one
fits the other. It hashes the same numpy int32 bytes, shape reprs and
``dtype.str``s as the reference, so a fingerprint, the ``Plan.fp`` it stamps
and the ``plan.cache`` file names are equal across the two packages.

A structure holds:

  * ``key``     — C's sorted unique packed coordinates ``row·n_cols + col``,
                  KEY_INVALID past ``nnz`` up to ``out_cap``;
  * ``row_nnz`` — per-row unique counts; ``seg`` their exclusive prefix sum
                  (the CSR ``indptr`` of C);
  * ``nnz``     — the true unique count (the numeric phase's ``ngroups``);
  * ``plan``    — the single-device ``Plan`` (``planner.make_plan``);
  * ``dist_plans`` — ``(schedule, DistPlan)`` pairs, built with ``n_dev=``
                  (``planner.make_dist_plan``), which sharded calls on the
                  pattern reuse instead of planning again.

Packed int32 keys need ``n_rows·n_cols < 2³¹−1``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.formats import EllCols, EllRows
from ..kernels.insitu_search import KEY_INVALID
from ..obs import trace as _obs
from . import symbolic


def _dtype_str(dtype: torch.dtype) -> str:
    return torch.empty(0, dtype=dtype).numpy().dtype.str


def fingerprint(a: EllRows, b: EllCols) -> str:
    """Sparsity fingerprint of an operand pair (sha1 hex digest)."""
    return _digest(_index_planes(a, b), a, b)


def _index_planes(a: EllRows, b: EllCols):
    """What ``fingerprint`` hashes of the operands' values on the device:
    each index plane copied to the host, with its logical extent."""
    return [(np.ascontiguousarray(idx.cpu().numpy()), int(logical))
            for idx, logical in ((a.idx, a.n_rows), (b.idx, b.n_cols))]


def _digest(planes, a: EllRows, b: EllCols) -> str:
    """The fingerprint of ``_index_planes(a, b)`` (host work only)."""
    h = hashlib.sha1()
    for arr, logical in planes:
        h.update(repr((arr.shape, logical, arr.dtype.str)).encode())
        h.update(arr)
    h.update(repr((_dtype_str(a.val.dtype), _dtype_str(b.val.dtype))).encode())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class SpgemmStructure:
    """Frozen symbolic-phase result of C = A·B (see the module docstring).
    A batched structure (``make_structure_batched``) carries a leading batch
    axis on ``key``, ``row_nnz``, ``seg`` and ``nnz``."""

    key: torch.Tensor       # (out_cap,) int32 sorted unique packed coords
    row_nnz: torch.Tensor   # (n_rows,) int32 per-row unique counts
    seg: torch.Tensor       # (n_rows + 1,) int32 row segment boundaries
    nnz: torch.Tensor       # () int32 true unique count (→ Coo.ngroups)
    n_rows: int
    n_cols: int
    out_cap: int
    fp: Optional[str]
    plan: object            # planner.Plan
    dist_plans: Tuple = ()

    @property
    def batched(self) -> bool:
        return self.key.dim() == 2

    def dist_plan(self, schedule: Optional[str] = None):
        """The cached ``DistPlan`` for ``schedule`` (``None``: the first
        one, the planner's pick where it chose). Raises ``ValueError``,
        with how to rebuild, where the structure holds none for it."""
        if not self.dist_plans:
            raise ValueError(
                "structure holds no distributed plans — rebuild with "
                "make_structure(..., n_dev=mesh.shape[axis]) (optionally "
                "schedules=('ring', 'cstat', 'summa')) to cache them")
        plans = dict(self.dist_plans)
        if schedule is None:
            return plans[self.dist_plans[0][0]]
        if schedule not in plans:
            raise ValueError(
                f"structure caches no {schedule!r} DistPlan (has "
                f"{tuple(plans)}); rebuild with make_structure(..., "
                f"schedules=({schedule!r},))")
        return plans[schedule]

    def validate(self, a: EllRows, b: EllCols) -> None:
        """Raise ``ValueError`` when ``(a, b)``'s output shape or sparsity
        fingerprint is not the one this structure was built for (a stale
        structure would put values at the wrong coordinates)."""
        if a.n_rows != self.n_rows or b.n_cols != self.n_cols:
            raise ValueError(
                f"structure built for a {self.n_rows}x{self.n_cols} output "
                f"but operands produce {a.n_rows}x{b.n_cols}")
        if self.fp is not None:
            got = fingerprint(a, b)
            if got != self.fp:
                raise ValueError(
                    "stale structure: operands' sparsity fingerprint "
                    f"{got[:12]}… differs from the structure's "
                    f"{self.fp[:12]}… — the sparsity pattern changed, so "
                    "the cached output coordinates no longer apply. Rebuild "
                    "with make_structure (or fetch through "
                    "plan.cache.StructureCache, which keys on the "
                    "fingerprint)")


def _check_packable(n_rows: int, n_cols: int) -> None:
    if n_rows * n_cols >= KEY_INVALID:
        raise ValueError(
            f"coordinate space {n_rows}x{n_cols} exceeds packed int32 keys; "
            "the structure/numeric path cannot span it — use the cold "
            "spgemm_coo path (its unpacked two-key 'sort' route handles "
            "such spaces automatically)")


def _structure_arrays(a_idx: torch.Tensor, b_idx: torch.Tensor, *,
                      n_rows: int, n_cols: int, out_cap: int):
    """Coordinate-only symbolic pass → ``(key, row_nnz, seg, nnz)``: the
    sort ``symbolic.exact_nnz_rows`` runs, its run heads kept as packed keys
    and compacted into ``out_cap`` slots by a cumsum scatter."""
    key, head, row = symbolic.sorted_coords(a_idx, b_idx, n_rows)
    row_nnz = symbolic.row_counts(head, row, n_rows)
    col = (key & 0xFFFFFFFF) - 2 ** 31
    packed = torch.where(head, row * n_cols + col, KEY_INVALID).to(torch.int32)
    dst = torch.where(head, torch.cumsum(head, 0) - 1, out_cap)
    uniq = torch.full((out_cap + 1,), KEY_INVALID, dtype=torch.int32,
                      device=key.device)
    uniq.scatter_(0, dst.clamp(max=out_cap), packed)
    seg = torch.cat([row_nnz.new_zeros(1),
                     torch.cumsum(row_nnz, 0, dtype=torch.int32)])
    return uniq[:out_cap], row_nnz, seg, head.sum(dtype=torch.int32)


def make_structure(a: EllRows, b: EllCols, *, out_cap: Optional[int] = None,
                   backend: Optional[str] = None, tile: int = 4096,
                   slack: float = 1.0, n_dev: Optional[int] = None,
                   schedules: Optional[Tuple[str, ...]] = None,
                   plan=None) -> SpgemmStructure:
    """Run the symbolic phase once on concrete operands → ``SpgemmStructure``.

    ``plan=`` supplies a prebuilt ``Plan`` (of either package, e.g. an
    autotuned winner); otherwise ``make_plan`` runs with
    ``out_cap``/``backend``/``tile``/``slack`` (``backend=None`` lets it
    choose). The plan's backend decides the numeric realization: ``'stream'``
    goes by slab groups, every other one multiplies the whole stream. The
    result fits any operand pair with the same sparsity pattern, whatever
    the values. With ``n_dev`` a ``DistPlan`` is built for each of
    ``schedules`` (default: the planner's pick alone) and kept in
    ``dist_plans``, so sharded calls on the pattern skip
    ``make_dist_plan``.
    """
    _check_packable(a.n_rows, b.n_cols)
    fp = fingerprint(a, b)
    if plan is None:
        from .planner import make_plan
        plan = make_plan(a, b, out_cap=out_cap, backend=backend, tile=tile,
                         slack=slack)
    out_cap = plan.out_cap
    with _obs.span("structure.build", fp=fp[:12], out_cap=out_cap,
                   backend=plan.backend):
        key, row_nnz, seg, nnz = _obs.sync(_structure_arrays(
            a.idx, b.idx, n_rows=a.n_rows, n_cols=b.n_cols, out_cap=out_cap))
    if int(nnz) > out_cap:
        raise ValueError(
            f"out_cap={out_cap} smaller than nnz(C)={int(nnz)} — a structure "
            "must hold every output coordinate (pass a larger out_cap or let "
            "make_plan size it)")
    dist_plans = ()
    if n_dev is not None:
        from .planner import SCHEDULES, make_dist_plan
        for s in schedules or ():
            if s not in SCHEDULES:
                raise ValueError(
                    f"unknown schedule {s!r}; expected {SCHEDULES}")
        kw = dict(n_dev=n_dev, out_cap=out_cap, backend=plan.backend,
                  tile=tile, slack=slack)
        if schedules is None:
            dp = make_dist_plan(a, b, **kw)
            dist_plans = ((dp.schedule, dp),)
        else:
            dist_plans = tuple((s, make_dist_plan(a, b, schedule=s, **kw))
                               for s in schedules)
    return SpgemmStructure(key=key, row_nnz=row_nnz, seg=seg, nnz=nnz,
                           n_rows=a.n_rows, n_cols=b.n_cols, out_cap=out_cap,
                           fp=fp, plan=plan, dist_plans=dist_plans)


def make_structure_batched(a: EllRows, b: EllCols, *,
                           out_cap: Optional[int] = None,
                           backend: Optional[str] = None, tile: int = 4096,
                           slack: float = 1.0) -> SpgemmStructure:
    """The symbolic phase per element of a leading batch axis. Every element
    gets its own key plane (patterns may differ across the batch); ``out_cap``
    and the plan are shared, sized on the widest element. Consume with
    ``spgemm_coo_numeric_batched``."""
    if a.val.dim() != 3 or b.val.dim() != 3:
        raise ValueError("batched operands need a leading batch axis on all "
                         f"ELLPACK planes; got A {a.val.dim()}D, "
                         f"B {b.val.dim()}D")
    _check_packable(a.n_rows, b.n_cols)
    slices = [(EllRows(a.val[i], a.idx[i], a.n_rows),
               EllCols(b.val[i], b.idx[i], b.n_cols))
              for i in range(a.val.shape[0])]
    fp = fingerprint(a, b)
    if out_cap is None:
        out_cap = max(symbolic.out_cap_auto(ai, bi, slack=slack)
                      for ai, bi in slices)
    from .planner import make_plan
    plan = make_plan(*slices[0], out_cap=out_cap, backend=backend, tile=tile,
                     slack=slack)
    parts = [_structure_arrays(ai.idx, bi.idx, n_rows=a.n_rows,
                               n_cols=b.n_cols, out_cap=out_cap)
             for ai, bi in slices]
    key, row_nnz, seg, nnz = (torch.stack([p[i] for p in parts])
                              for i in range(4))
    if int(nnz.max()) > out_cap:
        raise ValueError(
            f"out_cap={out_cap} smaller than the widest batch element's "
            f"nnz(C)={int(nnz.max())}")
    return SpgemmStructure(key=key, row_nnz=row_nnz, seg=seg, nnz=nnz,
                           n_rows=a.n_rows, n_cols=b.n_cols, out_cap=out_cap,
                           fp=fp, plan=plan)
