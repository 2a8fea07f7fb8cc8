"""The SpGEMM front door: ``spgemm(a, b, ...)``, mirroring
``src/repro/core/api.py``.

It dispatches on what it is handed (first match wins):

* ``mesh``/``axis`` set → the sharded paths (``core.distributed``) on a
  ``parallel.Mesh``: with ``structure`` on unbatched operands the sharded
  numeric phase (``spgemm_coo_sharded_numeric``); batched operands with a
  ``dist_plan`` and no structure ``spgemm_coo_sharded_batched``; otherwise
  the cold ``spgemm_coo_sharded`` (``schedule``/``dist_plan``/``overlap``
  choose and run the schedule).
* ``structure`` set → the warm numeric phase (``spgemm_coo_numeric``, or
  ``spgemm_coo_numeric_batched`` for 3-D planes); stream-planned structures
  go by slab groups by themselves. ``validate=False`` skips the structure's
  fingerprint check.
* ``accumulator='stream'`` with an explicit ``stream_cap`` or ``group`` →
  ``spgemm_coo_stream`` (2-D planes only).
* otherwise 3-D ELLPACK planes (a leading batch axis) go to
  ``spgemm_coo_batched``, 2-D ones to ``spgemm_coo``.

``out_cap`` (``"auto"`` sizes it symbolically), ``accumulator`` (``'sort'``,
``'tiled'``, ``'bucket'``, ``'hash'``, ``'stream'``, ``'search'``, or
``'auto'``: the planner chooses), ``tile`` (the ``'tiled'`` merge tree's
tile), ``plan`` (``plan.make_plan``, of either package) and ``check`` mean
what they mean there. ``schedule``, ``dist_plan`` and ``overlap`` steer only
the sharded paths; without a mesh they are ignored, whatever their values,
as the reference ignores them. One of ``mesh=``/``axis=`` without the other
raises ``ValueError``, as in the reference; a ``mesh=`` that is not a
``parallel.Mesh`` raises ``TypeError``.
"""
from __future__ import annotations

from typing import Optional

from .formats import Coo, EllCols, EllRows


def spgemm(a: EllRows, b: EllCols, *, structure=None, mesh=None,
           axis: Optional[str] = None, batched="auto", out_cap="auto",
           accumulator: Optional[str] = None, schedule: str = "auto",
           tile: Optional[int] = None, plan=None, dist_plan=None,
           overlap: bool = True, stream_cap: Optional[int] = None,
           group: Optional[int] = None, check: bool = False,
           validate: bool = True) -> Coo:
    """C = A·B as sorted COO — dispatches to the right SpGEMM variant."""
    from . import spgemm as sp
    if axis is not None and mesh is None:
        raise ValueError("axis= requires mesh= (a device mesh)")
    if mesh is not None and axis is None:
        raise ValueError("mesh= requires axis= (the mesh axis name)")
    from . import distributed as dist
    ndim = dist._ndim(a)
    if batched == "auto":
        is_batched = ndim == 3
    else:
        is_batched = bool(batched)
        if is_batched and ndim != 3:
            raise ValueError("batched=True needs 3-D ELLPACK planes "
                             f"(got a.val.ndim={ndim})")
    if mesh is not None:
        if structure is not None and not is_batched:
            return dist.spgemm_coo_sharded_numeric(
                a, b, mesh, axis, structure, schedule=schedule,
                overlap=overlap, check=check, validate=validate)
        if is_batched and structure is None and dist_plan is not None:
            return dist.spgemm_coo_sharded_batched(
                a, b, mesh, axis, dist_plan=dist_plan, schedule=schedule,
                overlap=overlap, check=check)
        return dist.spgemm_coo_sharded(
            a, b, mesh, axis, out_cap, accumulator=accumulator or "auto",
            schedule=schedule, dist_plan=dist_plan, structure=structure,
            overlap=overlap, check=check)
    del schedule, dist_plan, overlap          # read by the sharded paths only
    if structure is not None:
        fn = sp.spgemm_coo_numeric_batched if is_batched \
            else sp.spgemm_coo_numeric
        return fn(a, b, structure, check=check, validate=validate)
    if accumulator == "stream" and (stream_cap is not None
                                    or group is not None):
        if is_batched:
            raise ValueError("batched stream SpGEMM: pass a plan= built "
                             "with backend='stream' instead of explicit "
                             "stream_cap/group")
        from .streaming import spgemm_coo_stream
        coo = spgemm_coo_stream(a, b, out_cap, stream_cap=stream_cap,
                                group=group)
        return sp.check_no_overflow(coo) if check else coo
    fn = sp.spgemm_coo_batched if is_batched else sp.spgemm_coo
    return fn(a, b, out_cap, accumulator=accumulator, tile=tile, check=check,
              plan=plan)
