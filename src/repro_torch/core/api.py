"""The SpGEMM front door: ``spgemm(a, b, ...)``, mirroring
``src/repro/core/api.py`` for the cold single-device routes.

It dispatches on what it is handed: 3-D ELLPACK planes (a leading batch
axis) go to ``spgemm_coo_batched``, 2-D ones to ``spgemm_coo``. ``out_cap``
(``"auto"`` sizes it symbolically), ``accumulator`` (``'sort'``,
``'tiled'``, ``'bucket'``, ``'hash'`` or ``'search'``), ``tile`` (the
``'tiled'`` merge tree's tile), ``plan`` (``plan.make_plan``, of either
package) and ``check`` mean what they mean there. ``accumulator='auto'``
without a plan, ``'stream'``, the warm numeric phase (``structure=``), the
sharded paths (``mesh=``/``axis=``) and the explicit stream sizes
(``stream_cap=``/``group=``) raise ``NotImplementedError`` until their
slices are ported.
"""
from __future__ import annotations

from typing import Optional

from .formats import Coo, EllCols, EllRows


def spgemm(a: EllRows, b: EllCols, *, structure=None, mesh=None,
           axis: Optional[str] = None, batched="auto", out_cap="auto",
           accumulator: Optional[str] = None, tile: Optional[int] = None,
           plan=None,
           stream_cap: Optional[int] = None, group: Optional[int] = None,
           check: bool = False) -> Coo:
    """C = A·B as sorted COO — dispatches to the right SpGEMM variant."""
    from .spgemm import _not_ported, spgemm_coo, spgemm_coo_batched
    if structure is not None:
        _not_ported("structure=", "structure")
    if mesh is not None or axis is not None:
        _not_ported("mesh=/axis=", "mesh")
    if stream_cap is not None or group is not None:
        _not_ported("stream_cap=/group=", "stream_cap")
    if batched == "auto":
        is_batched = a.val.ndim == 3
    else:
        is_batched = bool(batched)
        if is_batched and a.val.ndim != 3:
            raise ValueError("batched=True needs 3-D ELLPACK planes "
                             f"(got a.val.ndim={a.val.ndim})")
    fn = spgemm_coo_batched if is_batched else spgemm_coo
    return fn(a, b, out_cap, accumulator=accumulator, tile=tile, check=check,
              plan=plan)
