"""Fingerprint-keyed structure cache, mirroring ``src/repro/plan/cache.py``.

:class:`StructureCache` fronts ``plan.structure.make_structure`` with an
in-process LRU keyed by the operands' sparsity fingerprint (index planes,
shapes and value dtypes, values excluded), so repeated multiplies over one
pattern run the symbolic phase once and the numeric phase
(``core.spgemm.spgemm_coo_numeric``) after that.

With ``cache_dir=`` every built structure is also written as
``<fingerprint>.npz`` (the coordinate arrays plus a JSON metadata blob with
the plan), so a fresh process warm-starts without the symbolic phase. The
files are the reference's format version 1, and each package reads the
other's: on load the port drops the reference's advisory plan keys (``est``,
``stats``) and its distributed plans, which the port does not have yet; the
reference reads a port-written plan because its ``Plan`` defaults them.
Writes are atomic (temporary file + rename); a corrupt, foreign-version or
mismatched file is a miss, never an error.

Thread-safe: lookups and LRU updates hold a lock; the build runs outside it
(concurrent first calls on one pattern may both build, and the last insert
wins). The reference's measured autotune (``autotune=True``) needs backend
selection and raises here until that is ported.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import zipfile
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from ..core.formats import EllCols, EllRows
from .planner import Plan
from .structure import SpgemmStructure, fingerprint, make_structure

_FORMAT_VERSION = 1
_REFERENCE_ONLY = ("est", "stats")     # advisory fields of the reference Plan


class StructureCache:
    """LRU cache of :class:`~repro_torch.plan.structure.SpgemmStructure`
    entries keyed by sparsity fingerprint (see the module docstring).

    ``capacity`` bounds the in-memory entries (least recently used evicted
    first; disk copies survive eviction). ``cache_dir`` enables the disk
    layer. ``autotune=True`` raises ``NotImplementedError``.
    """

    def __init__(self, capacity: int = 64, cache_dir: Optional[str] = None,
                 autotune: bool = False):
        if autotune:
            raise NotImplementedError(
                "StructureCache(autotune=True) probes every backend and "
                "needs backend selection, which is not ported to repro_torch "
                "yet: ROADMAP queue 1 item 3 (planner: backend selection)")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.cache_dir = cache_dir
        self._lock = threading.RLock()
        self._entries: "OrderedDict[str, SpgemmStructure]" = OrderedDict()
        self._stats: Dict[str, int] = dict(hits=0, misses=0, evictions=0,
                                           disk_hits=0)
        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)

    def get(self, a: EllRows, b: EllCols, **make_kwargs) -> SpgemmStructure:
        """The structure for ``(a, b)``'s sparsity pattern: from memory, then
        disk (loaded onto the operands' device), then a fresh
        ``make_structure(a, b, **make_kwargs)``. The kwargs do not enter the
        key, so callers sharing a cache should agree on them."""
        fp = fingerprint(a, b)
        with self._lock:
            st = self._entries.get(fp)
            if st is not None:
                self._entries.move_to_end(fp)
                self._stats["hits"] += 1
                return st
        if self.cache_dir is not None:
            st = self._load_disk(fp, a.idx.device)
            if st is not None:
                with self._lock:
                    self._stats["disk_hits"] += 1
                self._insert(fp, st, write_disk=False)
                return st
        with self._lock:
            self._stats["misses"] += 1
        st = make_structure(a, b, **make_kwargs)
        self._insert(fp, st, write_disk=True)
        return st

    def stats(self) -> Dict[str, int]:
        """Counters: hits, misses, evictions, disk_hits, and the current
        ``size``."""
        with self._lock:
            out = dict(self._stats)
            out["size"] = len(self._entries)
        return out

    def clear(self) -> None:
        """Drop every in-memory entry (disk copies are kept) and zero the
        counters."""
        with self._lock:
            self._entries.clear()
            for k in self._stats:
                self._stats[k] = 0

    def _insert(self, fp: str, st: SpgemmStructure, *,
                write_disk: bool) -> None:
        with self._lock:
            self._entries[fp] = st
            self._entries.move_to_end(fp)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self._stats["evictions"] += 1
        if write_disk and self.cache_dir is not None:
            self._save_disk(fp, st)

    def _path(self, fp: str) -> str:
        return os.path.join(self.cache_dir, f"{fp}.npz")

    def _save_disk(self, fp: str, st: SpgemmStructure) -> None:
        meta = dict(version=_FORMAT_VERSION, n_rows=st.n_rows,
                    n_cols=st.n_cols, out_cap=st.out_cap, fp=st.fp,
                    plan=dataclasses.asdict(st.plan), dist_plans=[])
        path = self._path(fp)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, key=st.key.cpu().numpy(),
                         row_nnz=st.row_nnz.cpu().numpy(),
                         seg=st.seg.cpu().numpy(), nnz=st.nnz.cpu().numpy(),
                         meta=np.frombuffer(json.dumps(meta).encode(),
                                            dtype=np.uint8))
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _load_disk(self, fp: str, device) -> Optional[SpgemmStructure]:
        path = self._path(fp)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path) as z:
                meta = json.loads(bytes(z["meta"]).decode())
                if meta.get("version") != _FORMAT_VERSION \
                        or meta.get("fp") != fp:
                    return None

                def arr(name):
                    return torch.from_numpy(np.array(z[name])).to(device)

                return SpgemmStructure(
                    key=arr("key"), row_nnz=arr("row_nnz"), seg=arr("seg"),
                    nnz=arr("nnz"), n_rows=meta["n_rows"],
                    n_cols=meta["n_cols"], out_cap=meta["out_cap"],
                    fp=meta["fp"],
                    plan=Plan(**{k: v for k, v in meta["plan"].items()
                                 if k not in _REFERENCE_ONLY}))
        except (OSError, EOFError, ValueError, KeyError, TypeError,
                zipfile.BadZipFile):
            return None     # corrupt, partial or foreign file: a plain miss
