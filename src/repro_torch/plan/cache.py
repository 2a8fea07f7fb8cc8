"""Fingerprint-keyed structure cache, mirroring ``src/repro/plan/cache.py``.

:class:`StructureCache` fronts ``plan.structure.make_structure`` with an
in-process LRU keyed by the operands' sparsity fingerprint (index planes,
shapes and value dtypes, values excluded), so repeated multiplies over one
pattern run the symbolic phase once and the numeric phase
(``core.spgemm.spgemm_coo_numeric``) after that.

Optional layers on top of the LRU:

  * **Disk persistence** (``cache_dir=``): every built structure is also
    written as ``<fingerprint>.npz`` (the coordinate arrays plus a JSON
    metadata blob with the plan), so a fresh process warm-starts without the
    symbolic phase. The files are the reference's format version 1, and each
    package reads the other's: a plan, and each distributed plan with its
    base plan, is saved without its ``stats`` and with ``est`` only where it
    is JSON, as the reference saves it. Writes are atomic (temporary file + rename); a corrupt,
    foreign-version or mismatched file is a miss, never an error.
  * **Measured autotune** (``autotune=True``): on a miss each candidate
    backend is planned and timed on the real operands (``probe_iters``
    calls, the device synchronized around them), and the measured winner's
    plan is cached with every candidate's µs in ``est['autotune_us']``. A
    candidate whose planning raises ``ValueError`` (an inapplicable backend,
    such as a packed-key one on an oversized space) is dropped; any other
    failure, a kernel's build or launch among them, propagates.
  * **Stats** (:meth:`StructureCache.stats`): hit / miss / eviction /
    disk-hit / autotune counters, also forwarded to ``repro_torch.obs``
    (``structure_cache.*``).

Thread-safe: lookups and LRU updates hold a lock; the build runs outside it
(concurrent first calls on one pattern may both build, and the last insert
wins).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import zipfile
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.formats import EllCols, EllRows
from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs
from .planner import BACKENDS, DistPlan, Plan
from .structure import SpgemmStructure, fingerprint, make_structure

_FORMAT_VERSION = 1
_NOT_SAVED = ("stats",)   # MatrixStats is derivable, not worth serializing


def _plan_to_dict(plan: Plan) -> dict:
    """A plan's fields for the JSON metadata, as the reference writes them:
    without ``stats``, and ``est`` emptied unless it is JSON."""
    d = {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)
         if f.name not in _NOT_SAVED}
    try:
        json.dumps(d["est"])
    except (TypeError, ValueError):
        d["est"] = {}
    return d


def _dist_plan_to_dict(dp) -> dict:
    """A distributed plan's fields for the JSON metadata, its base plan as
    ``_plan_to_dict`` writes one."""
    d = {f.name: getattr(dp, f.name) for f in dataclasses.fields(dp)}
    d["base"] = _plan_to_dict(dp.base)
    try:
        json.dumps(d["est"])
    except (TypeError, ValueError):
        d["est"] = {}
    return d


def _plan_from_dict(d: dict) -> Plan:
    return Plan(**{k: v for k, v in d.items() if k not in _NOT_SAVED})


def _dist_plan_from_dict(d: dict) -> DistPlan:
    return DistPlan(**{**d, "base": _plan_from_dict(d["base"])})


def _device_sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StructureCache:
    """LRU cache of :class:`~repro_torch.plan.structure.SpgemmStructure`
    entries keyed by sparsity fingerprint (see the module docstring).

    ``capacity`` bounds the in-memory entries (least recently used evicted
    first; disk copies survive eviction). ``cache_dir`` enables the disk
    layer. ``autotune=True`` replaces the cost model's backend choice with a
    measured winner on a miss; ``autotune_backends`` restricts the probed
    candidates and ``probe_iters`` sets the timed calls per candidate.
    """

    def __init__(self, capacity: int = 64, cache_dir: Optional[str] = None,
                 autotune: bool = False,
                 autotune_backends: Optional[Tuple[str, ...]] = None,
                 probe_iters: int = 3):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.cache_dir = cache_dir
        self.autotune = autotune
        self.autotune_backends = tuple(autotune_backends or BACKENDS)
        self.probe_iters = probe_iters
        self._lock = threading.RLock()
        self._entries: "OrderedDict[str, SpgemmStructure]" = OrderedDict()
        self._stats: Dict[str, int] = dict(hits=0, misses=0, evictions=0,
                                           disk_hits=0, autotuned=0)
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
        if st is not None:
            _obs_metrics.inc("structure_cache.hits")
            return st
        if self.cache_dir is not None:
            st = self._load_disk(fp, a.idx.device)
            if st is not None:
                with self._lock:
                    self._stats["disk_hits"] += 1
                _obs_metrics.inc("structure_cache.disk_hits")
                self._insert(fp, st, write_disk=False)
                return st
        with self._lock:
            self._stats["misses"] += 1
        _obs_metrics.inc("structure_cache.misses")
        if self.autotune:
            make_kwargs = dict(make_kwargs)
            make_kwargs["plan"] = self._autotune_plan(a, b, make_kwargs)
        with _obs.span("structure_cache.build", fp=fp[:12]):
            st = make_structure(a, b, **make_kwargs)
        self._insert(fp, st, write_disk=True)
        return st

    def stats(self) -> Dict[str, int]:
        """Counters: hits, misses, evictions, disk_hits, autotuned, and the
        current ``size``."""
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
            evicted = 0
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self._stats["evictions"] += 1
                evicted += 1
        if evicted:
            _obs_metrics.inc("structure_cache.evictions", evicted)
        if write_disk and self.cache_dir is not None:
            self._save_disk(fp, st)

    def _autotune_plan(self, a: EllRows, b: EllCols,
                       make_kwargs: dict) -> Plan:
        """Timed probes of each candidate backend on the real operands: one
        warm call, then ``probe_iters`` calls between two device
        synchronizations (the host clock on the CPU). Returns the measured
        winner's plan with every candidate's µs in ``est['autotune_us']``."""
        from ..core.spgemm import spgemm_coo
        from .planner import make_plan
        kw = dict(out_cap=make_kwargs.get("out_cap"),
                  tile=make_kwargs.get("tile") or 4096,
                  slack=make_kwargs.get("slack", 1.0))
        dev = a.idx.device
        times: Dict[str, float] = {}
        plans: Dict[str, Plan] = {}
        for bk in self.autotune_backends:
            try:
                p = make_plan(a, b, backend=bk, **kw)
            except ValueError:      # inapplicable here: not a candidate
                continue
            spgemm_coo(a, b, plan=p)                  # build and warm
            _device_sync(dev)
            t0 = time.perf_counter()
            for _ in range(self.probe_iters):
                spgemm_coo(a, b, plan=p)
            _device_sync(dev)
            times[bk] = (time.perf_counter() - t0) / self.probe_iters
            plans[bk] = p
        if not times:
            return make_plan(a, b, **kw)
        winner = min(times, key=times.get)
        with self._lock:
            self._stats["autotuned"] += 1
        _obs_metrics.inc("structure_cache.autotuned")
        est = dict(plans[winner].est)
        est["autotune_us"] = {k: v * 1e6 for k, v in times.items()}
        return dataclasses.replace(plans[winner], est=est)

    def _path(self, fp: str) -> str:
        return os.path.join(self.cache_dir, f"{fp}.npz")

    def _save_disk(self, fp: str, st: SpgemmStructure) -> None:
        meta = dict(version=_FORMAT_VERSION, n_rows=st.n_rows,
                    n_cols=st.n_cols, out_cap=st.out_cap, fp=st.fp,
                    plan=_plan_to_dict(st.plan),
                    dist_plans=[[s, _dist_plan_to_dict(dp)]
                                for s, dp in st.dist_plans])
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
                    fp=meta["fp"], plan=_plan_from_dict(meta["plan"]),
                    dist_plans=tuple(
                        (s, _dist_plan_from_dict(d))
                        for s, d in meta.get("dist_plans", [])))
        except (OSError, EOFError, ValueError, KeyError, TypeError,
                zipfile.BadZipFile):
            return None     # corrupt, partial or foreign file: a plain miss
