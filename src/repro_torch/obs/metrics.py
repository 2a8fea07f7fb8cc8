"""Gated counters / gauges / histograms for the SpGEMM stack, mirroring
``src/repro/obs/metrics.py`` (no framework code in either).

Shares the enable switch with :mod:`repro_torch.obs.trace`: while tracing is
disabled every recording call is a cheap early-return and the registry
stays empty. Enabled, the library forwards:

- **planner decisions** — ``record_plan`` stores the chosen backend and the
  modeled ``cost_<backend>`` estimates per plan fingerprint; each
  instrumented accumulate records its measured µs via
  ``record_backend_us``. ``snapshot()`` joins the two into a per-plan
  *mispredict ratio*: measured µs of the chosen backend over the best
  measured backend (1.0 = the planner picked the measured winner).
- **StructureCache** hits/misses/evictions/disk_hits/autotunes
  (forwarded from ``plan/cache.py``).
- **overflow / ngroups-poison events** (``check_no_overflow`` increments
  exactly once per offending call).
- the distributed schedules' modeled bytes and the serving engine's
  latencies, once those slices are ported.

Histograms are streaming (count/total/min/max) — no samples retained.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from . import trace as _trace


class Metrics:
    """Thread-safe metric registry; all recording is gated on the tracer's
    enable switch so a disabled stack does no bookkeeping at all."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Dict[str, float]] = {}
        # plan fingerprint -> {"backend": str, "est": {...}, "measured_us": {}}
        self._planner: Dict[str, Dict[str, Any]] = {}

    # ----------------------------------------------------------- recording

    def inc(self, name: str, value: float = 1.0) -> None:
        if not _trace.is_enabled():
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def gauge(self, name: str, value: float) -> None:
        if not _trace.is_enabled():
            return
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        """Streaming histogram update (count/total/min/max)."""
        if not _trace.is_enabled():
            return
        v = float(value)
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                self._hists[name] = {"count": 1, "total": v, "min": v, "max": v}
            else:
                h["count"] += 1
                h["total"] += v
                h["min"] = min(h["min"], v)
                h["max"] = max(h["max"], v)

    def record_plan(self, key: str, backend: str,
                    est: Optional[Dict[str, Any]] = None) -> None:
        """A planner decision: ``key`` is the plan fingerprint (or a shape
        tag), ``backend`` the chosen accumulator, ``est`` the modeled costs
        (only ``cost_*``/``interm_*``/``splim_model_s`` keys are kept)."""
        if not _trace.is_enabled():
            return
        kept = {k: v for k, v in (est or {}).items()
                if k.startswith(("cost_", "interm_", "splim_model"))}
        with self._lock:
            ent = self._planner.setdefault(
                key, {"backend": backend, "est": {}, "measured_us": {}})
            ent["backend"] = backend
            if kept:
                ent["est"] = kept
            self._counters["planner.decisions"] = \
                self._counters.get("planner.decisions", 0.0) + 1
            bk = f"planner.chose.{backend}"
            self._counters[bk] = self._counters.get(bk, 0.0) + 1

    def record_backend_us(self, key: str, backend: str, us: float) -> None:
        """A measured accumulate for plan ``key`` on ``backend`` — the
        'measured' side of est-vs-measured. Keeps the minimum (best) µs."""
        if not _trace.is_enabled():
            return
        with self._lock:
            ent = self._planner.setdefault(
                key, {"backend": None, "est": {}, "measured_us": {}})
            prev = ent["measured_us"].get(backend)
            ent["measured_us"][backend] = \
                us if prev is None else min(prev, us)

    # ------------------------------------------------------------ snapshot

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict copy; per-plan mispredict ratio is computed here
        (measured[chosen] / min(measured)) when ≥2 backends were measured."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: dict(v) for k, v in self._hists.items()}
            planner = {k: {"backend": v["backend"],
                           "est": dict(v["est"]),
                           "measured_us": dict(v["measured_us"])}
                       for k, v in self._planner.items()}
        for ent in planner.values():
            meas = ent["measured_us"]
            chosen = ent["backend"]
            if chosen in meas and len(meas) >= 2:
                best = min(meas.values())
                ent["mispredict_ratio"] = \
                    (meas[chosen] / best) if best > 0 else None
            else:
                ent["mispredict_ratio"] = None
        for h in hists.values():
            h["mean"] = h["total"] / h["count"] if h["count"] else 0.0
        return {"counters": counters, "gauges": gauges,
                "histograms": hists, "planner": planner}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._planner.clear()


_metrics = Metrics()


def get_metrics() -> Metrics:
    return _metrics


def inc(name: str, value: float = 1.0) -> None:
    _metrics.inc(name, value)


def gauge(name: str, value: float) -> None:
    _metrics.gauge(name, value)


def observe(name: str, value: float) -> None:
    _metrics.observe(name, value)


def record_plan(key: str, backend: str, est=None) -> None:
    _metrics.record_plan(key, backend, est)


def record_backend_us(key: str, backend: str, us: float) -> None:
    _metrics.record_backend_us(key, backend, us)


def snapshot() -> Dict[str, Any]:
    return _metrics.snapshot()


def reset() -> None:
    _metrics.reset()
