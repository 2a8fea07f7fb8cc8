"""Zero-dependency runtime tracing for the SpGEMM stack, mirroring
``src/repro/obs/trace.py``.

One global :class:`Tracer`, **disabled by default**: every instrumentation
point in the library goes through :func:`span` / :func:`instant` /
:func:`sync`, which are true no-ops while disabled — ``span`` returns a
shared singleton context manager (no per-call allocation of trace state),
``sync`` returns its argument untouched (no ``torch.cuda.synchronize``),
and nothing is recorded.

Enabled, the tracer records **host-side wall-clock spans** with proper
nesting (a ``contextvars`` stack, so threads and nested calls interleave
correctly) and explicit **device-sync points**: call sites wrap each phase's
result in :func:`sync`, which waits for the CUDA devices holding its tensors
before the span closes — so a span measures the device work, not the
asynchronous launch. CPU tensors need no wait. The port has no tracing
compiler, so no span is ever flagged ``traced``.

Span args are sanitized: numbers/strings/bools pass through, tensors and
arrays are reduced to ``dtype+shape`` strings — **matrix values never enter
a trace**.

Export: :meth:`Tracer.export_chrome` emits Chrome-trace/Perfetto JSON
(``traceEvents`` with ``ph='X'`` complete events, µs timestamps);
:meth:`Tracer.snapshot` returns the raw span dicts for programmatic joins
(``obs/metrics.py`` and ``obs/roofline.py`` consume it).
"""
from __future__ import annotations

import contextvars
import dataclasses
import json
import threading
import time
from typing import Any, Dict, List, Optional

MAX_EVENTS = 200_000     # hard buffer bound; beyond it events are counted, not kept

_stack: "contextvars.ContextVar[tuple]" = contextvars.ContextVar(
    "repro_torch_obs_span_stack", default=())


def _clean_args(args: Dict[str, Any]) -> Dict[str, Any]:
    """Sanitize span args: scalars pass, arrays become dtype+shape strings.
    Array *contents* are never recorded (privacy contract)."""
    out: Dict[str, Any] = {}
    for k, v in args.items():
        if v is None or isinstance(v, (bool, int, float, str)):
            out[k] = v
        elif hasattr(v, "item") and getattr(v, "shape", None) == ():
            try:
                out[k] = v.item()
            except Exception:
                out[k] = f"<{type(v).__name__}>"
        else:
            shape = getattr(v, "shape", None)
            dtype = str(getattr(v, "dtype", "")).removeprefix("torch.")
            out[k] = (f"<{dtype}{tuple(shape)}>" if shape is not None
                      else f"<{type(v).__name__}>")
    return out


class _NullSpan:
    """Shared do-nothing span returned while tracing is disabled — one
    module-level instance, so a disabled ``span(...)`` allocates no trace
    state whatsoever."""

    __slots__ = ()
    dur_us: Optional[float] = None
    name = ""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw):            # parity with Span.set
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One live span. Use as a context manager; ``dur_us`` is readable after
    exit (``obs/roofline.py`` times measurements through it)."""

    __slots__ = ("tracer", "name", "args", "t0", "dur_us", "_token",
                 "parent", "depth")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0
        self.dur_us: Optional[float] = None
        self.parent: Optional[str] = None
        self.depth = 0

    def set(self, **kw) -> "Span":
        """Attach/override args mid-span (e.g. a result's nnz)."""
        self.args.update(_clean_args(kw))
        return self

    def __enter__(self) -> "Span":
        stack = _stack.get()
        self.parent = stack[-1].name if stack else None
        self.depth = len(stack)
        self._token = _stack.set(stack + (self,))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _stack.reset(self._token)
        self.dur_us = (t1 - self.t0) / 1e3
        self.tracer._record(self, t1)
        return False


class Tracer:
    """Thread-safe span/instant recorder (see module docstring)."""

    def __init__(self):
        self._enabled = False
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._dropped = 0
        self._epoch_ns = time.perf_counter_ns()

    # ------------------------------------------------------------- control

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, reset: bool = False) -> None:
        if reset:
            self.reset()
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def reset(self) -> None:
        with self._lock:
            self._events = []
            self._dropped = 0
            self._epoch_ns = time.perf_counter_ns()

    # ------------------------------------------------------------ recording

    def span(self, name: str, **args) -> Span:
        return Span(self, name, _clean_args(args))

    def instant(self, name: str, **args) -> None:
        """Record a point event (chrome ``ph='i'``)."""
        if not self._enabled:
            return
        now = time.perf_counter_ns()
        stack = _stack.get()
        ev = {"name": name, "ph": "i",
              "ts_us": (now - self._epoch_ns) / 1e3, "dur_us": 0.0,
              "tid": threading.get_ident() & 0xFFFF,
              "depth": len(stack),
              "parent": stack[-1].name if stack else None,
              "args": _clean_args(args)}
        self._append(ev)

    def _record(self, sp: Span, t1_ns: int) -> None:
        if not self._enabled:
            return
        self._append({"name": sp.name, "ph": "X",
                      "ts_us": (sp.t0 - self._epoch_ns) / 1e3,
                      "dur_us": (t1_ns - sp.t0) / 1e3,
                      "tid": threading.get_ident() & 0xFFFF,
                      "depth": sp.depth, "parent": sp.parent,
                      "args": sp.args})

    def _append(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) < MAX_EVENTS:
                self._events.append(ev)
            else:
                self._dropped += 1

    # -------------------------------------------------------------- export

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict copy of every recorded event (programmatic joins)."""
        with self._lock:
            events = [dict(e) for e in self._events]
            dropped = self._dropped
        return {"events": events, "dropped": dropped}

    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        """Recorded complete spans, optionally filtered by exact name."""
        snap = self.snapshot()["events"]
        return [e for e in snap
                if e["ph"] == "X" and (name is None or e["name"] == name)]

    def export_chrome(self, path: Optional[str] = None,
                      extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Chrome-trace/Perfetto JSON: ``{"traceEvents": [...]}`` with µs
        timestamps. ``extra`` keys (e.g. a metrics snapshot) are merged at
        the top level — trace viewers ignore unknown keys."""
        snap = self.snapshot()
        trace_events = [{"name": e["name"], "cat": "repro_torch",
                         "ph": e["ph"], "ts": e["ts_us"], "dur": e["dur_us"],
                         "pid": 0, "tid": e["tid"], "args": e["args"]}
                        for e in snap["events"]]
        out: Dict[str, Any] = {"traceEvents": trace_events,
                               "displayTimeUnit": "ms"}
        if snap["dropped"]:
            out["droppedEvents"] = snap["dropped"]
        if extra:
            out.update(extra)
        if path is not None:
            with open(path, "w") as f:
                json.dump(out, f, indent=1)
        return out


_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer


def is_enabled() -> bool:
    return _tracer._enabled


def enable(reset: bool = False) -> None:
    _tracer.enable(reset=reset)


def disable() -> None:
    _tracer.disable()


def reset() -> None:
    _tracer.reset()


def span(name: str, **args):
    """The library-wide instrumentation point. Disabled: returns the shared
    null span — no state allocated, nothing recorded."""
    if not _tracer._enabled:
        return NULL_SPAN
    return _tracer.span(name, **args)


def instant(name: str, **args) -> None:
    if _tracer._enabled:
        _tracer.instant(name, **args)


def _cuda_devices(x, found: set) -> None:
    """Collect the CUDA devices of the tensors in ``x``: a tensor, or
    tuples, lists, dict values and dataclass fields holding tensors."""
    import torch
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            found.add(x.device)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, found)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _cuda_devices(getattr(x, f.name), found)


def sync(x):
    """Device-sync point: while tracing, wait (one
    ``torch.cuda.synchronize``) for each CUDA device among ``x``'s tensors,
    so spans measure device work, not launches; CPU tensors need none.
    Disabled, it touches nothing. Returns ``x``."""
    if not _tracer._enabled:
        return x
    found: set = set()
    _cuda_devices(x, found)
    if found:
        import torch
        for dev in found:
            torch.cuda.synchronize(dev)
    return x


def export_chrome(path: Optional[str] = None, extra=None) -> Dict[str, Any]:
    return _tracer.export_chrome(path, extra=extra)
