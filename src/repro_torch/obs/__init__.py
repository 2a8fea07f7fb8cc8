"""repro_torch.obs — zero-dependency tracing + metrics for the SpGEMM stack,
mirroring ``repro.obs``.

Disabled by default and free when disabled; ``repro_torch.obs.enable()``
turns on span recording (trace.py), counters/planner-evidence (metrics.py),
and the roofline join (roofline.py, imported lazily to keep
``repro_torch.core`` import order acyclic).

    import repro_torch.obs as obs
    obs.enable()
    c = repro_torch.spgemm(a, b, accumulator="auto")  # instrumented call
    obs.export_chrome("trace.json")       # Perfetto / chrome://tracing
    obs.snapshot()["metrics"]["planner"]  # est-vs-measured per plan

While enabled, each span that wraps device work ends in ``sync``, one
``torch.cuda.synchronize`` for each CUDA device its result lives on.
"""
from __future__ import annotations

from typing import Any, Dict

from . import metrics, trace
from .trace import (NULL_SPAN, Span, Tracer, export_chrome, get_tracer,
                    instant, is_enabled, span, sync)


def enable(reset: bool = False) -> None:
    """Turn on tracing + metrics. ``reset=True`` clears prior recordings."""
    if reset:
        trace.reset()
        metrics.reset()
    trace.enable()


def disable() -> None:
    trace.disable()


def reset() -> None:
    trace.reset()
    metrics.reset()


def snapshot() -> Dict[str, Any]:
    """Combined plain-dict snapshot: ``{"trace": ..., "metrics": ...}``."""
    return {"trace": trace.get_tracer().snapshot(),
            "metrics": metrics.snapshot()}


def __getattr__(name: str):
    if name == "roofline":          # lazy: roofline imports repro_torch.core
        import importlib
        return importlib.import_module(".roofline", __name__)
    raise AttributeError(f"module 'repro_torch.obs' has no attribute "
                         f"{name!r}")


__all__ = [
    "trace", "metrics", "enable", "disable", "reset", "snapshot",
    "span", "sync", "instant", "is_enabled", "export_chrome",
    "get_tracer", "Span", "Tracer", "NULL_SPAN",
]
