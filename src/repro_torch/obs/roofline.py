"""Measured-vs-modeled roofline per accumulation backend, mirroring
``src/repro/obs/roofline.py``.

Span timings (``obs/trace``) are joined against the planner's modeled
intermediate traffic (``Plan.est["interm_*"]``, built from
``core/hwmodel.MatrixStats``) to express each backend's achieved bandwidth
as a fraction of what the device can actually stream.

* :func:`modeled_bytes` — the memory traffic the cost model says one
  ``spgemm_coo`` call with a given backend moves: operand lanes in, the
  materialized intermediate (the ``interm_<backend>`` term the planner
  scores), and the COO output out.
* :func:`measure_reference_bw` — a self-calibrating bandwidth anchor: an
  elementwise multiply of one buffer into another, timed on the device. On
  CUDA it is timed with CUDA events over 1 GiB buffers, far past the H100's
  50 MB L2, so the anchor is HBM's rate and not L2's; on the CPU over 16 MiB
  with the host clock, as the reference.
* :func:`measure_roofline` — times each backend's ``spgemm_coo`` through a
  ``roofline.measure`` span (tracer enabled for the duration if it was off,
  so the timings ARE span timings) and returns per-backend
  ``{us, modeled_bytes, modeled_flops, achieved_bw, ref_bw, frac}``.

``frac`` = achieved_bw / ref_bw ∈ (0, 1.5] is the gate: a backend that moves
its modeled bytes slower than a plain streaming copy lands in (0, 1), and a
value above 1.5 would mean the model's byte count is inconsistent with
physics (or the timer broke).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence

from . import trace as _trace

_REF_ELEMS_CPU = 4 * 1024 * 1024        # 16 MiB of f32, the reference's
_REF_ELEMS_CUDA = 256 * 1024 * 1024     # 1 GiB of f32, ≫ the 50 MB L2


def modeled_bytes(plan, backend: str, *, nnz_a: int, nnz_b: int) -> float:
    """Modeled memory traffic of one spgemm_coo call for ``backend``.

    Operands: 8 B per stored lane (f32 value + i32 index). Intermediate:
    the planner's ``interm_<backend>`` estimate — the materialized
    un-accumulated product stream (or the streaming engine's bounded
    working set). Output: 12 B per COO coordinate (row + col + val).
    Falls back to operands+output when the plan carries no estimates
    (hand-built plans).
    """
    est = plan.est or {}
    interm = float(est.get(f"interm_{backend}", 0.0))
    return 8.0 * (nnz_a + nnz_b) + interm + 12.0 * float(plan.out_cap)


def measure_reference_bw(elems: Optional[int] = None, iters: int = 8,
                         device=None) -> float:
    """Measured streaming bandwidth of ``device``, bytes/s.

    ``device`` defaults to the port's device (CUDA, or an error where there
    is none); the CPU is measured only when asked for. One elementwise
    multiply over ``elems`` f32 into a second buffer: reads 4·elems, writes
    4·elems → 8·elems bytes per call. CUDA: ``iters`` calls between two CUDA
    events after a warm call; CPU: the host clock.
    """
    import torch
    from ..core.formats import resolve_device
    device = resolve_device(device)
    on_cuda = device.type == "cuda"
    if elems is None:
        elems = _REF_ELEMS_CUDA if on_cuda else _REF_ELEMS_CPU
    x = torch.arange(elems, dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    torch.mul(x, 1.0000001, out=y)                # warm outside timing
    if on_cuda:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            torch.mul(x, 1.0000001, out=y)
        stop.record()
        stop.synchronize()
        dt = start.elapsed_time(stop) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            torch.mul(x, 1.0000001, out=y)
        dt = (time.perf_counter() - t0) / iters
    return 8.0 * elems / max(1e-9, dt)


def measure_roofline(a, b, *, plan=None,
                     backends: Optional[Sequence[str]] = None,
                     iters: int = 3, warmup: int = 1,
                     ref_bw: Optional[float] = None) -> Dict[str, Dict]:
    """Per-backend achieved-vs-modeled bandwidth on one operand pair.

    Times ``iters`` ``spgemm_coo`` calls per backend inside a
    ``roofline.measure`` span (the tracer is enabled for the duration if it
    was off, and restored after; each call ends in a device sync), then
    joins ``Span.dur_us`` against :func:`modeled_bytes`. ``plan`` defaults
    to ``make_plan(a, b)``, whose ``est`` holds every backend's bytes.
    """
    from ..core.spgemm import spgemm_coo
    from ..plan.planner import BACKENDS, make_plan
    if plan is None:
        plan = make_plan(a, b)
    if backends is None:
        backends = BACKENDS
    if ref_bw is None:
        ref_bw = measure_reference_bw(device=a.idx.device)
    nnz_a = int((a.idx >= 0).sum())
    nnz_b = int((b.idx >= 0).sum())
    flops = 2.0 * float((plan.stats.valid_products
                         if plan.stats is not None else 0))
    was_on = _trace.is_enabled()
    if not was_on:
        _trace.enable()
    out: Dict[str, Dict] = {}
    try:
        for bk in backends:
            p = dataclasses.replace(plan, backend=bk)

            def call():
                return _trace.sync(spgemm_coo(a, b, out_cap=plan.out_cap,
                                              accumulator=bk, plan=p))

            for _ in range(max(1, warmup)):
                call()
            with _trace.span("roofline.measure", backend=bk,
                             iters=iters) as sp:
                for _ in range(iters):
                    call()
            t_us = max(1e-3, (sp.dur_us or 0.0) / max(1, iters))
            mbytes = modeled_bytes(plan, bk, nnz_a=nnz_a, nnz_b=nnz_b)
            achieved = mbytes / (t_us * 1e-6)
            out[bk] = {
                "us": t_us,
                "modeled_bytes": mbytes,
                "modeled_flops": flops,
                "achieved_bw": achieved,
                "achieved_flops": flops / (t_us * 1e-6),
                "ref_bw": ref_bw,
                "frac": achieved / ref_bw,
            }
    finally:
        if not was_on:
            _trace.disable()
    return out
