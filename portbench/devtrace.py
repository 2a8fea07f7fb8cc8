"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over a steady
part of the window, reduced to busy time, time by device operation, the
program's own kernels, and the idle gaps named by what the host was doing.

The profiler starts and stops only between calls (or flushes), so every
call it sees is whole. The part it covers starts a quarter into the window
and lasts up to 8 seconds, ending no later than three quarters in. The
trace goes to a temporary file under ``TMPDIR``, is read back and deleted.
"""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "portbench.window"
TOP = 10


def port_kernel_names(csrc: Path) -> List[str]:
    """The ``__global__`` functions of the program's CUDA sources."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?(\w+)\s*\(")
    names = set()
    for src in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        names.update(pat.findall(src.read_text()))
    return sorted(names)


def is_port_kernel(kernel: str, names: List[str]) -> bool:
    """A trace's kernel name is one of the program's: its function in an
    anonymous namespace, outside PyTorch's own (``at::``) and CUB's."""
    if "at::" in kernel or "cub::" in kernel:
        return False
    m = re.search(r"\(anonymous namespace\)::(?:\w+::)*(\w+)", kernel)
    return bool(m) and m.group(1) in names


def warm_up(device) -> None:
    """One short profile in set-up, so that the profiler's own start (its
    first one in a process takes seconds) falls outside the window."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1024, device=device).add_(1)
        torch.cuda.synchronize(device)


class Window:
    """Profiles one part of a run's window; ``tick(t)`` at each boundary
    between calls with the seconds since the window opened."""

    def __init__(self, enabled: bool, seconds: float, launch_counts):
        self.enabled = enabled
        self.start_at = 0.25 * seconds
        self.stop_at = min(self.start_at + 8.0, 0.75 * seconds)
        self.launch_counts = launch_counts
        self.state = "before"
        self.units: List[dict] = []
        self._prof = self._mark = None

    @property
    def on(self) -> bool:
        return self.state == "on"

    def tick(self, t: float) -> None:
        if not self.enabled:
            return
        if self.state == "before" and t >= self.start_at:
            torch.cuda.synchronize()
            self._prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._mark = torch.profiler.record_function(MARK)
            self._mark.__enter__()
            self._launch0 = self._seen = self.launch_counts()
            self._t0 = time.perf_counter()
            self.state = "on"
        elif self.state == "on" and t >= self.stop_at:
            self.stop()

    def launched(self) -> frozenset:
        """The program's kernel wrappers launched since the last call of
        this (or since profiling began); empty while not profiling."""
        if not self.on:
            return frozenset()
        now = self.launch_counts()
        ran = frozenset(k for k, n in now.items()
                        if n > self._seen.get(k, 0))
        self._seen = now
        return ran

    def unit(self, **info) -> None:
        """One whole call or request ran inside the profiled part."""
        if self.on:
            self.units.append(info)

    def stop(self) -> None:
        if self.state != "on":
            return
        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        after = self.launch_counts()
        self.launches = {k: after[k] - self._launch0.get(k, 0)
                         for k in after}
        self.state = "done"

    def reduce(self, names: List[str]) -> Optional[Dict]:
        """The profiled part reduced (None where nothing was profiled)."""
        if self.state != "done":
            return None
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        self._prof = None
        return reduce_events(events, names, self.launches, self.units,
                             self.wall_s)


def _union(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events, names, launches, units, wall_s) -> Optional[Dict]:
    """Busy and window seconds, device time by operation, the program's
    kernels' time, and idle gaps by host operation, from chrome-trace
    events (µs)."""
    marks = [e for e in events if e.get("name") == MARK
             and e.get("cat") == "user_annotation"]
    if not marks:
        return None
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    dev, by_name, port_us = [], {}, 0.0
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        dev.append((a, b))
        name = e.get("name", "?")
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        if e["cat"] == "kernel" and is_port_kernel(name, names):
            port_us += b - a
    busy = _union(dev)
    busy_us = sum(b - a for a, b in busy)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e.get("name", "?")) for e in events
                  if e.get("cat") in ("cpu_op", "user_annotation")
                  and e.get("name") != MARK and "dur" in e)
    starts = [h[0] for h in host]
    gaps, t = {}, w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            label = _host_at((t + a) / 2, host, starts)
            gaps[label] = gaps.get(label, 0.0) + (a - t) / 1e6
        t = max(t, b)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
        "wall_s": wall_s, "port_kernel_s": port_us / 1e6,
        "launches": launches, "units": units,
        "device_ops": [[_short(n), us / 1e6] for n, us in top_ops],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:TOP],
        "port_kernels_seen": sorted({_short(n) for n in by_name
                                     if is_port_kernel(n, names)}),
    }


def _host_at(t: float, host, starts) -> str:
    """The innermost host operation running at ``t`` (the latest started
    of those that contain it), or the host's own Python."""
    i = bisect.bisect_right(starts, t)
    for a, b, name in reversed(host[max(0, i - 400):i]):
        if b >= t:
            return name
    return "host: python"


def _short(name: str) -> str:
    return name if len(name) <= 96 else name[:93] + "..."
