"""Fault-tolerance primitives: retries, straggler detection, preemption,
as ``src/repro/runtime/fault.py`` has them.

On a 1000+-node fleet the failure model is: (a) transient device/runtime
errors → retry the step from the last good state; (b) slow nodes → detect
via per-step timing statistics and flag for the scheduler to re-mesh;
(c) preemption notices → checkpoint immediately and exit cleanly. All three
are host-side wrappers around the step, so they add nothing to its device
work.

The reference retries a functional step from the same inputs. The port's
step (``launch.steps.make_train_step``) updates params and optimizer state
in place, but only after its forward and backward have finished: a step
that raises before its update leaves both untouched, so a retry starts from
the same state. A failure once the update has begun writing is raised as
``optim.PartialUpdateError``, which is not a ``RuntimeError``: it is never
retried from the half-updated state, and goes up to the caller (the
trainer resumes from its last checkpoint on the next run). A CUDA error
is a ``RuntimeError``: it is retried, and re-raised once ``max_retries``
retries have failed, never swallowed.
"""
from __future__ import annotations

import signal
import time
from collections import deque
from typing import Callable, Optional


def retry_with_backoff(fn: Callable, max_retries: int = 3,
                       base_delay: float = 0.5,
                       retriable=(RuntimeError,)):
    """Wrap a step callable: transient failures retry with exp backoff."""
    def wrapped(*args, **kwargs):
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except retriable as e:
                attempt += 1
                if attempt > max_retries:
                    raise
                delay = base_delay * (2 ** (attempt - 1))
                print(f"[fault] step failed ({e!r}); retry {attempt}/"
                      f"{max_retries} in {delay:.1f}s", flush=True)
                time.sleep(delay)
    return wrapped


class StragglerDetector:
    """EWMA + robust-sigma step-time monitor.

    A step slower than mean + k·sigma is flagged; persistent flags mark this
    host a straggler (the launcher can then request a re-mesh / hot spare).
    """

    def __init__(self, window: int = 64, k_sigma: float = 4.0,
                 persistent: int = 8):
        self.times = deque(maxlen=window)
        self.k = k_sigma
        self.persistent = persistent
        self.flags = 0
        self.is_straggler = False

    def record(self, step_time: float) -> bool:
        import numpy as np
        flagged = False
        if len(self.times) >= 8:
            arr = np.asarray(self.times)
            med = float(np.median(arr))
            mad = float(np.median(np.abs(arr - med))) + 1e-9
            if step_time > med + self.k * 1.4826 * mad:
                flagged = True
        self.times.append(step_time)
        self.flags = self.flags + 1 if flagged else 0
        if self.flags >= self.persistent:
            self.is_straggler = True
        return flagged


class FaultTolerantStep:
    """Composes retry + straggler tracking + preemption-checkpoint around a
    compiled step function."""

    def __init__(self, step_fn: Callable, on_preempt: Optional[Callable] = None,
                 max_retries: int = 3):
        self._raw = step_fn
        self._step = retry_with_backoff(step_fn, max_retries=max_retries)
        self.detector = StragglerDetector()
        self._preempted = False
        self._on_preempt = on_preempt
        try:
            signal.signal(signal.SIGTERM, self._handle)
        except ValueError:
            pass   # not on main thread (tests)

    def _handle(self, signum, frame):
        self._preempted = True

    @property
    def preempted(self) -> bool:
        return self._preempted

    def __call__(self, *args, **kwargs):
        t0 = time.time()
        out = self._step(*args, **kwargs)
        self.detector.record(time.time() - t0)
        if self._preempted and self._on_preempt is not None:
            self._on_preempt(out)
        return out
