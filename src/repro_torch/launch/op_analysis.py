"""Operation count of one step, the port's counterpart of
``src/repro/launch/hlo_analysis.py``.

The reference parses optimized HLO, because XLA's ``cost_analysis`` counts
a while-loop body once and a scan over layers hides most of the step; it
recovers each loop's trip count and scales its body. The port runs eagerly:
a layer loop is a Python loop, and every aten op a step executes passes
through the dispatcher, so counting the ops as they run needs no trip
counts. ``analyze(fn, *args)`` runs ``fn`` under ``FlopCounterMode`` and a
``TorchDispatchMode`` of its own, on ``meta`` tensors in the dry run (no
allocation) or on the card, and records:

  * ``flops``            matmul-family FLOPs (mm, bmm, addmm, baddbmm,
                         convolution, attention), ``FlopCounterMode``'s
                         rules, forward, checkpoint recompute and backward
  * ``hbm_bytes``        each aten op's operand bytes plus output bytes.
                         An upper bound on what the device moves: eager
                         ops are not fused, so a value written by one op
                         and read by the next counts twice; views and
                         aliases count nothing, and an operand is counted
                         whole however little of it the op reads
  * ``peak_live_bytes``  the highest sum of the bytes of live storages,
                         the arguments' included: each storage counts from
                         the op that made it until it is freed (a weak
                         reference's callback), as one device running the
                         whole program would hold them; a view shares its
                         base's storage, and a temporary an op allocates
                         inside itself is not seen
  * ``n_ops``            aten ops dispatched

The dict has ``analyze_hlo``'s keys. ``collective_bytes`` and
``collective_count`` are None: ``analyze`` counts the ops of whatever runs,
and a collective is not an aten op here. The dry run counts the
partitioned program's collectives itself (``launch.dryrun.
collective_trace``); ``gaps`` says so.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

GAPS = {"collective_bytes": "analyze counts aten ops, not collectives: "
        "the dry run traces the partitioned program for them "
        "(launch.dryrun.collective_trace)"}

_ALLOCATE_ONLY = {torch.ops.aten.empty.memory_format,
                  torch.ops.aten.empty_strided.default,
                  torch.ops.aten.empty_like.default,
                  torch.ops.aten.new_empty.default,
                  torch.ops.aten.new_empty_strided.default}
_ALIASES = {torch.ops.aten._unsafe_view.default,
            torch.ops.aten.lift_fresh.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _LiveBytes(TorchDispatchMode):
    """Operand and output bytes of every op, and the live storages' bytes
    and their peak."""

    def __init__(self):
        super().__init__()
        self.hbm_bytes = 0
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}

    def _freed(self, key: int) -> None:
        self.live -= self._storages.pop(key)

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        weakref.finalize(st, self._freed, key).atexit = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.n_ops += 1
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not (func.is_view or func in _ALIASES or func in _ALLOCATE_ONLY):
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.hbm_bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            self.track(t)
        self.peak = max(self.peak, self.live)
        return out


def analyze(fn, *args) -> Tuple[Any, Dict[str, Any]]:
    """``fn(*args)`` under the counters: returns its result and the counts
    (see the module docstring). The tensors in ``args`` count as live
    from the start."""
    live = _LiveBytes()
    for t in tree_leaves(args):
        if isinstance(t, torch.Tensor):
            live.track(t)
    live.peak = live.live
    with FlopCounterMode(display=False) as flops, live:
        out = fn(*args)
    return out, {"flops": float(flops.get_total_flops()),
                 "hbm_bytes": float(live.hbm_bytes),
                 "collective_bytes": None, "collective_count": None,
                 "peak_live_bytes": live.peak, "n_ops": live.n_ops,
                 "gaps": dict(GAPS)}
