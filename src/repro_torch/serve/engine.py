"""The serving engine, mirroring ``src/repro/serve/engine.py``: token
serving (``ServingEngine.generate_batch``) and the SpGEMM lane.

``generate_batch`` serves one admission wave: the prompts left-padded with
``eos_id`` into one (B, S) batch (no pad mask, as the reference has none),
one ``Model.prefill`` at ``s_max``, then shared ``Model.decode_step``s while
any request is alive, under ``torch.inference_mode()``. Sampling is the
reference's, on the host with its numpy generator seeded from ``cfg.seed``.
There is nothing to compile and nothing donated: the model's functions run
as they are, and the decode cache is written in place.

Under ``sharding_rules(mesh)`` the engine serves the partitioned program
(every config, the SSM, hybrid and encoder-decoder ones included): it
places the weights on the mesh by the rules once (``Model.place``, when
it is made under the rules or at its first wave under them), keeping no
whole copy, and prefill lays the caches out by
``launch.steps.cache_shardings`` (keys and values by sequence, the
recurrent states by channel). Tokens and sampling stay on the mesh's
first device: each wave's and step's logits are gathered there
(``Sharded.whole``, counted in ``parallel.mesh.moved_bytes``).

:class:`SparseGemmBatcher` packs heterogeneous per-request SpGEMMs that
share shapes onto ``spgemm_coo_numeric_batched`` slots (structures recycled
through the engine-level ``StructureCache``; fingerprints may differ within
one wave — each slot carries its own key plane), reporting slot occupancy
and per-request latency through :class:`EngineStats`.

Latencies are host-clock seconds. A token wave reads its logits back to the
host to sample, so its prefill and decode times hold the device's work. A
SpGEMM wave ends in ``obs.sync``, which waits for the device only while
``repro_torch.obs`` is enabled: with tracing off on CUDA operands,
``spgemm_compute_s`` times the launches, not the work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.formats import Coo, EllCols, EllRows
from ..core.spgemm import spgemm_coo_numeric, spgemm_coo_numeric_batched
from ..kernels.insitu_search import KEY_INVALID
from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs
from ..plan.cache import StructureCache
from ..plan.structure import SpgemmStructure


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_prompt: int = 64
    max_new_tokens: int = 32
    s_max: int = 128
    eos_id: int = 2
    greedy: bool = True
    temperature: float = 1.0
    seed: int = 0
    # engine-level SpGEMM structure cache (plan.cache.StructureCache): one
    # symbolic phase per sparsity pattern across ALL requests; on-disk
    # persistence warm-starts restarted replicas; autotune replaces the cost
    # model's backend pick with a measured winner on first use.
    structure_cache_size: int = 64
    structure_cache_dir: Optional[str] = None
    structure_autotune: bool = False


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_enq: float = 0.0          # wall-clock at admission
    t_done: float = 0.0         # wall-clock at completion


class EngineStats(dict):
    """Engine counters: a plain dict (``eng.stats["spgemm_waves"]`` keeps
    working) that is also callable — ``eng.stats()`` returns a full snapshot
    joining the counters with per-request latency aggregates, mean batch
    occupancy (decode slots and SpGEMM slots), and the structure cache's
    own counters."""

    def __init__(self, engine: "ServingEngine"):
        super().__init__(requests=0, tokens=0, decode_s=0.0, prefill_s=0.0,
                         queue_s=0.0, compute_s=0.0, decode_steps=0,
                         occupancy_sum=0.0, spgemm_requests=0,
                         spgemm_waves=0, spgemm_batched_waves=0,
                         spgemm_occupancy_sum=0.0, spgemm_queue_s=0.0,
                         spgemm_compute_s=0.0)
        self._engine = engine

    def __call__(self) -> Dict:
        snap = {k: v for k, v in self.items()}
        steps = snap.pop("decode_steps")
        occ = snap.pop("occupancy_sum")
        n = max(1, snap["requests"])
        snap["decode_steps"] = steps
        snap["batch_occupancy"] = occ / steps if steps else 0.0
        snap["queue_s_per_request"] = snap["queue_s"] / n
        snap["compute_s_per_request"] = snap["compute_s"] / n
        bw = snap.get("spgemm_batched_waves", 0)
        socc = snap.pop("spgemm_occupancy_sum", 0.0)
        snap["spgemm_occupancy"] = socc / bw if bw else 0.0
        ns = max(1, snap.get("spgemm_requests", 0))
        snap["spgemm_latency_s_per_request"] = (
            snap.get("spgemm_queue_s", 0.0)
            + snap.get("spgemm_compute_s", 0.0)) / ns
        snap["structure_cache"] = self._engine.structure_cache.stats()
        return snap


@dataclasses.dataclass
class SparseGemmRequest:
    """One pending sparse multiply: ELLPACK operands + timing bookkeeping."""
    rid: int
    a: EllRows
    b: EllCols
    t_enq: float
    t_done: float = 0.0
    result: Optional[Coo] = None


class SparseGemmBatcher:
    """Continuous batching of heterogeneous sparse requests onto SpGEMM slots.

    ``submit`` enqueues one ``C = A·B``; ``flush`` drains the queue: requests
    are grouped by operand *shape* signature (shapes, value dtypes and
    device; patterns — fingerprints — may differ freely within a group: each
    batched slot carries its own structure key plane), their structures come
    from / return to the shared ``StructureCache`` (one symbolic phase per
    distinct fingerprint across the whole engine lifetime), and every group
    runs in waves of ``max_slots`` through ``spgemm_coo_numeric_batched``.
    Singleton waves skip the batch machinery (``spgemm_coo_numeric``, which
    honours the structure's plan: a ``'stream'`` structure goes by slab
    groups).

    A wave stacks only its real requests: the batched numeric phase is a
    loop over slots, so a padded slot would be a whole multiply for nothing
    (the reference repeats request 0 into the empty slots to keep its
    compiled shapes static). Results, ``ngroups``, each result's ``cap``
    (the wave's widest ``out_cap``) and the counters are the reference's.

    ``stats`` (any dict; the engine passes its :class:`EngineStats`) gains
    ``spgemm_requests`` / ``spgemm_waves`` / ``spgemm_batched_waves``
    counters, ``spgemm_occupancy_sum`` (real slots over ``max_slots``, per
    batched wave) and per-request ``spgemm_queue_s`` / ``spgemm_compute_s``
    latency totals.
    """

    _STAT_INTS = ("spgemm_requests", "spgemm_waves", "spgemm_batched_waves")
    _STAT_FLOATS = ("spgemm_occupancy_sum", "spgemm_queue_s",
                    "spgemm_compute_s")

    def __init__(self, cache: StructureCache, *, max_slots: int = 8,
                 stats=None):
        self.cache = cache
        self.max_slots = max(1, int(max_slots))
        self.stats = stats if stats is not None else {}
        for k in self._STAT_INTS:
            self.stats.setdefault(k, 0)
        for k in self._STAT_FLOATS:
            self.stats.setdefault(k, 0.0)
        self._pending: List[SparseGemmRequest] = []
        self._next_rid = 0

    def submit(self, a: EllRows, b: EllCols) -> int:
        """Enqueue C = A·B (row-wise ELLPACK × col-wise ELLPACK); returns
        a request id to look the result up with after ``flush``."""
        rid = self._next_rid
        self._next_rid += 1
        self._pending.append(SparseGemmRequest(rid, a, b, time.time()))
        self.stats["spgemm_requests"] += 1
        _obs_metrics.inc("serve.spgemm_submits")
        return rid

    def pending(self) -> int:
        return len(self._pending)

    def flush(self, **structure_kwargs) -> Dict[int, Coo]:
        """Run every pending request; returns {rid: sorted-COO result}.

        ``structure_kwargs`` forward to the structure build on a cache miss
        (``backend=``, ``out_cap=``, ...)."""
        reqs, self._pending = self._pending, []
        out: Dict[int, Coo] = {}
        groups: Dict[tuple, List[SparseGemmRequest]] = {}
        for r in reqs:
            sig = (r.a.n_rows, r.a.n_cols, r.a.k, r.b.n_cols, r.b.k,
                   str(r.a.val.dtype), str(r.b.val.dtype),
                   str(r.a.val.device))
            groups.setdefault(sig, []).append(r)
        for members in groups.values():
            t0 = time.time()
            for r in members:
                self.stats["spgemm_queue_s"] += t0 - r.t_enq
            # structure recycling: one symbolic phase per fingerprint,
            # shared across requests/waves/flushes via the engine cache
            sts = [self.cache.get(r.a, r.b, **structure_kwargs)
                   for r in members]
            for lo in range(0, len(members), self.max_slots):
                self._run_wave(members[lo:lo + self.max_slots],
                               sts[lo:lo + self.max_slots], out)
        return out

    def _run_wave(self, wave: List[SparseGemmRequest],
                  wsts: List[SpgemmStructure], out: Dict[int, Coo]) -> None:
        t0 = time.time()
        self.stats["spgemm_waves"] += 1
        batched = len(wave) > 1
        with _obs.span("serve.spgemm_wave", real=len(wave),
                       slots=self.max_slots if batched else 1,
                       batched=batched):
            if not batched:
                r, st = wave[0], wsts[0]
                # the cache key already proved the fingerprint matches
                r.result = spgemm_coo_numeric(r.a, r.b, st, validate=False)
            else:
                a_b, b_b, st_b = self._pack(wave, wsts)
                coo = spgemm_coo_numeric_batched(a_b, b_b, st_b,
                                                 validate=False)
                for i, r in enumerate(wave):
                    r.result = Coo(row=coo.row[i], col=coo.col[i],
                                   val=coo.val[i], shape=coo.shape,
                                   ngroups=coo.ngroups[i])
                occ = len(wave) / self.max_slots
                self.stats["spgemm_batched_waves"] += 1
                self.stats["spgemm_occupancy_sum"] += occ
                _obs_metrics.gauge("serve.spgemm_occupancy", occ)
            _obs.sync(wave[-1].result.val)
        t1 = time.time()
        for r in wave:
            r.t_done = t1
            self.stats["spgemm_compute_s"] += t1 - t0
            _obs_metrics.observe("serve.spgemm_request_us",
                                 (r.t_done - r.t_enq) * 1e6)
            out[r.rid] = r.result

    @staticmethod
    def _pack(wave: List[SparseGemmRequest], wsts: List[SpgemmStructure]):
        """Stack a wave's real requests: operands stacked, per-slot key
        planes padded to the widest structure's ``out_cap`` with
        ``KEY_INVALID`` (keys stay ascending, so the numeric search is
        unaffected)."""
        cap = max(st.out_cap for st in wsts)

        def pad_key(k):
            if k.shape[0] == cap:
                return k
            return torch.cat([k, k.new_full((cap - k.shape[0],),
                                            KEY_INVALID)])

        a0, b0 = wave[0].a, wave[0].b
        a_b = EllRows(val=torch.stack([r.a.val for r in wave]),
                      idx=torch.stack([r.a.idx for r in wave]),
                      n_rows=a0.n_rows)
        b_b = EllCols(val=torch.stack([r.b.val for r in wave]),
                      idx=torch.stack([r.b.idx for r in wave]),
                      n_cols=b0.n_cols)
        st_b = SpgemmStructure(
            key=torch.stack([pad_key(st.key) for st in wsts]),
            row_nnz=torch.stack([st.row_nnz for st in wsts]),
            seg=torch.stack([st.seg for st in wsts]),
            nnz=torch.stack([st.nnz for st in wsts]),
            n_rows=wsts[0].n_rows, n_cols=wsts[0].n_cols, out_cap=cap,
            fp=None, plan=None)
        return a_b, b_b, st_b


class ServingEngine:
    """Token serving over ``model`` (a ``models.Model``) and its ``params``,
    and the SpGEMM lane over one shared ``StructureCache``. ``model`` and
    ``params`` may be None for an engine that serves SpGEMM requests only.
    Token batches go to the device the parameters are on, or the mesh's
    first device where they are placed."""

    def __init__(self, model, params, cfg: ServeConfig):
        self.model = model
        self.params = params
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)
        self.structure_cache = StructureCache(
            capacity=cfg.structure_cache_size,
            cache_dir=cfg.structure_cache_dir,
            autotune=cfg.structure_autotune)
        self.stats = EngineStats(self)
        # heterogeneous sparse-request batching over the same cache/stats
        self.sparse_batcher = SparseGemmBatcher(
            self.structure_cache, max_slots=cfg.max_batch, stats=self.stats)
        self._place()

    def _place(self) -> None:
        """Under ``sharding_rules(mesh)``, the weights laid out on that mesh
        once; weights placed on another mesh raise."""
        from ..models.params import is_placed, tree_leaves
        from ..parallel.sharding import current_rules
        rules = current_rules()
        if self.model is None or rules is None or rules.mesh is None:
            return
        if is_placed(self.params):
            if tree_leaves(self.params)[0].mesh is not rules.mesh:
                raise ValueError("the weights are placed on another mesh "
                                 "than the active rules'")
            return
        self.params = self.model.place(self.params)

    def spgemm(self, a: EllRows, b: EllCols, **structure_kwargs) -> Coo:
        """Two-phase SpGEMM through the engine's shared structure cache.

        Any sparse multiply issued on behalf of a request lands here: the
        first request with a given sparsity pattern pays the symbolic phase,
        every subsequent request — across the whole engine lifetime, and
        across restarts when ``structure_cache_dir`` is set — runs
        numeric-only. ``structure_kwargs`` forward to the structure build on
        a miss."""
        structure = self.structure_cache.get(a, b, **structure_kwargs)
        # the cache key already proved the fingerprint matches
        return spgemm_coo_numeric(a, b, structure, validate=False)

    def submit_spgemm(self, a: EllRows, b: EllCols) -> int:
        """Enqueue a sparse multiply for slot-batched execution; returns the
        request id ``flush_spgemm``'s result dict is keyed by."""
        return self.sparse_batcher.submit(a, b)

    def flush_spgemm(self, **structure_kwargs) -> Dict[int, Coo]:
        """Drain the sparse-request queue through batched numeric SpGEMM
        (see :class:`SparseGemmBatcher`); occupancy and latency land in
        ``self.stats``."""
        return self.sparse_batcher.flush(**structure_kwargs)

    def cache_stats(self) -> Dict[str, int]:
        """Structure-cache counters (hits/misses/evictions/disk_hits/size)
        alongside the serving counters in ``self.stats``."""
        return self.structure_cache.stats()

    def _device(self) -> torch.device:
        from ..models.params import is_placed, tree_leaves
        if is_placed(self.params):
            return tree_leaves(self.params)[0].mesh.devices.flat[0]
        return next(t for t in tree_leaves(self.params)
                    if isinstance(t, torch.Tensor)).device

    def _sample(self, logits: np.ndarray) -> np.ndarray:
        if self.cfg.greedy:
            return np.argmax(logits, axis=-1).astype(np.int32)
        z = logits / max(self.cfg.temperature, 1e-3)
        z = z - z.max(-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(-1, keepdims=True)
        return np.array([self._rng.choice(len(q), p=q) for q in p],
                        dtype=np.int32)

    @staticmethod
    def _host(logits) -> np.ndarray:
        if not isinstance(logits, torch.Tensor):
            logits = logits.whole()
        return logits.to(torch.float32).cpu().numpy()

    def generate_batch(self, prompts: List[np.ndarray]) -> List[List[int]]:
        """Serve one admission wave of ≤ max_batch prompts to completion."""
        cfg = self.cfg
        assert len(prompts) <= cfg.max_batch
        b = len(prompts)
        self._place()
        dev = self._device()
        t_enq = time.time()
        reqs = [Request(i, p, t_enq=t_enq) for i, p in enumerate(prompts)]
        plen = max(len(p) for p in prompts)
        toks = np.full((b, plen), cfg.eos_id, np.int32)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p      # left-pad so last pos = last token
        with torch.inference_mode():
            t0 = time.time()
            # admission → prefill-start is this engine's queue phase
            self.stats["queue_s"] += (t0 - t_enq) * b
            _obs_metrics.observe("serve.queue_us", (t0 - t_enq) * 1e6)
            with _obs.span("serve.prefill", batch=b, prompt_len=plen):
                logits, cache = self.model.prefill(
                    self.params, {"tokens": torch.from_numpy(toks).to(dev)},
                    cfg.s_max)
                host = self._host(logits)
            self.stats["prefill_s"] += time.time() - t0
            self.stats["requests"] += b
            # the first sampled token is a real emission: count it and
            # honour EOS so an immediately-finished request never enters the
            # decode loop
            cur = self._sample(host)
            alive = False
            for r, t in zip(reqs, cur):
                r.out_tokens.append(int(t))
                self.stats["tokens"] += 1
                if t == cfg.eos_id:
                    r.done = True
                    r.t_done = time.time()
                else:
                    alive = True
            t0 = time.time()
            steps = 0
            with _obs.span("serve.decode", batch=b) as _dsp:
                for _ in range(cfg.max_new_tokens - 1):
                    if not alive:
                        break
                    n_alive = sum(not r.done for r in reqs)
                    logits, cache = self.model.decode_step(
                        self.params, cache,
                        torch.from_numpy(cur[:, None]).to(dev))
                    cur = self._sample(self._host(logits))
                    steps += 1
                    # occupancy = live slots over the engine's static grid
                    self.stats["occupancy_sum"] += n_alive / cfg.max_batch
                    self.stats["decode_steps"] += 1
                    _obs_metrics.gauge("serve.batch_occupancy",
                                       n_alive / cfg.max_batch)
                    alive = False
                    for r, t in zip(reqs, cur):
                        if r.done:
                            continue
                        r.out_tokens.append(int(t))
                        self.stats["tokens"] += 1
                        if t == cfg.eos_id:
                            r.done = True
                            r.t_done = time.time()
                        else:
                            alive = True
                _dsp.set(steps=steps)
            self.stats["decode_s"] += time.time() - t0
        t_end = time.time()
        for r in reqs:
            if not r.done:
                r.t_done = t_end
            compute_s = r.t_done - r.t_enq
            self.stats["compute_s"] += compute_s
            _obs_metrics.observe("serve.compute_us", compute_s * 1e6)
        return [r.out_tokens for r in reqs]
