"""The general traffic generator: one driver for each ``kind`` of mix, each
reading its parameters from the mix's data file.

``cold``   a closed loop: one caller, back-to-back cold
           ``repro_torch.spgemm(a, b, accumulator="auto")`` calls on C =
           X[:c_rows]·Xᵀ. Before each call's clock starts, C's rows and
           columns are relabelled by fresh permutations from the seed, so
           no two calls share a pattern. Parameters: ``warmup`` (calls in
           set-up), ``sample`` (calls kept for the check, drawn from the
           seed as the window runs).
``serve``  an open loop through ``ServingEngine.submit_spgemm`` and
           ``flush_spgemm``: requests fall due at ``rate`` a second, each
           on one of the patterns that ``drops`` make (the share of X's
           entries a pattern lacks) with one of ``value_sets`` value sets.
           The gaps between requests (the quantiles of an exponential) and
           the patterns are one fixed sequence, which each seed starts at
           a point of its own, so every seed sends the same requests in
           another order; the seed also draws the values. The client
           flushes whenever requests are pending and the last flush has
           returned, and keeps at most one wave (``max_batch`` requests)
           submitted: ``flush_spgemm`` drains every pending request and
           returns all their results together, so a client that let the
           queue grow would hold a whole burst's results at once. Requests
           due beyond the wave wait in the client, and their latency counts
           the wait from when they fell due. Parameters: ``rate``,
           ``drops``, ``value_sets``, ``max_batch``, ``sample`` (requests
           kept for the check).

Each driver builds its operands and warms up in ``setup``, runs the window
in ``window``, and in ``check`` (after the program's state is freed)
compares its sampled results with the plain reference.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench import operands as ops
from portbench import verdict
from portbench.reference.product import product

LATE_S = 60.0       # how long past the window a due request is waited for
TRACE_SEED = 20261019   # the serve mixes' one arrival sequence


def _mark(name: str):
    return torch.profiler.record_function(name)


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        import repro_torch
        self.rt = repro_torch
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, device
        self.rec: Dict = {"units": []}

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def counts(self, keep=None) -> Dict[str, int]:
        """A product's non-zeros of A and B and its valid products, for
        the rooflines; ``keep`` in X's CSR order, or every entry."""
        m = self.m
        ok = torch.ones(m.nnz, dtype=torch.bool, device=m.row.device) \
            if keep is None else keep[m.csr_pos]
        top = ok & (m.row < m.c_rows)
        per_a = torch.bincount(m.col[top], minlength=m.dim)
        per_b = torch.bincount(m.col[ok], minlength=m.dim)
        return {"nnz_a": int(top.sum()), "nnz_b": int(ok.sum()),
                "products": int((per_a * per_b).sum())}


class Cold(Driver):
    def setup(self) -> None:
        self.m = m = ops.load_matrix(self.cfg, self.dev)
        self.vals = ops.draw_values(m, 1, self.seed)
        pl = ops.planes(m, self.vals)
        self.a_idx, self.a_val = pl.a_idx, pl.a_val[0]
        self.b_idx, self.b_val = pl.b_idx, pl.b_val[0]
        self.products = pl.products
        warm = ops.device_generator(self.seed, "warmup", self.dev)
        for _ in range(int(self.mix["warmup"])):
            a, b, _, _ = self.operands(warm)
            self.call(a, b)
        self.sync()

    def operands(self, g):
        m = self.m
        p = torch.randperm(m.c_rows, generator=g, device=self.dev)
        q = torch.randperm(m.dim, generator=g, device=self.dev)
        a = self.rt.EllRows(val=self.a_val, idx=ops.relabel(self.a_idx, p),
                            n_rows=m.c_rows)
        b = self.rt.EllCols(val=self.b_val, idx=ops.relabel(self.b_idx, q),
                            n_cols=m.dim)
        return a, b, p, q

    def call(self, a, b):
        return self.rt.spgemm(a, b, accumulator="auto")

    def window(self, seconds: float, win) -> None:
        g = ops.device_generator(self.seed, "relabel", self.dev)
        rng = np.random.default_rng(ops.sub_seed(self.seed, "sample"))
        k = int(self.mix["sample"])
        held: List = []
        failed, units, t1 = 0, self.rec["units"], 0.0
        self.sync()
        t_open = time.perf_counter()
        while time.perf_counter() - t_open < seconds:
            win.tick(time.perf_counter() - t_open)
            with _mark("portbench.relabel"):
                a, b, p, q = self.operands(g)
            self.sync()
            t0 = time.perf_counter()
            try:
                with _mark("portbench.call"):
                    c = self.call(a, b)
                    self.sync()
            except RuntimeError as e:          # a call that fails is counted
                print(f"call {len(units)} failed: {e}", flush=True)
                c, failed = None, failed + 1
            t1 = time.perf_counter()
            i = len(units)
            units.append({"ms": (t1 - t0) * 1e3, "pattern": 0})
            win.unit(pattern=0, launched=win.launched())
            if c is not None:
                item = (c, p, q)
                if len(held) < k:
                    held.append(item)
                else:
                    j = int(rng.integers(0, i + 1))
                    if j < k:
                        held[j] = item
            del a, b, c
        win.stop()
        n = len(units)
        self.rec.update(attempted=n, failed=failed, window_s=t1 - t_open,
                        work_flop=2.0 * self.products * (n - failed))
        self.held = held

    def free(self) -> None:
        del self.a_idx, self.b_idx, self.a_val, self.b_val

    def check(self) -> Dict:
        m, readings = self.m, []
        val = self.vals[0][m.csr_pos]
        nnz_c = None
        for c, p, q in self.held:
            blocks = list(product(m.row, m.col, val, dim=m.dim,
                                  c_rows=m.c_rows, p=p, q=q))
            nnz_c = sum(b.key.numel() for b in blocks)
            readings.append(verdict.compare(c.row, c.col, c.val, c.ngroups,
                                            blocks, m.dim))
            del blocks
        self.rec["product_stats"] = {0: dict(self.counts(), nnz_c=nnz_c)}
        self.held = []
        return verdict.merge(readings, self.rec["failed"]), len(readings)


class Serve(Driver):
    def setup(self) -> None:
        mix = self.mix
        self.m = m = ops.load_matrix(self.cfg, self.dev)
        self.vals = ops.draw_values(m, int(mix["value_sets"]), self.seed)
        self.keep = ops.draw_keeps(m, list(mix["drops"]), self.seed)
        self.pl = [ops.planes(m, self.vals, self.keep[i])
                   for i in range(len(mix["drops"]))]
        self.eng = self.rt.ServingEngine(None, None, self.rt.ServeConfig(
            max_batch=int(mix["max_batch"])))
        n_pat = len(self.pl)
        # every pattern's structure, then the widest wave and a lone one
        for batch in ([(i, 0) for i in range(n_pat)],
                      [(i % n_pat, i % self.vals.shape[0])
                       for i in range(int(mix["max_batch"]))], [(0, 1)]):
            for pat, vs in batch:
                self.eng.submit_spgemm(*self.operands(pat, vs))
            self.eng.flush_spgemm()
            self.sync()

    def schedule(self, seconds: float) -> None:
        """Due times, patterns and value sets of the window's requests.
        The gaps and the patterns are one fixed sequence (the quantiles of
        an exponential and equal shares of the patterns, shuffled once by
        ``TRACE_SEED``); the run's seed rotates it to a starting point of
        its own and draws the value sets and the sampled requests."""
        rate = float(self.mix["rate"])
        n = max(1, int(round(rate * seconds)))
        fixed = np.random.default_rng(TRACE_SEED)
        gaps = fixed.permutation(-np.log1p(-(np.arange(n) + 0.5) / n))
        pats = fixed.permutation(np.arange(n) % len(self.pl))
        rng = np.random.default_rng(ops.sub_seed(self.seed, "arrivals"))
        off = int(rng.integers(0, n))
        gaps = np.roll(gaps, -off) * (seconds / gaps.sum())
        self.due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        self.pat = np.roll(pats, -off)
        self.vset = rng.integers(0, self.vals.shape[0], n)
        k = min(n, int(self.mix["sample"]))
        self.sampled = set(rng.choice(n, k, replace=False).tolist())

    def operands(self, pat: int, vs: int):
        pl = self.pl[pat]
        return (self.rt.EllRows(val=pl.a_val[vs], idx=pl.a_idx,
                                n_rows=self.m.c_rows),
                self.rt.EllCols(val=pl.b_val[vs], idx=pl.b_idx,
                                n_cols=self.m.dim))

    def window(self, seconds: float, win) -> None:
        self.schedule(seconds)
        n, due = len(self.due), self.due
        done = [None] * n
        rid_of, held, flush_ms = {}, {}, []
        eng, nxt, cap = self.eng, 0, int(self.mix["max_batch"])
        before = self._engine_counts()
        self.sync()
        t_open = time.perf_counter()
        while True:
            t = time.perf_counter() - t_open
            if t > seconds + LATE_S:
                break
            win.tick(t)
            while nxt < n and due[nxt] <= t and \
                    eng.sparse_batcher.pending() < cap:
                rid = eng.submit_spgemm(*self.operands(self.pat[nxt],
                                                       self.vset[nxt]))
                rid_of[rid] = nxt
                nxt += 1
            if eng.sparse_batcher.pending():
                f0 = time.perf_counter()
                try:
                    with _mark("portbench.flush"):
                        res = eng.flush_spgemm()
                        self.sync()
                except RuntimeError as e:    # its requests never return
                    print(f"flush failed: {e}", flush=True)
                    res = {}
                f1 = time.perf_counter()
                flush_ms.append((f1 - f0) * 1e3)
                # one wave a flush: its requests run the same kernels
                ran = win.launched()
                for rid, coo in res.items():
                    i = rid_of.pop(rid)
                    done[i] = f1 - t_open
                    if i in self.sampled:
                        held[i] = type(coo)(
                            row=coo.row.clone(), col=coo.col.clone(),
                            val=coo.val.clone(), shape=coo.shape,
                            ngroups=coo.ngroups.clone())
                    win.unit(pattern=int(self.pat[i]), launched=ran)
                res = coo = None   # the next flush must not hold these
            elif nxt < n:
                with _mark("portbench.wait"):
                    time.sleep(max(0.0, due[nxt] - t))
            else:
                break
        win.stop()
        ok = [i for i in range(n) if done[i] is not None]
        lat = [(done[i] - due[i]) * 1e3 for i in ok]
        self.rec["units"].extend({"ms": lat[j], "pattern": int(self.pat[i])}
                                 for j, i in enumerate(ok))
        self.rec.update(
            attempted=n, failed=n - len(ok), latency_ms=lat,
            window_s=max(done[i] for i in ok) if ok else float(seconds),
            work_flop=2.0 * sum(self.pl[self.pat[i]].products for i in ok),
            flush_ms=flush_ms, max_batch=int(self.mix["max_batch"]))
        after = self._engine_counts()
        self.rec["engine"] = {k: after[k] - before[k] for k in after}
        self.held = held

    def _engine_counts(self) -> Dict[str, float]:
        return {k: v for k, v in self.eng.stats.items()
                if isinstance(v, (int, float))}

    def free(self) -> None:
        del self.eng, self.pl

    def check(self) -> Dict:
        m, readings = self.m, []
        for i, c in sorted(self.held.items()):
            keep = self.keep[self.pat[i]][m.csr_pos]
            val = self.vals[self.vset[i]][m.csr_pos]
            blocks = product(m.row, m.col, val, dim=m.dim, c_rows=m.c_rows,
                             keep=keep)
            readings.append(verdict.compare(c.row, c.col, c.val, c.ngroups,
                                            blocks, m.dim))
        self.held = {}
        return verdict.merge(readings, self.rec["failed"]), len(readings)

    def pattern_stats(self) -> None:
        """Each pattern's counts for the rooflines, nnz(C) from the
        reference (traced runs only)."""
        m, out = self.m, {}
        val = self.vals[0][m.csr_pos]
        for i, keep in enumerate(self.keep):
            nnz_c = sum(b.key.numel() for b in product(
                m.row, m.col, val, dim=m.dim, c_rows=m.c_rows,
                keep=keep[m.csr_pos]))
            out[i] = dict(self.counts(keep), nnz_c=nnz_c)
        self.rec["product_stats"] = out


KINDS = {"cold": Cold, "serve": Serve}
