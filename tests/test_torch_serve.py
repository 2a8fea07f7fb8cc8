"""repro_torch.serve against the JAX reference: the six tests of
``tests/test_serve_spgemm.py`` on the port, and the two batchers side by
side on the same numpy requests. Values are integers, so every result is
compared bit for bit (its first ``ngroups`` entries, as the reference's own
test does); ``spgemm_queue_s``/``spgemm_compute_s`` are host-clock times and
are only required to be positive."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import repro.serve as ref_serve
import repro_torch as rt
from repro.core import formats as ref_formats
from repro.plan import StructureCache as RefCache
from repro_torch.core.spgemm import spgemm_coo_numeric
from repro_torch.plan import StructureCache
from repro_torch.serve import (ServeConfig, ServingEngine, SparseGemmBatcher,
                               SparseGemmRequest)
from repro_torch.serve.engine import EngineStats

COUNTERS = ("spgemm_requests", "spgemm_waves", "spgemm_batched_waves",
            "spgemm_occupancy_sum")


def _dense_pair(seed, n=32, k=6):
    """``tests/test_serve_spgemm.py``'s operands as numpy: the same slab
    widths across seeds, so requests share a shape signature."""
    r = np.random.default_rng(seed)
    A = np.zeros((n, n), np.float32)
    B = np.zeros((n, n), np.float32)
    for i in range(n):
        cols = r.choice(n, size=r.integers(1, k + 1), replace=False)
        A[i, cols] = r.integers(1, 5, cols.size)
        rows = r.choice(n, size=r.integers(1, k + 1), replace=False)
        B[rows, i] = r.integers(1, 5, rows.size)
    return A, B, k


def _port(A, B, k):
    return (rt.ell_rows_from_dense(A, k, device="cpu"),
            rt.ell_cols_from_dense(B, k, device="cpu"))


def _ref(A, B, k):
    return (ref_formats.ell_rows_from_dense(jnp.asarray(A), k),
            ref_formats.ell_cols_from_dense(jnp.asarray(B), k))


def _pair(seed, n=32, k=6):
    return _port(*_dense_pair(seed, n, k))


def _thinned(seed, drop):
    """``_dense_pair(seed)`` with ``drop`` of A's non-zeros removed: the same
    slab width, another pattern and another nnz(C)."""
    A, B, k = _dense_pair(seed)
    r, c = np.nonzero(A)
    pick = np.random.default_rng(seed + 1).choice(r.size, drop, replace=False)
    A = A.copy()
    A[r[pick], c[pick]] = 0
    return A, B, k


def _assert_same(got, ref):
    n = int(ref.ngroups)
    assert int(got.ngroups) == n
    for f in ("row", "col", "val"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)[:n]),
                                      np.asarray(getattr(ref, f)[:n]))


def _lone(cache, a, b):
    return spgemm_coo_numeric(a, b, cache.get(a, b), validate=False)


# -- the reference's six tests, on the port ----------------------------------

def test_batched_waves_bit_match_unbatched_numeric():
    cache = StructureCache(capacity=16)
    stats = {}
    bt = SparseGemmBatcher(cache, max_slots=4, stats=stats)
    pairs = {bt.submit(a, b): (a, b)
             for a, b in (_pair(s) for s in range(6))}
    assert bt.pending() == 6
    res = bt.flush()
    assert bt.pending() == 0 and set(res) == set(pairs)
    for rid, (a, b) in pairs.items():
        _assert_same(res[rid], _lone(cache, a, b))
    # 6 same-shape requests, 4 slots -> one full wave + one 2-slot wave
    assert stats["spgemm_requests"] == 6
    assert stats["spgemm_waves"] == 2
    assert stats["spgemm_batched_waves"] == 2
    assert abs(stats["spgemm_occupancy_sum"] - 1.5) < 1e-9
    assert stats["spgemm_compute_s"] > 0


def test_heterogeneous_shapes_group_separately():
    cache = StructureCache(capacity=16)
    stats = {}
    bt = SparseGemmBatcher(cache, max_slots=4, stats=stats)
    big = [_pair(s, n=32, k=6) for s in range(2)]
    small = [_pair(100 + s, n=16, k=4) for s in range(3)]
    rids = {bt.submit(a, b): (a, b) for a, b in big + small}
    res = bt.flush()
    for rid, (a, b) in rids.items():
        _assert_same(res[rid], _lone(cache, a, b))
    # one wave per shape group — shapes never mix inside a wave
    assert stats["spgemm_waves"] == 2 and stats["spgemm_batched_waves"] == 2


def test_singleton_wave_skips_batch_machinery():
    cache = StructureCache(capacity=4)
    stats = {}
    bt = SparseGemmBatcher(cache, max_slots=4, stats=stats)
    a, b = _pair(0)
    rid = bt.submit(a, b)
    res = bt.flush()
    _assert_same(res[rid], _lone(cache, a, b))
    assert stats["spgemm_waves"] == 1
    assert stats["spgemm_batched_waves"] == 0


def test_structures_recycled_across_flushes():
    cache = StructureCache(capacity=16)
    bt = SparseGemmBatcher(cache, max_slots=4)
    pairs = [_pair(s) for s in range(3)]
    for a, b in pairs:
        bt.submit(a, b)
    bt.flush()
    miss0 = cache.stats()["misses"]
    for a, b in pairs:                    # same patterns: hits only
        bt.submit(a, b)
    bt.flush()
    s = cache.stats()
    assert s["misses"] == miss0
    assert s["hits"] >= len(pairs)


def test_request_dataclass_and_rids_monotonic():
    bt = SparseGemmBatcher(StructureCache(capacity=2), max_slots=2)
    a, b = _pair(1)
    rids = [bt.submit(a, b) for _ in range(3)]
    assert rids == sorted(rids) and len(set(rids)) == 3
    assert all(isinstance(r, SparseGemmRequest) for r in bt._pending)


class _Stub:
    def prefill(self, *a, **k):
        raise NotImplementedError

    def decode_step(self, *a, **k):
        raise NotImplementedError


def test_engine_submit_flush_and_stats_snapshot():
    eng = ServingEngine(_Stub(), None, ServeConfig(max_batch=4))
    a, b = _pair(2)
    r1 = eng.submit_spgemm(a, b)
    r2 = eng.submit_spgemm(a, b)
    out = eng.flush_spgemm()
    assert set(out) == {r1, r2}
    ref = eng.spgemm(a, b)                # cache-backed one-shot path
    _assert_same(out[r1], ref)
    snap = eng.stats()
    assert snap["spgemm_requests"] == 2
    assert snap["spgemm_waves"] == 1 and snap["spgemm_batched_waves"] == 1
    assert 0.0 < snap["spgemm_occupancy"] <= 1.0
    assert snap["spgemm_latency_s_per_request"] > 0
    # batcher shares the engine's structure cache
    assert snap["structure_cache"]["hits"] >= 1
    assert eng.cache_stats() == snap["structure_cache"]


# -- the port against the reference --------------------------------------------

def _both(requests, *, max_slots=4, **flush_kw):
    """The reference's batcher and the port's on the same numpy requests:
    (ref results, port results, ref stats, port stats, ref cache, cache)."""
    rcache, tcache = RefCache(capacity=16), StructureCache(capacity=16)
    rstats, tstats = {}, {}
    rb = ref_serve.SparseGemmBatcher(rcache, max_slots=max_slots,
                                     stats=rstats)
    tb = SparseGemmBatcher(tcache, max_slots=max_slots, stats=tstats)
    for req in requests:
        assert rb.submit(*_ref(*req)) == tb.submit(*_port(*req))
    return rb.flush(**flush_kw), tb.flush(**flush_kw), rstats, tstats, \
        rcache, tcache


def _assert_parity(rres, tres, rstats, tstats, rcache, tcache):
    assert set(rres) == set(tres)
    for rid in rres:
        _assert_same(tres[rid], rres[rid])
        assert tres[rid].cap == rres[rid].row.shape[-1]
        assert tres[rid].shape == tuple(rres[rid].shape)
    for k in COUNTERS:
        assert tstats[k] == rstats[k], k
    assert tstats["spgemm_queue_s"] > 0 and tstats["spgemm_compute_s"] > 0
    for k in ("hits", "misses"):
        assert tcache.stats()[k] == rcache.stats()[k], k


def test_batcher_parity_with_reference():
    """Two shape groups, a full wave, a part wave and a singleton, then the
    same patterns again (cache hits) with fresh values."""
    reqs = [_dense_pair(s) for s in range(6)] + \
        [_dense_pair(100 + s, n=16, k=4) for s in range(3)] + \
        [_dense_pair(200, n=24, k=5)]
    _assert_parity(*_both(reqs))
    again = [(2 * A, 3 * B, k) for A, B, k in reqs[:5]]
    _assert_parity(*_both(reqs[:5] + again))


def test_wave_of_patterns_with_different_out_caps():
    """One wave, three patterns of one shape whose structures differ in
    out_cap: key planes padded with KEY_INVALID to the widest."""
    reqs = [_dense_pair(3), _thinned(3, 20), _thinned(3, 80)]
    rres, tres, *rest = _both(reqs)
    _assert_parity(rres, tres, *rest)
    tcache = rest[-1]
    ports = [_port(*r) for r in reqs]
    caps = {tcache.get(a, b).out_cap for a, b in ports}
    assert len(caps) == 3
    for rid, (a, b) in enumerate(ports):
        assert tres[rid].cap == max(caps)
        _assert_same(tres[rid], _lone(tcache, a, b))
    assert rest[1]["spgemm_batched_waves"] == 1


@pytest.mark.parametrize("n_req", [1, 3])
def test_pinned_stream_backend_through_flush(n_req):
    """``flush(backend='stream')``: a singleton wave honours the structure's
    'stream' plan (the numeric phase by slab groups); a batched wave's
    numeric phase ignores the plan. Both equal the reference's and the
    'sort' structures' results."""
    reqs = [_dense_pair(10 + s) for s in range(n_req)]
    rres, tres, rstats, tstats, rcache, tcache = _both(reqs,
                                                       backend="stream")
    _assert_parity(rres, tres, rstats, tstats, rcache, tcache)
    sort_cache = StructureCache(capacity=4)
    for rid, req in enumerate(reqs):
        a, b = _port(*req)
        assert tcache.get(a, b).plan.backend == "stream"
        _assert_same(tres[rid], spgemm_coo_numeric(
            a, b, sort_cache.get(a, b, backend="sort"), validate=False))
    assert tstats["spgemm_batched_waves"] == (n_req > 1)


def test_serve_config_fields_match_reference():
    got = [(f.name, f.default) for f in dataclasses.fields(ServeConfig)]
    want = [(f.name, f.default)
            for f in dataclasses.fields(ref_serve.ServeConfig)]
    assert got == want


def test_stats_snapshot_keys_match_reference():
    cfg = dict(max_batch=2)
    reng = ref_serve.ServingEngine(_Stub(), None, ref_serve.ServeConfig(**cfg))
    teng = ServingEngine(_Stub(), None, ServeConfig(**cfg))
    A, B, k = _dense_pair(4)
    reng.spgemm(*_ref(A, B, k))
    teng.spgemm(*_port(A, B, k))
    rsnap, tsnap = reng.stats(), teng.stats()
    assert isinstance(teng.stats, EngineStats)
    assert set(tsnap) == set(rsnap)
    assert set(tsnap["structure_cache"]) == set(rsnap["structure_cache"])
    assert tsnap["structure_cache"] == rsnap["structure_cache"]


def test_engine_cache_dir_warm_starts(tmp_path):
    """``structure_cache_dir`` reaches the engine's cache: a second engine
    on the same directory finds the structure on disk."""
    cfg = ServeConfig(structure_cache_dir=str(tmp_path))
    a, b = _pair(5)
    first = ServingEngine(None, None, cfg).spgemm(a, b)
    eng = ServingEngine(None, None, cfg)
    _assert_same(eng.spgemm(a, b), first)
    assert eng.cache_stats()["disk_hits"] == 1
    assert eng.cache_stats()["misses"] == 0


class _Echo:
    """A model whose prefill picks token 5 for every row and whose decode
    step picks the token after the one it was given (EOS after 9)."""
    vocab = 16

    def prefill(self, params, batch, s_max):
        b = batch["tokens"].shape[0]
        return torch.zeros(b, self.vocab).index_fill_(1, torch.tensor(5),
                                                      1.0), {"pos": 0}

    def decode_step(self, params, cache, tokens):
        nxt = torch.where(tokens[:, 0] >= 9, 2, tokens[:, 0] + 1)
        return torch.nn.functional.one_hot(nxt.long(), self.vocab).float(), \
            {"pos": cache["pos"] + 1}


def test_generate_batch_is_not_ported():
    """Token serving, once refused, now runs: a wave of two prompts
    decodes until EOS, with the reference's counters."""
    eng = ServingEngine(_Echo(), {"w": torch.zeros(1)}, ServeConfig())
    assert eng.params["w"].shape == (1,)
    outs = eng.generate_batch([np.array([1, 2, 3], np.int32),
                               np.array([4], np.int32)])
    assert outs == [[5, 6, 7, 8, 9, 2]] * 2
    st = eng.stats()
    assert (st["requests"], st["tokens"], st["decode_steps"]) == (2, 12, 5)
    assert st["batch_occupancy"] == 2 / ServeConfig().max_batch
