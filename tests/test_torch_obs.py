"""repro_torch.obs — tracing, metrics and the roofline join — on the CPU,
ported from ``tests/test_obs.py``, beside the reference's own.

Span nesting (threads included), the Chrome-trace round trip, sanitized
args, a stable metrics snapshot, exactly-once overflow / poison events,
cache stats and the roofline ``frac`` run the port's instrumented entry
points on CPU tensors; the ledger a traced call writes is held against the
one the reference writes on the same operands. The disabled path is held
structurally: ``span`` returns the shared null span and ``sync`` returns its
argument with no ``torch.cuda.synchronize``. The reference's wall-clock
overhead ratio and its jit-trace test have no port counterpart (a ratio of
host timings is unsteady under parallel test workers; the port has no jit).
"""
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as ref_obs
import repro_torch as rt
import repro_torch.obs as obs
from repro.plan import make_plan as ref_make_plan
from repro.core.spgemm import spgemm_coo as ref_spgemm_coo
from repro_torch.core.accumulate import AccumulatorOverflow
from repro_torch.obs import metrics as mt
from repro_torch.obs import trace as tr

from test_torch_spgemm import _int_sparse, _pair


@pytest.fixture(autouse=True)
def _obs_clean():
    """Every test starts and ends with a disabled, empty tracer/registry
    in both packages."""
    for o in (obs, ref_obs):
        o.disable()
        o.reset()
    yield
    for o in (obs, ref_obs):
        o.disable()
        o.reset()


def _operands(n=64, dens=0.08, seed=0):
    rng = np.random.default_rng(seed)
    return _pair(_int_sparse(rng, n, n, dens), _int_sparse(rng, n, n, dens))


@pytest.fixture
def count_syncs(monkeypatch):
    """Count ``torch.cuda.synchronize`` calls (a no-op here)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a))
    return calls


# ------------------------------------------------------------ disabled path


def test_disabled_span_is_shared_singleton(count_syncs):
    """Disabled tracing allocates no trace state: span() hands back one
    module-level null object, sync returns its argument with no device
    synchronization, and an instrumented call records nothing."""
    assert tr.span("anything") is tr.NULL_SPAN
    assert tr.span("other", k=1) is tr.NULL_SPAN
    x = torch.ones(3)
    assert tr.sync(x) is x
    tup = (x, [x], {"k": x})
    assert tr.sync(tup) is tup
    tr.instant("nope", k=1)
    mt.inc("nope")
    mt.observe("nope", 1.0)
    mt.record_plan("fp", "sort", {"cost_sort": 1.0})
    (_, _), (ta, tb) = _operands()
    rt.spgemm(ta, tb, out_cap=2048, accumulator="sort")
    rt.spgemm(ta, tb, accumulator="auto")
    rt.StructureCache().get(ta, tb)
    assert count_syncs == []
    snap = obs.snapshot()
    assert snap["trace"]["events"] == []
    assert snap["metrics"]["counters"] == {}
    assert snap["metrics"]["planner"] == {}


def test_enabled_sync_skips_cpu_tensors(count_syncs):
    """Enabled, ``sync`` waits only for CUDA devices: CPU tensors (in
    tuples, lists, dicts and dataclass fields such as ``Coo``'s) need
    none."""
    obs.enable(reset=True)
    (_, _), (ta, tb) = _operands()
    coo = rt.spgemm(ta, tb, accumulator="sort")
    assert tr.sync((coo, [ta], {"b": tb})) is not None
    assert count_syncs == []


# ------------------------------------------------------------------ nesting


def test_enabled_spans_nest():
    obs.enable(reset=True)
    with tr.span("outer", k=1):
        with tr.span("inner"):
            pass
    by_name = {e["name"]: e for e in tr.get_tracer().spans()}
    assert by_name["inner"]["parent"] == "outer"
    assert by_name["inner"]["depth"] == 1
    assert by_name["outer"]["parent"] is None
    assert by_name["outer"]["depth"] == 0
    o, i = by_name["outer"], by_name["inner"]
    assert o["ts_us"] <= i["ts_us"]
    assert i["ts_us"] + i["dur_us"] <= o["ts_us"] + o["dur_us"] + 1e-6


def test_spans_nest_across_threads():
    obs.enable(reset=True)
    both = threading.Barrier(2, timeout=30)   # both threads alive at once

    def work(tag):
        with tr.span(f"outer-{tag}"):
            with tr.span(f"inner-{tag}"):
                both.wait()
                time.sleep(0.002)

    ts = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    evs = tr.get_tracer().spans()
    for i in range(2):
        inner = next(e for e in evs if e["name"] == f"inner-{i}")
        outer = next(e for e in evs if e["name"] == f"outer-{i}")
        assert inner["parent"] == f"outer-{i}"      # never the other thread's
        assert inner["depth"] == 1 and outer["depth"] == 0
        assert inner["tid"] == outer["tid"]
    assert len({e["tid"] for e in evs}) == 2
    assert tr._stack.get() == ()


def test_auto_call_records_planner_spans():
    """One traced 'auto' call: the symbolic pass, the decision, the
    multiply and the accumulation, nested as the reference nests them."""
    obs.enable(reset=True)
    (_, _), (ta, tb) = _operands()
    rt.spgemm(ta, tb, accumulator="auto")
    evs = tr.get_tracer().snapshot()["events"]
    names = [e["name"] for e in evs]
    for want in ("spgemm.symbolic", "plan.decision", "spgemm.multiply",
                 "spgemm.accumulate"):
        assert names.count(want) == 1, (want, names)
    dec = next(e for e in evs if e["name"] == "plan.decision")
    acc = next(e for e in evs if e["name"] == "spgemm.accumulate")
    assert dec["ph"] == "i" and dec["args"]["pinned"] is False
    assert acc["args"]["backend"] == dec["args"]["backend"]
    assert acc["args"]["nnz"] > 0


# ------------------------------------------------------------------- export


def test_chrome_export_roundtrip(tmp_path):
    (_, _), (ta, tb) = _operands()
    plan = rt.make_plan(ta, tb)         # planner spans stay out of the trace
    obs.enable(reset=True)
    with tr.span("test.root"):
        rt.spgemm(ta, tb, out_cap=plan.out_cap, accumulator="sort",
                  plan=plan)
    path = tmp_path / "trace.json"
    obs.export_chrome(str(path), extra={"metrics": mt.snapshot()})
    doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    assert evs and isinstance(evs, list)
    for e in evs:
        assert set(e) >= {"name", "cat", "ph", "ts", "dur", "pid", "tid",
                          "args"}
        assert e["ts"] >= 0 and e["dur"] >= 0
    root = next(e for e in evs if e["name"] == "test.root")
    for e in evs:
        if e is root:
            continue
        assert root["ts"] <= e["ts"] + 1e-6
        assert e["ts"] + e["dur"] <= root["ts"] + root["dur"] + 1e-6
    acc = next(e for e in evs if e["name"] == "spgemm.accumulate")
    assert acc["args"]["backend"] == "sort"
    assert acc["args"]["nnz"] > 0
    assert "planner" in doc["metrics"]


def test_trace_args_never_carry_matrix_values():
    obs.enable(reset=True)
    v = torch.tensor([3.14159, 2.71828], dtype=torch.float32)
    w = np.array([[1.5, 2.5]], np.float64)
    with tr.span("s", data=v, host=w, n=4, tag="x", nnz=torch.tensor(7)) \
            as sp:
        sp.set(later=v)
    (e,) = tr.get_tracer().spans()
    assert e["args"]["n"] == 4 and e["args"]["tag"] == "x"
    assert e["args"]["nnz"] == 7                     # a scalar passes
    assert e["args"]["data"] == "<float32(2,)>"      # shape/dtype only
    assert e["args"]["later"] == "<float32(2,)>"
    assert e["args"]["host"] == "<float64(1, 2)>"


def test_metrics_snapshot_stable_across_identical_runs():
    def run():
        obs.enable(reset=True)
        (_, _), (ta, tb) = _operands()
        plan = rt.make_plan(ta, tb)
        rt.spgemm(ta, tb, out_cap=plan.out_cap, accumulator=plan.backend,
                  plan=plan)
        snap = mt.snapshot()
        obs.disable()
        obs.reset()
        return snap

    s1, s2 = run(), run()
    assert s1["counters"] == s2["counters"]
    assert set(s1["planner"]) == set(s2["planner"])
    for k in s1["planner"]:
        assert s1["planner"][k]["backend"] == s2["planner"][k]["backend"]
        assert s1["planner"][k]["est"] == s2["planner"][k]["est"]


def test_planner_ledger_matches_reference():
    """The ledger one traced plan-and-multiply writes: the same key (the
    fingerprint), backend, modeled costs and counters as the reference's on
    the same operands; both record one measured accumulate."""
    (ea, eb), (ta, tb) = _operands()
    obs.enable(reset=True)
    ref_obs.enable(reset=True)
    plan = rt.make_plan(ta, tb)
    rt.spgemm(ta, tb, plan=plan)
    rplan = ref_make_plan(ea, eb)
    ref_spgemm_coo(ea, eb, plan=rplan)
    got, want = mt.snapshot(), ref_obs.metrics.snapshot()
    assert got["counters"] == want["counters"]
    assert got["planner"].keys() == want["planner"].keys()
    for k, ent in got["planner"].items():
        ref = want["planner"][k]
        assert ent["backend"] == ref["backend"]
        assert ent["est"].keys() == ref["est"].keys()
        for name, v in ent["est"].items():
            assert v == pytest.approx(ref["est"][name], rel=1e-12)
        assert ent["measured_us"].keys() == ref["measured_us"].keys()


# ---------------------------------------------------------- poison/overflow


def test_overflow_event_increments_exactly_once_per_call():
    obs.enable(reset=True)
    (_, _), (ta, tb) = _operands()
    for expected in (1, 2):
        with pytest.raises(AccumulatorOverflow):
            rt.spgemm(ta, tb, out_cap=4, accumulator="sort", check=True)
        assert mt.snapshot()["counters"]["spgemm.overflow_events"] == expected
    instants = [e for e in tr.get_tracer().snapshot()["events"]
                if e["name"] == "spgemm.overflow"]
    assert len(instants) == 2


def test_poison_event_increments_exactly_once_per_call():
    from repro_torch.core.spgemm import accumulate_stream
    obs.enable(reset=True)
    rng = np.random.default_rng(3)
    n_rows = n_cols = 32
    m = 256
    row = torch.from_numpy(rng.integers(0, n_rows, m).astype(np.int32))
    col = torch.from_numpy(rng.integers(0, n_cols, m).astype(np.int32))
    val = torch.from_numpy(rng.standard_normal(m).astype(np.float32))
    # one 8-slot table for ~hundreds of distinct keys: guaranteed drops
    plan = rt.Plan(backend="hash", out_cap=1024, n_blocks=1, block_cap=8,
                   max_probes=2)
    for expected in (1, 2):
        coo = accumulate_stream(row, col, val, 1024, n_rows, n_cols,
                                backend="hash", plan=plan)
        assert int(coo.ngroups) > 1024              # poisoned past cap
        assert mt.snapshot()["counters"]["spgemm.poison_events"] == expected
    instants = [e for e in tr.get_tracer().snapshot()["events"]
                if e["name"] == "spgemm.poison"]
    assert len(instants) == 2


def test_numeric_miss_poison_event_exactly_once_per_call():
    """A stale structure (validate=False) makes the numeric phase drop the
    unknown products into the dump slots: one poison counter increment and
    one instant per call, never per miss; the histogram counts the calls."""
    (_, _), (ta1, tb1) = _operands(dens=0.05, seed=1)
    st = rt.make_structure(ta1, tb1, backend="sort")
    (_, _), (ta2, tb2) = _operands(dens=0.3, seed=2)
    obs.enable(reset=True)
    for expected in (1, 2):
        coo = rt.spgemm(ta2, tb2, structure=st, validate=False)
        assert int(coo.ngroups) > st.out_cap        # poisoned past cap
        assert mt.snapshot()["counters"]["spgemm.poison_events"] == expected
    instants = [e for e in tr.get_tracer().snapshot()["events"]
                if e["name"] == "spgemm.poison"]
    assert len(instants) == 2
    assert mt.snapshot()["histograms"]["numeric_us.sort"]["count"] == 2


# ----------------------------------------------------------- cache/spmm side


def test_structure_cache_stats_snapshot():
    (_, _), (ta, tb) = _operands()
    cache = rt.StructureCache(capacity=4)
    obs.enable(reset=True)
    cache.get(ta, tb)
    cache.get(ta, tb)
    s = cache.stats()
    assert s["misses"] == 1 and s["hits"] == 1 and s["size"] == 1
    assert s["autotuned"] == 0
    s["hits"] = 999                                  # a copy, not a view
    assert cache.stats()["hits"] == 1
    c = mt.snapshot()["counters"]
    assert c["structure_cache.misses"] == 1 and c["structure_cache.hits"] == 1
    names = [e["name"] for e in tr.get_tracer().spans()]
    assert names.count("structure_cache.build") == 1
    assert names.count("structure.build") == 1


def test_sparse_layer_spans_and_counters():
    """The SpMM side's instrumentation: an apply counter by format and a
    span per dense apply, the MLP and matmul_sparse spans."""
    rng = np.random.default_rng(4)
    w_in = torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32))
    w_out = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    mlp = rt.SparseMLP(w_in, w_out, 0.5, nm=(2, 4), device="cpu")
    lin = rt.SparseLinear(w_in, 0.9, nm=None, device="cpu")
    x = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    (_, _), (a, _) = _pair(_int_sparse(rng, 8, 16, 0.3),
                           _int_sparse(rng, 16, 8, 0.3))
    obs.enable(reset=True)
    mlp(x)
    lin(x)
    lin.matmul_sparse(a)
    c = mt.snapshot()["counters"]
    assert c["sparse_linear.apply_nm"] == 2
    assert c["sparse_linear.apply_ellpack"] == 1
    spans = tr.get_tracer().spans()
    names = [e["name"] for e in spans]
    assert names.count("sparse_mlp.apply") == 1
    assert names.count("sparse_linear.spmm") == 3
    assert names.count("sparse_linear.matmul_sparse") == 1
    nm = [e for e in spans if e["name"] == "sparse_linear.spmm"
          and e["args"]["fmt"] == "nm"]
    assert all(e["parent"] == "sparse_mlp.apply" for e in nm)


# ----------------------------------------------------------------- roofline


def test_roofline_fractions_in_gate_range():
    from repro_torch.obs import roofline as rl
    (_, _), (ta, tb) = _operands()
    res = rl.measure_roofline(ta, tb, backends=("sort", "stream"), iters=1)
    assert set(res) == {"sort", "stream"}
    for r in res.values():
        assert 0.0 < r["frac"] <= 1.5
        assert r["modeled_bytes"] > 0 and r["us"] > 0
    assert not obs.is_enabled()                     # tracer state restored
    spans = tr.get_tracer().spans("roofline.measure")
    assert [e["args"]["backend"] for e in spans] == ["sort", "stream"]


def test_modeled_bytes_matches_reference():
    from repro.obs.roofline import modeled_bytes as ref_bytes
    from repro_torch.obs.roofline import modeled_bytes
    (ea, eb), (ta, tb) = _operands()
    plan, rplan = rt.make_plan(ta, tb), ref_make_plan(ea, eb)
    for bk in rt.plan.planner.BACKENDS:
        assert modeled_bytes(plan, bk, nnz_a=100, nnz_b=90) == \
            pytest.approx(ref_bytes(rplan, bk, nnz_a=100, nnz_b=90),
                          rel=1e-12)


def test_reference_bw_defaults_to_the_port_device():
    """With no ``device`` the anchor measures the port's device (CUDA), so
    without a card it raises instead of timing the host; the CPU is
    measured only when asked for."""
    from repro_torch.obs.roofline import measure_reference_bw
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card default is checked here")
    with pytest.raises(RuntimeError, match="CUDA"):
        measure_reference_bw(elems=1024, iters=1)
    assert measure_reference_bw(elems=1024, iters=1, device="cpu") > 0
