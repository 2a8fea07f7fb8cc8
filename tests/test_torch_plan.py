"""repro_torch's backend selection against the JAX reference on the CPU.

The same numpy operands go through ``repro.plan.make_plan`` and
``repro_torch.plan.make_plan`` with ``backend=None``: on CPU tensors the port
keeps the reference's off-TPU cost table, so every field of the plan is
equal, ``est`` to 1e-12 relative and ``stats`` exactly but for σ (float32
sums in another order; 1e-6). ``hwmodel``'s statistics and the paper's
latency/energy models equal the reference's. ``accumulator='auto'``,
``make_structure(_batched)(backend=None)`` and ``matmul_sparse`` without a
backend equal the reference bit for bit on integer operands. The measured
autotune picks among its candidates, records each probe, and drops only a
backend whose planning raises ``ValueError``. The CUDA table, fed the
statistics and sizes of bcsstk32 A·Aᵀ that ``chip_smoke.py`` printed on the
H100, picks the backend the card measured fastest.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import scipy.sparse as sps

import repro_torch as rt
from repro.core import hwmodel as ref_hw
from repro.core import spgemm_coo, spgemm_coo_batched
from repro.core.formats import EllCols, EllRows
from repro.core.spgemm import spgemm_coo_numeric as ref_numeric
from repro.core.spgemm import spgemm_coo_numeric_batched as ref_numeric_b
from repro.plan import make_plan as ref_make_plan
from repro.plan import make_structure as ref_make_structure
from repro.plan import make_structure_batched as ref_make_structure_batched
from repro_torch.core import hwmodel
from repro_torch.core import spgemm as tsp
from repro_torch.plan import make_plan, planner

from test_torch_spgemm import ZOO, _int_sparse, _pair, _same_coo

BACKENDS = planner.BACKENDS


def _same_plan(got, want):
    """Every field equal; ``est`` to 1e-12 relative, ``stats`` exact but
    for σ."""
    for f in dataclasses.fields(planner.Plan):
        if f.name not in ("est", "stats"):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.est.keys() == want.est.keys()
    for k, v in got.est.items():
        assert math.isclose(v, want.est[k], rel_tol=1e-12), (k, v, want.est[k])
    if want.stats is None:
        assert got.stats is None
        return
    _same_stats(got.stats, want.stats)


def _same_stats(got, want, skip=()):
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    for k in ("sigma", *skip):
        g.pop(k), w.pop(k)
    assert g == w
    assert math.isclose(got.sigma, want.sigma, rel_tol=1e-6, abs_tol=1e-6)


def _oversized():
    """A (50,000 × 12) · (12 × 50,000) product: 2.5·10⁹ output
    coordinates, past the 2³¹−1 packed-key space."""
    rng = np.random.default_rng(11)
    n_big, n, k = 50_000, 12, 2
    a_idx = rng.integers(-1, n_big, (k, n)).astype(np.int32)
    b_idx = rng.integers(-1, n_big, (n, k)).astype(np.int32)
    a_val = np.where(a_idx >= 0, rng.integers(1, 5, (k, n)), 0).astype(
        np.float32)
    b_val = np.where(b_idx >= 0, rng.integers(1, 5, (n, k)), 0).astype(
        np.float32)
    ref = (EllRows(jnp.asarray(a_val), jnp.asarray(a_idx), n_big),
           EllCols(jnp.asarray(b_val), jnp.asarray(b_idx), n_big))
    port = (rt.from_numpy(a_val, a_idx, n_rows=n_big, device="cpu"),
            rt.from_numpy(b_val, b_idx, n_cols=n_big, device="cpu"))
    return ref, port


# ---------------------------------------------------------------------------
# make_plan(backend=None) on the CPU equals the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [{}, dict(mem_budget=4096),
                                    dict(slack=1.5, tile=1024)],
                         ids=["default", "budget", "slack"])
@pytest.mark.parametrize("case", sorted(ZOO))
def test_make_plan_selection_matches_reference(case, kwargs):
    a, b, k = ZOO[case]
    (ea, eb), (ta, tb) = _pair(a, b, k)
    got, want = make_plan(ta, tb, **kwargs), ref_make_plan(ea, eb, **kwargs)
    _same_plan(got, want)
    assert got.est["mem_budget"] == kwargs.get("mem_budget", 1 << 30)
    if "mem_budget" in kwargs and case != "empty":   # the override fires
        assert got.backend == "stream"


def test_make_plan_oversized_space_matches_reference():
    (ea, eb), (ta, tb) = _oversized()
    got, want = make_plan(ta, tb), ref_make_plan(ea, eb)
    _same_plan(got, want)
    assert got.backend == "sort"
    with pytest.raises(ValueError, match="packed int32"):
        make_plan(ta, tb, backend="bucket")
    _same_coo(rt.spgemm(ta, tb, accumulator="auto"),
              spgemm_coo(ea, eb, accumulator="auto"))


def test_plan_costs_rescore_the_plan():
    """``plan_costs`` on a selected plan gives back its ``est``."""
    (_, _), (ta, tb) = _pair(*ZOO["skewed"][:2])
    plan = make_plan(ta, tb)
    costs, interm = planner.plan_costs(plan, ta.k, ta.n_cols, tb.k,
                                       planner.CPU_COSTS)
    assert {f"cost_{b}": c for b, c in costs.items()} == \
        {k: v for k, v in plan.est.items() if k.startswith("cost_")}
    assert {f"interm_{b}": c for b, c in interm.items()} == \
        {k: v for k, v in plan.est.items() if k.startswith("interm_")}


def test_default_mem_budget_per_device(monkeypatch):
    """The CPU keeps the reference's 1 GiB; CUDA takes CUDA_MEM_SHARE of
    the card's memory, read from its properties."""
    assert planner.default_mem_budget(torch.device("cpu")) == 1 << 30

    class Props:
        total_memory = 80 * 2**30

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props)
    assert planner.default_mem_budget(torch.device("cuda")) == \
        int(80 * 2**30 * planner.CUDA_MEM_SHARE)
    assert planner.cost_table(torch.device("cuda")) is planner.CUDA_COSTS
    assert planner.cost_table(torch.device("cpu")) is planner.CPU_COSTS


# ---------------------------------------------------------------------------
# hwmodel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(ZOO))
def test_stats_from_ell_matches_reference(case):
    a, b, k = ZOO[case]
    (ea, eb), (ta, tb) = _pair(a, b, k)
    for nnz_c in (None, 77):
        _same_stats(hwmodel.stats_from_ell(ta, tb, nnz_c=nnz_c),
                    ref_hw.stats_from_ell(ea, eb, nnz_c=nnz_c))
    # scipy's stats size k by the hybrid rule, not the ELLPACK width, and
    # take n from A's rows (square operands), not the larger side
    sa, sb = sps.csr_matrix(a), sps.csr_matrix(b)
    got = hwmodel.stats_from_ell(ta, tb, nnz_c=(sa @ sb).nnz)
    skip = ("k_a", "k_b") + (() if a.shape[0] == b.shape[1] else ("n",))
    for fn in (hwmodel.stats_from_scipy, ref_hw.stats_from_scipy):
        _same_stats(got, fn(sa, sb), skip=skip)


def test_splim_models_match_reference():
    stats = [hwmodel.stats_from_ell(*_pair(a, b, k)[1])
             for a, b, k in ZOO.values()]
    stats = [s for s in stats if s.nnz_a]
    for s in stats:
        r = ref_hw.MatrixStats(**dataclasses.asdict(s))
        assert hwmodel.splim_latency(s) == ref_hw.splim_latency(r)
        assert hwmodel.splim_energy(s) == ref_hw.splim_energy(r)
        assert hwmodel.coo_splim_latency(s) == ref_hw.coo_splim_latency(r)
        assert hwmodel.coo_splim_energy(s) == ref_hw.coo_splim_energy(r)
        for name in ("gpu_latency", "gpu_energy", "sam_latency",
                     "spacea_latency", "spacea_energy", "reflip_latency",
                     "reflip_energy"):
            assert getattr(hwmodel, name)(s) == getattr(ref_hw, name)(r)
    assert hwmodel.calibrate(stats) == ref_hw.calibrate(
        [ref_hw.MatrixStats(**dataclasses.asdict(s)) for s in stats])


# ---------------------------------------------------------------------------
# 'auto' on integer operands equals the reference bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["square", "skewed", "padding_heavy"])
def test_auto_spgemm_matches_reference(case):
    a, b, k = ZOO[case]
    (ea, eb), (ta, tb) = _pair(a, b, k)
    _same_coo(rt.spgemm(ta, tb, accumulator="auto"),
              spgemm_coo(ea, eb, accumulator="auto"))
    cap = 8 * 128                      # a given cap: only the backend is planned
    _same_coo(rt.spgemm(ta, tb, out_cap=cap, accumulator="auto", check=True),
              spgemm_coo(ea, eb, out_cap=cap, accumulator="auto"))


def test_make_structure_auto_matches_reference():
    a, b, k = ZOO["skewed"]
    (ea, eb), (ta, tb) = _pair(a, b, k)
    st = rt.make_structure(ta, tb)
    ref = ref_make_structure(ea, eb)
    _same_plan(st.plan, ref.plan)
    for f in ("key", "row_nnz", "seg", "nnz"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    _same_coo(rt.spgemm(ta, tb, structure=st), ref_numeric(ea, eb, ref))


def test_make_structure_batched_auto_matches_reference():
    from repro.core import ell_cols_from_dense, ell_rows_from_dense
    rng = np.random.default_rng(5)
    mats = [(_int_sparse(rng, 24, 20, 0.2), _int_sparse(rng, 20, 28, 0.2))
            for _ in range(3)]
    k_a = max(int((a != 0).sum(0).max()) for a, _ in mats)
    k_b = max(int((b != 0).sum(1).max()) for _, b in mats)
    ra = [ell_rows_from_dense(jnp.array(a), k_a) for a, _ in mats]
    rb = [ell_cols_from_dense(jnp.array(b), k_b) for _, b in mats]
    ea = EllRows(jnp.stack([x.val for x in ra]),
                 jnp.stack([x.idx for x in ra]), 24)
    eb = EllCols(jnp.stack([x.val for x in rb]),
                 jnp.stack([x.idx for x in rb]), 28)
    ta = rt.EllRows(torch.from_numpy(np.asarray(ea.val)),
                    torch.from_numpy(np.asarray(ea.idx)), 24)
    tb = rt.EllCols(torch.from_numpy(np.asarray(eb.val)),
                    torch.from_numpy(np.asarray(eb.idx)), 28)
    st = rt.make_structure_batched(ta, tb)
    ref = ref_make_structure_batched(ea, eb)
    _same_plan(st.plan, ref.plan)
    for f in ("key", "row_nnz", "seg", "nnz"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    warm = rt.spgemm(ta, tb, structure=st)
    _same_coo(warm, ref_numeric_b(ea, eb, ref))
    # a plan selected on one slice, sized for the widest, feeds the batched
    # cold path; on integer operands it equals the warm result
    plan = make_plan(rt.EllRows(ta.val[0], ta.idx[0], 24),
                     rt.EllCols(tb.val[0], tb.idx[0], 28))
    plan = dataclasses.replace(plan, out_cap=st.out_cap)
    cold = rt.spgemm(ta, tb, plan=plan, accumulator="auto")
    for f in ("row", "col", "val", "ngroups"):
        assert torch.equal(getattr(cold, f), getattr(warm, f)), f


def test_batched_auto_needs_a_plan_and_a_plan_sets_the_backend():
    """Batched 'auto' without a plan raises the reference's ValueError; with
    a plan, 'auto' means the plan's backend; an unknown backend raises."""
    (ea, eb), (ta, tb) = _pair(*ZOO["dup_heavy"][:2])
    batch = (rt.EllRows(ta.val[None], ta.idx[None], ta.n_rows),
             rt.EllCols(tb.val[None], tb.idx[None], tb.n_cols))
    rbatch = (EllRows(ea.val[None], ea.idx[None], ea.n_rows),
              EllCols(eb.val[None], eb.idx[None], eb.n_cols))
    for fn, ops in ((tsp.spgemm_coo_batched, batch),
                    (spgemm_coo_batched, rbatch)):
        with pytest.raises(ValueError, match="concrete out_cap/backend"):
            fn(*ops, out_cap=1024, accumulator="auto")
    plan = make_plan(ta, tb, backend="bucket")
    _same_coo(rt.spgemm(ta, tb, accumulator="auto", plan=plan),
              tsp.spgemm_coo(ta, tb, out_cap=plan.out_cap,
                             accumulator="sort"))
    with pytest.raises(ValueError, match="unknown backend"):
        make_plan(ta, tb, backend="nope")


# ---------------------------------------------------------------------------
# Measured autotune
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("candidates", [None, ("sort", "search", "bucket")])
def test_autotune_on_cpu(candidates):
    a, b, k = ZOO["skewed"]
    (ea, eb), (ta, tb) = _pair(a, b, k)
    cache = rt.StructureCache(autotune=True, autotune_backends=candidates,
                              probe_iters=1)
    st = cache.get(ta, tb)
    want = candidates or BACKENDS
    assert st.plan.backend in want
    assert set(st.plan.est["autotune_us"]) == set(want)
    assert all(us > 0 for us in st.plan.est["autotune_us"].values())
    assert cache.stats()["autotuned"] == 1 and cache.stats()["misses"] == 1
    assert cache.get(ta, tb) is st and cache.stats()["autotuned"] == 1
    _same_coo(rt.spgemm(ta, tb, structure=st),
              spgemm_coo(ea, eb, accumulator="sort"))


def test_autotune_drops_only_inapplicable_backends(monkeypatch):
    """A candidate whose planning raises ValueError is dropped; a failure
    while it runs (a kernel's build or launch) propagates."""
    (_, _), (ta, tb) = _pair(*ZOO["square"][:2])
    real_plan, real_run = planner.make_plan, tsp.spgemm_coo

    def plan_no_hash(a, b, *, backend=None, **kw):
        if backend == "hash":
            raise ValueError("inapplicable here")
        return real_plan(a, b, backend=backend, **kw)

    monkeypatch.setattr(planner, "make_plan", plan_no_hash)
    cache = rt.StructureCache(autotune=True,
                              autotune_backends=("sort", "hash"),
                              probe_iters=1)
    st = cache.get(ta, tb)
    assert st.plan.backend == "sort"
    assert set(st.plan.est["autotune_us"]) == {"sort"}

    def run_fails_on_tiled(a, b, *args, plan=None, **kw):
        if plan is not None and plan.backend == "tiled":
            raise RuntimeError("tiled: CUDA error")
        return real_run(a, b, *args, plan=plan, **kw)

    monkeypatch.setattr(tsp, "spgemm_coo", run_fails_on_tiled)
    with pytest.raises(RuntimeError, match="CUDA error"):
        rt.StructureCache(autotune=True, autotune_backends=("sort", "tiled"),
                          probe_iters=1).get(ta, tb)


def test_autotuned_plan_crosses_cache_files(tmp_path):
    """A selected or autotuned plan is written without its stats and with
    its ``est``; both packages load it, ``est`` included."""
    from repro.plan import StructureCache as RefCache
    (ea, eb), (ta, tb) = _pair(*ZOO["skewed"][:2])
    st = rt.StructureCache(cache_dir=str(tmp_path), autotune=True,
                           autotune_backends=("sort", "search"),
                           probe_iters=1).get(ta, tb)
    back = rt.StructureCache(cache_dir=str(tmp_path)).get(ta, tb)
    assert back.plan == st.plan and back.plan.stats is None
    assert back.plan.est == st.plan.est
    ref = RefCache(cache_dir=str(tmp_path))
    assert ref.get(ea, eb).plan.est["autotune_us"] == \
        st.plan.est["autotune_us"]
    assert ref.stats()["disk_hits"] == 1


# ---------------------------------------------------------------------------
# The CUDA cost table on the card's numbers
# ---------------------------------------------------------------------------

# bcsstk32 A·Aᵀ as ``chip_smoke.py`` printed it on the H100 ([select] line):
# the planner's statistics and sizes. (k_a, n, k_b) = (72, 45000, 72).
BCSSTK32_STATS = dict(n=45000, nnz_a=2000000, nnz_b=2000000, k_a=72, k_b=72,
                      valid_products=90867028, nnz_c=86604149,
                      sigma=15.511116027832031)
H100_TOTAL_MEMORY = 85017493504        # the card's total_memory, bytes
BCSSTK32_SIZES = dict(out_cap=86604160, tile=4096, stream_cap=2097152,
                      stream_group=1, n_buckets=64, bucket_cap=2097152,
                      n_blocks=64, block_cap=4194304)


def test_cuda_table_picks_the_card_fastest_on_bcsstk32():
    """Fed bcsstk32's statistics and sizes, the CUDA table picks 'bucket',
    the backend whose planned and cold calls the card measured fastest
    (PERF.md §5), with no override under the H100's budget; the CPU table,
    with its interpreter penalty, does not."""
    plan = planner.Plan(backend="sort", **BCSSTK32_SIZES,
                        stats=hwmodel.MatrixStats(**BCSSTK32_STATS))
    budget = int(H100_TOTAL_MEMORY * planner.CUDA_MEM_SHARE)
    costs, interm = planner.plan_costs(plan, 72, 45000, 72,
                                       planner.CUDA_COSTS)
    assert min(costs, key=costs.get) == "bucket"
    assert planner._select(costs, interm, budget, 45000, 45000) == "bucket"
    cpu, _ = planner.plan_costs(plan, 72, 45000, 72, planner.CPU_COSTS)
    assert planner._select(cpu, interm, budget, 45000, 45000) != "bucket"
    # every backend's modeled bytes fit: no override on the card
    assert max(interm.values()) < budget


def test_cuda_table_reproduces_the_fit_points():
    """The table's costs at bcsstk32 and at its 5,625-column cut are the
    card's planned-call medians it was fitted on (µs, to the 4 digits
    kept), so it orders the backends as the card did at both."""
    cut = planner.Plan(backend="sort", out_cap=11126144, tile=4096,
                       stream_cap=262144, stream_group=1, n_buckets=64,
                       bucket_cap=262144, n_blocks=64, block_cap=524288,
                       stats=hwmodel.MatrixStats(
                           n=45000, nnz_a=250051, nnz_b=250051, k_a=70,
                           k_b=70, valid_products=11368793, nnz_c=11126134,
                           sigma=2.9247806072235107))
    full = planner.Plan(backend="sort", **BCSSTK32_SIZES,
                        stats=hwmodel.MatrixStats(**BCSSTK32_STATS))
    measured = {   # planned-call medians, ms (H100 80GB HBM3, 700 W)
        "full": dict(sort=453.50, tiled=101.42, bucket=57.51, hash=514.38,
                     stream=246.13, search=403.76),
        "cut": dict(sort=53.38, tiled=12.46, bucket=7.95, hash=78.19,
                    stream=62.34, search=47.37)}
    for name, plan, (k_a, n, k_b) in (("full", full, (72, 45000, 72)),
                                       ("cut", cut, (70, 5625, 70))):
        costs, _ = planner.plan_costs(plan, k_a, n, k_b, planner.CUDA_COSTS)
        for bk, ms in measured[name].items():
            assert costs[bk] / 1e3 == pytest.approx(ms, rel=2e-3), (name, bk)
        assert sorted(costs, key=costs.get) == \
            sorted(measured[name], key=measured[name].get)
