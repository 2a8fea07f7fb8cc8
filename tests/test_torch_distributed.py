"""repro_torch's distributed SpGEMM on CPU meshes, against the JAX reference.

The port's mesh is in-process (``repro_torch.parallel``): every shard is a
tensor on a device of the mesh, here the CPU, so these tests spawn no
process, open no socket and set no environment variable. The reference's
own sharded tests need 8 fake JAX devices in a subprocess; here each of
their cases is rebuilt on a CPU ``Mesh`` of 8 and held against the
reference's single-device ``repro.core.spgemm_coo`` on the same numpy
operands: bit for bit on integer-valued operands (every float32 sum exact
in any order), within 1e-5 × max|C| on normal float operands (the
summation order differs). The symbolic counts, ``grid_candidates``,
``best_grid`` and ``make_dist_plan`` equal the reference's on CPU tensors,
``est`` to 1e-12 relative.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import repro_torch as rt
from repro.core import ell_cols_from_dense, ell_rows_from_dense, spgemm_coo
from repro.plan import StructureCache as RefCache
from repro.plan import make_dist_plan as ref_make_dist_plan
from repro.plan import make_structure as ref_make_structure
from repro.plan import planner as ref_planner
from repro.plan import symbolic as ref_sym
from repro_torch import obs
from repro_torch.core import distributed as tdist
from repro_torch.parallel import mesh as tmesh
from repro_torch.parallel import make_mesh, put_spgemm_operands
from repro_torch.plan import StructureCache, planner
from repro_torch.plan import symbolic as tsym

SCHEDULES = ("ring", "cstat", "summa")


def _mesh(n=8, axis="ring"):
    return make_mesh((n,), (axis,), devices=["cpu"] * n)


def _int_sparse(rng, m, n, density, lo=-4, hi=5):
    return (((rng.random((m, n)) < density)
             * rng.integers(lo, hi, (m, n))).astype(np.float32))


def _pair(a, b, ka, kb):
    ref = (ell_rows_from_dense(jnp.array(a), ka),
           ell_cols_from_dense(jnp.array(b), kb))
    port = (rt.ell_rows_from_dense(a, ka, device="cpu"),
            rt.ell_cols_from_dense(b, kb, device="cpu"))
    return ref, port


def _widths(a, b):
    return (max(1, int((a != 0).sum(0).max())),
            max(1, int((b != 0).sum(1).max())))


def _bit_identical(got, ref):
    """The reference's ``assert_bit_identical``: same cap, same planes,
    same ``ngroups``."""
    assert got.cap == ref.row.shape[-1], (got.cap, ref.row.shape)
    row, col, val, ng = rt.to_numpy(got)
    np.testing.assert_array_equal(row, np.asarray(ref.row))
    np.testing.assert_array_equal(col, np.asarray(ref.col))
    np.testing.assert_array_equal(val, np.asarray(ref.val))
    np.testing.assert_array_equal(ng, np.asarray(ref.ngroups))
    assert got.row.dtype == got.col.dtype == got.ngroups.dtype == torch.int32


def _same_port(got, want):
    for f in ("row", "col", "val", "ngroups"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def _operands(seed, m, k, n, da, db, ka=None, kb=None):
    rng = np.random.default_rng(seed)
    a, b = _int_sparse(rng, m, k, da), _int_sparse(rng, k, n, db)
    wa, wb = _widths(a, b)
    return a, b, _pair(a, b, ka or wa, kb or wb)


def _same_dist_plan(got, want):
    for f in dataclasses.fields(want):
        if f.name not in ("base", "est"):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    for f in dataclasses.fields(want.base):
        if f.name not in ("stats", "est"):
            assert getattr(got.base, f.name) == getattr(want.base, f.name), \
                f.name
    assert got.est.keys() == want.est.keys()
    for k, v in got.est.items():
        assert math.isclose(v, want.est[k], rel_tol=1e-12), (k, v)


@pytest.fixture
def clean_obs():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


# ---------------------------------------------------------------------------
# The mesh and its collectives
# ---------------------------------------------------------------------------

def test_mesh_shape_and_axes():
    """A mesh's shape and its groups along each axis: ``axis_devices`` is
    the group at index 0 of the other axes, on a mesh of any axes."""
    m = make_mesh((2, 3), ("a", "b"), devices=[f"cpu:{i}" for i in range(6)])
    assert m.shape == {"a": 2, "b": 3} and m.size == 6
    assert list(m.shape) == ["a", "b"]
    cpu = [torch.device(f"cpu:{i}") for i in range(6)]
    assert m.axis_groups("a") == [[cpu[0], cpu[3]], [cpu[1], cpu[4]],
                                  [cpu[2], cpu[5]]]
    assert m.axis_groups("b") == [cpu[0:3], cpu[3:6]]
    assert m.axis_devices("a") == [cpu[0], cpu[3]]
    assert m.axis_devices("b") == cpu[0:3]
    with pytest.raises(ValueError, match="no axis"):
        _mesh(4).axis_devices("x")
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((4,), ("x",), devices=["cpu"] * 3)
    assert _mesh(4, "x").axis_devices("x") == [torch.device("cpu")] * 4


def test_make_mesh_defaults_to_cuda():
    if torch.cuda.is_available():
        assert make_mesh((2,), ("x",)).devices[0].type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((2,), ("x",))


def test_multi_axis_mesh_raises_on_the_sharded_paths():
    """A mesh of two axes no longer raises on the sharded paths: the call
    runs along the named axis (the other replicating) and equals the call
    on a 1-D mesh of that axis's size bit for bit; an axis the mesh lacks
    still raises."""
    (_, _), (ta, tb) = _operands(1, 16, 16, 16, 0.3, 0.3)[2]
    m = make_mesh((2, 2), ("x", "y"), devices=["cpu"] * 4)
    got = rt.spgemm(ta, tb, mesh=m, axis="x")
    want = rt.spgemm(ta, tb, mesh=_mesh(2, "x"), axis="x")
    for f in ("row", "col", "val", "ngroups"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    with pytest.raises(ValueError, match="no axis"):
        rt.spgemm(ta, tb, mesh=m, axis="z")


def test_ppermute_copies_never_alias():
    shards = [torch.arange(4.0) + 10 * d for d in range(3)]
    got = tmesh.ppermute(shards, tmesh.ring_perm(3))
    for d in range(3):
        assert torch.equal(got[d], shards[(d - 1) % 3])
        assert all(got[d].data_ptr() != s.data_ptr() for s in shards)
    got[0].add_(100)                            # in place: no other shard
    assert torch.equal(shards[2], torch.arange(4.0) + 20)
    partial = tmesh.ppermute(shards, [(0, 1)])
    assert torch.equal(partial[1], shards[0])
    assert not partial[0].any() and not partial[2].any()
    started = tmesh.ppermute_start(shards, tmesh.ring_perm(3)).wait()
    for g, w in zip(started, tmesh.ppermute(shards, tmesh.ring_perm(3))):
        assert torch.equal(g, w)


def test_psum_and_moved_bytes():
    shards = [torch.full((5,), float(d + 1)) for d in range(4)]
    tmesh.reset_moved_bytes()
    total = tmesh.psum(shards)
    assert torch.equal(total, torch.full((5,), 10.0))
    assert tmesh.moved_bytes() == 3 * 5 * 4
    assert total.data_ptr() != shards[0].data_ptr()
    tmesh.ppermute(shards, tmesh.ring_perm(4))
    assert tmesh.moved_bytes() == 3 * 5 * 4 + 4 * 5 * 4
    tmesh.reset_moved_bytes()
    assert tmesh.moved_bytes() == 0


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_ring_all_to_all_is_a_transpose(n):
    x = [torch.arange(n * 3 * 2).reshape(n, 3, 2) + 1000 * d
         for d in range(n)]
    got = tdist.ring_all_to_all(x)
    for d in range(n):
        for i in range(n):
            assert torch.equal(got[d][i], x[i][d])


# ---------------------------------------------------------------------------
# Symbolic counts and planning, equal to the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
def test_symbolic_counts_match_reference(n_dev):
    _, _, ((ea, eb), (ta, tb)) = _operands(2, 40, 32, 48, 0.2, 0.2, 7, 5)
    np.testing.assert_array_equal(
        tsym.per_shard_products(ta, tb, n_dev).numpy(),
        np.asarray(ref_sym.per_shard_products(ea, eb, n_dev)))
    for exact in (True, False):
        np.testing.assert_array_equal(
            tsym.per_block_nnz(ta, tb, n_dev, exact=exact).numpy(),
            np.asarray(ref_sym.per_block_nnz(ea, eb, n_dev, exact=exact)))
    for pr in range(1, n_dev + 1):
        if n_dev % pr == 0:
            got = tsym.per_grid_products(ta, tb, pr, n_dev // pr)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(ref_sym.per_grid_products(
                    ea, eb, pr, n_dev // pr)))


@pytest.mark.parametrize("n_dev", range(1, 17))
def test_grids_match_reference(n_dev):
    assert planner.grid_candidates(n_dev) == \
        ref_planner.grid_candidates(n_dev)
    for k_a, k_b in ((7, 5), (5, 7), (16, 16), (1, 40)):
        for deg in (False, True):
            assert planner.best_grid(n_dev, k_a, k_b, allow_degenerate=deg) \
                == ref_planner.best_grid(n_dev, k_a, k_b,
                                         allow_degenerate=deg)


@pytest.mark.parametrize("n_dev", [2, 3, 4, 8])
@pytest.mark.parametrize("schedule", [None, *SCHEDULES])
def test_make_dist_plan_matches_reference(schedule, n_dev):
    """Every field, ``est`` included; with and without a pinned backend."""
    _, _, ((ea, eb), (ta, tb)) = _operands(3, 40, 32, 48, 0.2, 0.2, 7, 5)
    for backend in (None, "stream"):
        got = rt.make_dist_plan(ta, tb, n_dev=n_dev, schedule=schedule,
                                backend=backend)
        want = ref_make_dist_plan(ea, eb, n_dev=n_dev, schedule=schedule,
                                  backend=backend)
        _same_dist_plan(got, want)
        assert got.pr * got.pc == n_dev


def test_make_dist_plan_rejects_bad_arguments():
    _, _, ((_, _), (ta, tb)) = _operands(3, 16, 16, 16, 0.3, 0.3)
    with pytest.raises(ValueError, match="unknown schedule"):
        rt.make_dist_plan(ta, tb, n_dev=2, schedule="torus")
    with pytest.raises(ValueError, match="n_dev"):
        rt.make_dist_plan(ta, tb, n_dev=0)


def test_dist_decision_instant_and_dist_metrics(clean_obs):
    """A traced sharded call plans (``plan.dist_decision``), spans its
    exchange (``dist.exchange``) and counts ``dist.calls`` and
    ``dist.comm_bytes.<schedule>``, as the reference does."""
    _, _, ((_, _), (ta, tb)) = _operands(4, 32, 32, 32, 0.25, 0.25)
    obs.enable(reset=True)
    rt.spgemm(ta, tb, mesh=_mesh(4), axis="ring", schedule="summa")
    events = obs.get_tracer().snapshot()["events"]
    names = [e["name"] for e in events]
    assert "plan.dist_decision" in names and "dist.exchange" in names
    ex = next(e for e in events if e["name"] == "dist.exchange")
    assert ex["args"]["schedule"] == "summa" and ex["args"]["grid"] == "2x2"
    metrics = obs.snapshot()["metrics"]
    assert metrics["counters"]["dist.calls"] == 1
    assert metrics["counters"]["dist.comm_bytes.summa"] > 0
    assert 0 < metrics["gauges"]["dist.overlap_efficiency"] <= 1


# ---------------------------------------------------------------------------
# The reference's sharded cases on a CPU mesh of 8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", SCHEDULES)
def test_sharded_matches_single_device_square(schedule):
    a, b, ((ea, eb), (ta, tb)) = _operands(10, 32, 32, 32, 0.25, 0.25,
                                           16, 16)
    ref = spgemm_coo(ea, eb, out_cap="auto")
    mesh = _mesh()
    got = tdist.spgemm_coo_sharded(ta, tb, mesh, "ring", schedule=schedule,
                                   check=True)
    _bit_identical(got, ref)
    np.testing.assert_allclose(got.to_dense().numpy(), a @ b, atol=1e-4)
    dp = rt.make_dist_plan(ta, tb, n_dev=8, schedule=schedule)
    for overlap in (True, False):
        _bit_identical(tdist.spgemm_coo_sharded(
            ta, tb, mesh, "ring", dist_plan=dp, overlap=overlap), ref)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_sharded_rectangular_nondivisible_slabs(schedule):
    """k_a = 5 and k_b = 3 on a ring of 8: the slab padding."""
    _, _, ((ea, eb), (ta, tb)) = _operands(11, 24, 32, 40, 0.2, 0.2, 5, 3)
    got = rt.spgemm(ta, tb, mesh=_mesh(), axis="ring", schedule=schedule,
                    check=True)
    _bit_identical(got, spgemm_coo(ea, eb, out_cap="auto"))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_sharded_skewed_rows(schedule):
    """A few hot output rows: the exact histograms still never drop."""
    rng = np.random.default_rng(12)
    a, b = _int_sparse(rng, 64, 64, 0.05), _int_sparse(rng, 64, 64, 0.08)
    hot = rng.choice(64, 8, replace=False)
    a[hot] = _int_sparse(rng, 8, 64, 0.6)
    (ea, eb), (ta, tb) = _pair(a, b, *_widths(a, b))
    got = rt.spgemm(ta, tb, mesh=_mesh(), axis="ring", schedule=schedule,
                    check=True)
    _bit_identical(got, spgemm_coo(ea, eb, out_cap="auto"))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_sharded_empty_and_tiny(schedule):
    """All-zero operands, and fewer rows than devices."""
    z = np.zeros((16, 16), np.float32)
    (ez, fz), (tz, uz) = _pair(z, z, 2, 2)
    got = rt.spgemm(tz, uz, mesh=_mesh(), axis="ring", schedule=schedule,
                    check=True)
    _bit_identical(got, spgemm_coo(ez, fz, out_cap="auto"))
    assert int(got.nnz()) == 0
    _, _, ((ea, eb), (ta, tb)) = _operands(13, 5, 6, 7, 0.5, 0.5, 5, 6)
    got = rt.spgemm(ta, tb, mesh=_mesh(), axis="ring", schedule=schedule,
                    check=True)
    _bit_identical(got, spgemm_coo(ea, eb, out_cap="auto"))


@pytest.mark.parametrize("backend", planner.BACKENDS)
def test_sharded_planned_backends(backend):
    """Every accumulation backend, device-local, under every schedule;
    overlap on and off give the same bits."""
    _, _, ((ea, eb), (ta, tb)) = _operands(14, 32, 32, 32, 0.25, 0.25,
                                           16, 16)
    ref = spgemm_coo(ea, eb, out_cap="auto")
    for schedule in SCHEDULES:
        for overlap in (True, False):
            got = rt.spgemm(ta, tb, mesh=_mesh(), axis="ring",
                            accumulator=backend, schedule=schedule,
                            overlap=overlap, check=True)
            _bit_identical(got, ref)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_sharded_stream_backend_planned(schedule):
    """'stream' under a prebuilt DistPlan, with skewed rows."""
    rng = np.random.default_rng(15)
    a, b = _int_sparse(rng, 64, 64, 0.08), _int_sparse(rng, 64, 64, 0.08)
    hot = rng.choice(64, 6, replace=False)
    a[hot] = _int_sparse(rng, 6, 64, 0.5)
    (ea, eb), (ta, tb) = _pair(a, b, *_widths(a, b))
    dp = rt.make_dist_plan(ta, tb, n_dev=8, schedule=schedule,
                           backend="stream")
    assert dp.base.backend == "stream"
    got = rt.spgemm(ta, tb, mesh=_mesh(), axis="ring", dist_plan=dp,
                    check=True)
    _bit_identical(got, spgemm_coo(ea, eb, out_cap="auto"))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_sharded_batched(schedule):
    """Three elements of different patterns under one slice's plan (slack
    2), through the front door; each element equals its own single-device
    product at the plan's cap."""
    rng = np.random.default_rng(16)
    n, bsz = 32, 3
    pairs = [_pair(_int_sparse(rng, n, n, 0.2), _int_sparse(rng, n, n, 0.2),
                   12, 12) for _ in range(bsz)]
    ta = rt.EllRows(val=torch.stack([p[1][0].val for p in pairs]),
                    idx=torch.stack([p[1][0].idx for p in pairs]), n_rows=n)
    tb = rt.EllCols(val=torch.stack([p[1][1].val for p in pairs]),
                    idx=torch.stack([p[1][1].idx for p in pairs]), n_cols=n)
    dp = rt.make_dist_plan(pairs[0][1][0], pairs[0][1][1], n_dev=8,
                           slack=2.0)
    dp = dataclasses.replace(dp, schedule=schedule)
    got = rt.spgemm(ta, tb, mesh=_mesh(), axis="ring", dist_plan=dp,
                    check=True)
    assert got.row.shape[0] == bsz and tuple(got.ngroups.shape) == (bsz,)
    for i, ((ea, eb), _) in enumerate(pairs):
        ref = spgemm_coo(ea, eb, out_cap=dp.out_cap)
        elem = rt.Coo(row=got.row[i], col=got.col[i], val=got.val[i],
                      shape=got.shape, ngroups=got.ngroups[i])
        _bit_identical(elem, ref)
    with pytest.raises(ValueError, match="dist_plan"):
        tdist.spgemm_coo_sharded(ta, tb, _mesh(), "ring")


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_overflow_poisoning_crosses_collective(schedule):
    """An undersized exchange truncates on some device; the summed poison
    reaches the result and ``check=True`` raises."""
    _, _, ((_, _), (ta, tb)) = _operands(17, 32, 32, 32, 0.25, 0.25, 16, 16)
    dp = rt.make_dist_plan(ta, tb, n_dev=8)
    tiny = dataclasses.replace(dp, schedule=schedule, block_cap=2,
                               bin_cap=2)
    got = rt.spgemm(ta, tb, mesh=_mesh(), axis="ring", dist_plan=tiny)
    assert bool(got.overflowed()), int(got.ngroups)
    with pytest.raises(rt.AccumulatorOverflow):
        rt.spgemm(ta, tb, mesh=_mesh(), axis="ring", dist_plan=tiny,
                  check=True)


def test_ring_spgemm_pads_nondivisible_slabs():
    """The dense baseline pads k_a = 5, k_b = 3 on a ring of 8."""
    _, _, ((ea, eb), (ta, tb)) = _operands(18, 24, 32, 40, 0.2, 0.2, 5, 3)
    got = tdist.ring_spgemm(ta, tb, _mesh(), "ring")
    want = np.asarray(ea.to_dense()) @ np.asarray(eb.to_dense())
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, rt.spgemm_dense(ta, tb))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_put_spgemm_operands_presharded(schedule):
    """Operands split once onto the mesh give the result of the whole
    ones, under their own schedule and under another (re-split)."""
    _, _, ((ea, eb), (ta, tb)) = _operands(19, 32, 32, 32, 0.25, 0.25,
                                           16, 16)
    ref = spgemm_coo(ea, eb, out_cap="auto")
    mesh = _mesh()
    dp = rt.make_dist_plan(ta, tb, n_dev=8, schedule=schedule)
    ash, bsh = put_spgemm_operands(ta, tb, mesh, "ring", schedule=schedule)
    assert len(ash.val) == 8 and ash.dim == (None if schedule == "cstat"
                                             else 0)
    assert bsh.dim == 1 and tuple(bsh.val[0].shape) == (32, 2)
    got = tdist.spgemm_coo_sharded(ash, bsh, mesh, "ring", dist_plan=dp,
                                   check=True)
    _bit_identical(got, ref)
    other = "cstat" if schedule != "cstat" else "ring"
    _bit_identical(rt.spgemm(ash, bsh, mesh=mesh, axis="ring",
                             dist_plan=dp, schedule=other), ref)


def test_operand_specs_match_reference():
    from repro.parallel.sharding import spgemm_operand_specs as ref_specs
    from repro_torch.parallel import spgemm_operand_specs
    for schedule in SCHEDULES:
        for batched in (False, True):
            got = spgemm_operand_specs("x", schedule=schedule,
                                       batched=batched)
            want = ref_specs("x", schedule=schedule, batched=batched)
            assert [tuple(s) for s in got] == [tuple(s) for s in want]


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_facade_parity_sharded_paths(schedule):
    """``spgemm(mesh=, axis=)`` equals the functions it routes to."""
    _, _, ((ea, eb), (ta, tb)) = _operands(20, 32, 32, 32, 0.25, 0.25,
                                           16, 16)
    mesh = _mesh()
    ref = tdist.spgemm_coo_sharded(ta, tb, mesh, "ring", schedule=schedule,
                                   check=True)
    _same_port(rt.spgemm(ta, tb, mesh=mesh, axis="ring", schedule=schedule,
                         check=True), ref)
    _bit_identical(ref, spgemm_coo(ea, eb, out_cap="auto"))
    st = rt.make_structure(ta, tb, n_dev=8)
    if schedule == "cstat":
        return
    want = tdist.spgemm_coo_sharded_numeric(ta, tb, mesh, "ring", st,
                                            schedule=schedule)
    _same_port(rt.spgemm(ta, tb, mesh=mesh, axis="ring", structure=st,
                         schedule=schedule), want)
    _bit_identical(want, spgemm_coo(ea, eb, out_cap="auto"))


@pytest.mark.parametrize("grid", [(2, 4), (4, 2), (1, 8), (8, 1)])
def test_summa_nonsquare_and_degenerate_grids(grid):
    """Every factorization of 8, the degenerate ones included, overlap on
    and off: the grid changes the traffic, never the result."""
    _, _, ((ea, eb), (ta, tb)) = _operands(21, 40, 32, 48, 0.2, 0.2, 7, 5)
    ref = spgemm_coo(ea, eb, out_cap="auto")
    dp = rt.make_dist_plan(ta, tb, n_dev=8)
    dps = dataclasses.replace(dp, schedule="summa", pr=grid[0], pc=grid[1])
    for overlap in (True, False):
        got = tdist.spgemm_coo_sharded(ta, tb, _mesh(), "ring", dist_plan=dps,
                                       overlap=overlap, check=True)
        _bit_identical(got, ref)


def test_summa_on_a_prime_mesh_takes_a_degenerate_grid():
    """A hand-built plan whose grid does not cover the axis is factored at
    the call, as in the reference."""
    _, _, ((ea, eb), (ta, tb)) = _operands(22, 30, 24, 30, 0.25, 0.25)
    dp = rt.make_dist_plan(ta, tb, n_dev=5)
    assert (dp.pr, dp.pc) in ((5, 1), (1, 5))
    bad = dataclasses.replace(dp, schedule="summa", pr=1, pc=1)
    got = rt.spgemm(ta, tb, mesh=_mesh(5), axis="ring", dist_plan=bad,
                    check=True)
    _bit_identical(got, spgemm_coo(ea, eb, out_cap="auto"))


def test_summa_warm_numeric_and_facade():
    """The sharded numeric phase under 'auto' (the structure's cached
    'summa'), 'ring' and 'summa', overlap on and off, equals the cold
    product; 'cstat' raises there."""
    a, b, ((ea, eb), (ta, tb)) = _operands(23, 32, 32, 32, 0.25, 0.25,
                                           16, 16)
    ref = spgemm_coo(ea, eb, out_cap="auto")
    mesh = _mesh()
    st = rt.make_structure(ta, tb, n_dev=8, schedules=("summa", "ring"))
    for schedule in ("auto", "ring", "summa"):
        for overlap in (True, False):
            got = tdist.spgemm_coo_sharded_numeric(
                ta, tb, mesh, "ring", st, schedule=schedule,
                overlap=overlap, check=True)
            _bit_identical(got, ref)
            np.testing.assert_array_equal(got.to_dense().numpy(), a @ b)
    got_f = rt.spgemm(ta, tb, mesh=mesh, axis="ring", structure=st,
                      schedule="summa", overlap=False, check=True)
    _bit_identical(got_f, ref)
    with pytest.raises(ValueError, match="cstat"):
        tdist.spgemm_coo_sharded_numeric(ta, tb, mesh, "ring", st,
                                         schedule="cstat")


def test_warm_numeric_poisons_a_stale_structure():
    """A structure missing some output coordinates (``validate=False``):
    the misses, counted on every shard and summed, poison ``ngroups``."""
    _, _, ((_, _), (ta, tb)) = _operands(24, 32, 32, 32, 0.25, 0.25, 16, 16)
    st = rt.make_structure(ta, tb)
    idx = ta.idx.clone()
    s0, c0 = (int(x) for x in torch.nonzero(idx >= 0)[0])
    free = np.setdiff1d(np.arange(32), idx[:, c0].numpy())
    idx[s0, c0] = int(free[0])
    stale = rt.EllRows(val=ta.val, idx=idx, n_rows=32)
    got = rt.spgemm(stale, tb, mesh=_mesh(), axis="ring", structure=st,
                    validate=False)
    assert int(got.ngroups) > st.out_cap
    with pytest.raises(ValueError, match="stale structure"):
        rt.spgemm(stale, tb, mesh=_mesh(), axis="ring", structure=st)


@pytest.mark.parametrize("grid", [(2, 4), (4, 2)])
def test_summa_poison_crosses_grid_axes(grid):
    _, _, ((_, _), (ta, tb)) = _operands(25, 32, 32, 32, 0.5, 0.5, 20, 20)
    dp = rt.make_dist_plan(ta, tb, n_dev=8, schedule="summa")
    ok = rt.spgemm(ta, tb, mesh=_mesh(), axis="ring", dist_plan=dp,
                   check=True)
    assert not bool(ok.overflowed())
    tiny = dataclasses.replace(dp, pr=grid[0], pc=grid[1], local_cap=128)
    got = rt.spgemm(ta, tb, mesh=_mesh(), axis="ring", dist_plan=tiny)
    assert bool(got.overflowed()), int(got.ngroups)
    with pytest.raises(rt.AccumulatorOverflow):
        rt.spgemm(ta, tb, mesh=_mesh(), axis="ring", dist_plan=tiny,
                  check=True)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_float_operands_within_summation_order(schedule):
    """Normal float operands: the same coordinates, values within
    1e-5 × max|C| of the reference's single-device product."""
    rng = np.random.default_rng(26)
    a = ((rng.random((32, 32)) < 0.25)
         * rng.standard_normal((32, 32))).astype(np.float32)
    b = ((rng.random((32, 32)) < 0.25)
         * rng.standard_normal((32, 32))).astype(np.float32)
    (ea, eb), (ta, tb) = _pair(a, b, *_widths(a, b))
    ref = spgemm_coo(ea, eb, out_cap="auto")
    got = rt.spgemm(ta, tb, mesh=_mesh(), axis="ring", schedule=schedule,
                    check=True)
    row, col, val, ng = rt.to_numpy(got)
    np.testing.assert_array_equal(row, np.asarray(ref.row))
    np.testing.assert_array_equal(col, np.asarray(ref.col))
    np.testing.assert_array_equal(ng, np.asarray(ref.ngroups))
    want = np.asarray(ref.val)
    assert np.abs(val - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("n_dev", [2, 3, 4])
def test_meshes_of_other_sizes(n_dev):
    """Each schedule on meshes of 2, 3 and 4, cold and warm."""
    _, _, ((ea, eb), (ta, tb)) = _operands(27 + n_dev, 36, 30, 28, 0.2,
                                           0.25)
    ref = spgemm_coo(ea, eb, out_cap="auto")
    mesh = _mesh(n_dev, "x")
    for schedule in SCHEDULES:
        _bit_identical(rt.spgemm(ta, tb, mesh=mesh, axis="x",
                                 schedule=schedule, check=True), ref)
    st = rt.make_structure(ta, tb, n_dev=n_dev, schedules=SCHEDULES)
    for schedule in ("ring", "summa"):
        _bit_identical(rt.spgemm(ta, tb, mesh=mesh, axis="x", structure=st,
                                 schedule=schedule, check=True), ref)
        _bit_identical(tdist.spgemm_coo_sharded(
            ta, tb, mesh, "x", structure=st, schedule=schedule), ref)


def test_dist_plan_checks():
    """A plan for another mesh size, or a stale fingerprint, raises; a
    reference ``DistPlan`` is accepted."""
    _, _, ((ea, eb), (ta, tb)) = _operands(31, 32, 32, 32, 0.25, 0.25)
    mesh = _mesh(4, "x")
    with pytest.raises(ValueError, match="built for 2 devices"):
        rt.spgemm(ta, tb, mesh=mesh, axis="x",
                  dist_plan=rt.make_dist_plan(ta, tb, n_dev=2))
    _, _, ((_, _), (oa, ob)) = _operands(32, 32, 32, 32, 0.25, 0.25,
                                         ta.k, tb.k)
    with pytest.raises(ValueError, match="stale plan"):
        rt.spgemm(oa, ob, mesh=mesh, axis="x",
                  dist_plan=rt.make_dist_plan(ta, tb, n_dev=4))
    ref_dp = ref_make_dist_plan(ea, eb, n_dev=4, schedule="summa")
    _bit_identical(rt.spgemm(ta, tb, mesh=mesh, axis="x", dist_plan=ref_dp,
                             check=True), spgemm_coo(ea, eb, out_cap="auto"))


# ---------------------------------------------------------------------------
# Structures with n_dev, and their cache files
# ---------------------------------------------------------------------------

def test_make_structure_dist_plans_match_reference():
    _, _, ((ea, eb), (ta, tb)) = _operands(33, 32, 32, 32, 0.25, 0.25)
    for kw in (dict(n_dev=4), dict(n_dev=8, schedules=SCHEDULES)):
        got = rt.make_structure(ta, tb, **kw)
        want = ref_make_structure(ea, eb, **kw)
        assert [s for s, _ in got.dist_plans] == \
            [s for s, _ in want.dist_plans]
        for (_, g), (_, w) in zip(got.dist_plans, want.dist_plans):
            _same_dist_plan(g, w)
        _same_dist_plan(got.dist_plan(), want.dist_plan())
    with pytest.raises(ValueError, match="no distributed plans"):
        rt.make_structure(ta, tb).dist_plan()
    with pytest.raises(ValueError, match="caches no 'cstat'"):
        rt.make_structure(ta, tb, n_dev=2, schedules=("ring",)).dist_plan(
            "cstat")
    with pytest.raises(ValueError, match="unknown schedule"):
        rt.make_structure(ta, tb, n_dev=2, schedules=("torus",))


def test_cache_reads_reference_dist_plans(tmp_path):
    """A reference-written ``.npz`` holding distributed plans is a disk hit
    with equal plans, which a sharded call then uses; the port's file is
    one the reference reads back the same."""
    _, _, ((ea, eb), (ta, tb)) = _operands(34, 32, 32, 32, 0.25, 0.25)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    want = RefCache(cache_dir=str(ref_dir)).get(ea, eb, n_dev=8,
                                                schedules=SCHEDULES)
    cache = StructureCache(cache_dir=str(ref_dir))
    st = cache.get(ta, tb)
    assert cache.stats()["disk_hits"] == 1
    assert len(st.dist_plans) == 3
    for (s, g), (t, w) in zip(st.dist_plans, want.dist_plans):
        assert s == t
        _same_dist_plan(g, w)
    ref = spgemm_coo(ea, eb, out_cap="auto")
    for schedule in SCHEDULES:
        _bit_identical(rt.spgemm(ta, tb, mesh=_mesh(), axis="ring",
                                 dist_plan=st.dist_plan(schedule)), ref)
    StructureCache(cache_dir=str(port_dir)).get(ta, tb, n_dev=4)
    back = RefCache(cache_dir=str(port_dir))
    got = back.get(ea, eb)
    assert back.stats()["disk_hits"] == 1
    _same_dist_plan(rt.make_dist_plan(ta, tb, n_dev=4,
                                      backend=got.plan.backend),
                    got.dist_plan())
