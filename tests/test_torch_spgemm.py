"""repro_torch's cold single-device SpGEMM against the JAX reference on the
CPU, plus the port's guards.

The same numpy operands go through ``repro.core.spgemm_coo`` and
``repro_torch.spgemm``: on integer-valued operands (every float32 sum exact
in any order) the sorted COO is bit-identical for ``'sort'`` and
``'search'`` across the matrix zoo, truncation, the extreme-key boundary
and the ≥ 2³¹−1 reroute; on float operands only the summation order
differs (``rtol=atol=1e-5``).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import repro_torch as rt
from repro.core import (ell_cols_from_dense, ell_rows_from_dense, spgemm_coo,
                        spgemm_coo_batched)
from repro.core import spgemm as ref_sp
from repro.core.formats import EllCols, EllRows
from repro.plan import make_plan
from repro.plan import symbolic as ref_sym
from repro_torch import kernels
from repro_torch.core import spgemm as tsp
from repro_torch.plan import symbolic as tsym

from conftest import random_sparse

REPO = Path(__file__).resolve().parents[1]


def _int_sparse(rng, m, n, density, lo=-4, hi=5):
    return (((rng.random((m, n)) < density)
             * rng.integers(lo, hi, (m, n))).astype(np.float32))


def _zoo():
    rng = np.random.default_rng(0)
    cases = {
        "square": (_int_sparse(rng, 32, 32, 0.25),
                   _int_sparse(rng, 32, 32, 0.25), None),
        "rect": (_int_sparse(rng, 24, 40, 0.3),
                 _int_sparse(rng, 40, 56, 0.2), None),
    }
    skew = _int_sparse(rng, 48, 48, 0.05)
    skew[rng.choice(48, 6, replace=False)] = _int_sparse(rng, 6, 48, 0.7)
    cases["skewed"] = (skew, _int_sparse(rng, 48, 48, 0.1), None)
    cases["dup_heavy"] = (_int_sparse(rng, 16, 16, 0.8),
                          _int_sparse(rng, 16, 16, 0.8), None)
    cases["padding_heavy"] = (_int_sparse(rng, 32, 32, 0.05),
                              _int_sparse(rng, 32, 32, 0.05), 12)
    z = np.zeros((16, 16), np.float32)
    cases["empty"] = (z, z, 2)
    r = np.random.default_rng(9)
    cases["float"] = (random_sparse(r, 24, 24, 0.3),
                      random_sparse(r, 24, 24, 0.3), None)
    return cases


ZOO = _zoo()


def _pair(a, b, k=None):
    ka = k or max(1, int((a != 0).sum(0).max()))
    kb = k or max(1, int((b != 0).sum(1).max()))
    ref = (ell_rows_from_dense(jnp.array(a), ka),
           ell_cols_from_dense(jnp.array(b), kb))
    port = (rt.ell_rows_from_dense(a, ka, device="cpu"),
            rt.ell_cols_from_dense(b, kb, device="cpu"))
    return ref, port


def _same_coo(got, ref, exact=True):
    assert tuple(got.row.shape) == tuple(ref.row.shape)
    row, col, val, ng = rt.to_numpy(got)
    np.testing.assert_array_equal(row, np.asarray(ref.row))
    np.testing.assert_array_equal(col, np.asarray(ref.col))
    if exact:
        np.testing.assert_array_equal(val, np.asarray(ref.val))
    else:
        np.testing.assert_allclose(val, np.asarray(ref.val), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(ng, np.asarray(ref.ngroups))
    assert got.row.dtype == got.col.dtype == got.ngroups.dtype == torch.int32


@pytest.mark.parametrize("accumulator", ["sort", "search"])
@pytest.mark.parametrize("case", sorted(ZOO))
def test_spgemm_coo_matches_reference_zoo(case, accumulator):
    """The zoo through the front door with ``out_cap="auto"``: bit-identical
    to the reference (float case: summation order only), at the reference's
    exact symbolic cap."""
    a, b, k = ZOO[case]
    (ea, eb), (ta, tb) = _pair(a, b, k)
    cap = ref_sym.out_cap_auto(ea, eb, exact=True)
    ref = spgemm_coo(ea, eb, out_cap=cap, accumulator=accumulator)
    got = rt.spgemm(ta, tb, accumulator=accumulator, check=True)
    assert got.cap == cap
    _same_coo(got, ref, exact=case != "float")
    np.testing.assert_allclose(got.to_dense().numpy(), a @ b, atol=1e-4)
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


@pytest.mark.parametrize("case", ["skewed", "empty"])
def test_out_cap_auto_is_the_reference_planners_cap(case):
    """With a pinned backend the reference planner sizes out_cap as
    round_up(max(1, nnz(C)), 128); the port's ``out_cap="auto"`` gives the
    same cap through its exact symbolic pass."""
    a, b, k = ZOO[case]
    (ea, eb), (ta, tb) = _pair(a, b, k)
    for accumulator in ("sort", "search"):
        plan = make_plan(ea, eb, backend=accumulator)
        assert rt.spgemm(ta, tb, accumulator=accumulator).cap == plan.out_cap


@pytest.mark.parametrize("accumulator", ["sort", "search"])
def test_truncation_matches_reference_and_raises(accumulator):
    rng = np.random.default_rng(1)
    (ea, eb), (ta, tb) = _pair(_int_sparse(rng, 32, 32, 0.4),
                               _int_sparse(rng, 32, 32, 0.4))
    full = int(ref_sym.exact_nnz(ea, eb))
    cap = full // 2
    ref = spgemm_coo(ea, eb, out_cap=cap, accumulator=accumulator)
    got = rt.spgemm(ta, tb, out_cap=cap, accumulator=accumulator)
    _same_coo(got, ref)
    assert bool(got.overflowed()) and int(got.ngroups) == full
    with pytest.raises(rt.AccumulatorOverflow):
        rt.spgemm(ta, tb, out_cap=cap, accumulator=accumulator, check=True)


def test_extreme_key_boundary():
    """n_rows·n_cols = 2³¹−2: keys span 0 … 2³¹−3 = KEY_INVALID−2; both
    accumulators stay exact and bit-identical to the reference."""
    n_rows, n_cols = 2, (1 << 30) - 1
    r = np.asarray([[0, 1], [1, 0]], np.int32)
    c = np.asarray([[0, n_cols - 1], [n_cols - 1, 0]], np.int32)
    ones = np.ones((2, 2), np.float32)
    ea = EllRows(val=jnp.asarray(ones), idx=jnp.asarray(r), n_rows=n_rows)
    eb = EllCols(val=jnp.asarray(ones), idx=jnp.asarray(c.T), n_cols=n_cols)
    ta = rt.from_numpy(ones, r, n_rows=n_rows, device="cpu")
    tb = rt.from_numpy(ones, c.T, n_cols=n_cols, device="cpu")
    for acc in ("sort", "search"):
        ref = spgemm_coo(ea, eb, out_cap=16, accumulator=acc, check=True)
        got = rt.spgemm(ta, tb, out_cap=16, accumulator=acc, check=True)
        _same_coo(got, ref)
        rows, cols, _, _ = rt.to_numpy(got)
        keys = [int(x) * n_cols + int(y) for x, y in zip(rows, cols) if x >= 0]
        assert keys[0] == 0 and keys[-1] == 2 ** 31 - 3


def test_oversized_space_reroutes_to_sort():
    """n_rows·n_cols ≥ 2³¹−1 cannot pack int32 keys: 'search' reroutes to
    the two-key 'sort', as the reference does; the packed path itself
    refuses such a space."""
    n_rows, n_cols = 4, 1 << 29                     # 2³¹ coordinates
    rng = np.random.default_rng(3)
    r = rng.integers(0, n_rows, (3, 5)).astype(np.int32)
    c = rng.integers(0, n_cols, (5, 3)).astype(np.int32)
    c[0, 0] = n_cols - 1
    v = rng.integers(1, 4, (3, 5)).astype(np.float32)
    w = rng.integers(1, 4, (5, 3)).astype(np.float32)
    ea = EllRows(val=jnp.asarray(v), idx=jnp.asarray(r), n_rows=n_rows)
    eb = EllCols(val=jnp.asarray(w), idx=jnp.asarray(c), n_cols=n_cols)
    ta = rt.from_numpy(v, r, n_rows=n_rows, device="cpu")
    tb = rt.from_numpy(w, c, n_cols=n_cols, device="cpu")
    ref = spgemm_coo(ea, eb, out_cap="auto", accumulator="search")
    for acc in ("search", "tiled", "stream"):
        _same_coo(rt.spgemm(ta, tb, accumulator=acc, check=True), ref)
    with pytest.raises(ValueError, match="exceeds packed int32"):
        kernels.ops.search_merge(torch.zeros(1, dtype=torch.int32),
                                 torch.zeros(1, dtype=torch.int32),
                                 torch.ones(1), n_rows, n_cols, out_cap=8)


@pytest.mark.parametrize("accumulator", ["sort", "search"])
def test_batched_matches_reference(accumulator):
    rng = np.random.default_rng(2)
    n, bsz, k = 24, 3, 10
    As = np.stack([_int_sparse(rng, n, n, 0.2) for _ in range(bsz)])
    Bs = np.stack([_int_sparse(rng, n, n, 0.2) for _ in range(bsz)])
    els = [ell_rows_from_dense(jnp.array(x), k) for x in As]
    ecs = [ell_cols_from_dense(jnp.array(x), k) for x in Bs]
    ea = EllRows(val=jnp.stack([x.val for x in els]),
                 idx=jnp.stack([x.idx for x in els]), n_rows=n)
    eb = EllCols(val=jnp.stack([x.val for x in ecs]),
                 idx=jnp.stack([x.idx for x in ecs]), n_cols=n)
    ta = rt.from_numpy(ea.val, ea.idx, n_rows=n, device="cpu")
    tb = rt.from_numpy(eb.val, eb.idx, n_cols=n, device="cpu")
    cap = 384
    ref = spgemm_coo_batched(ea, eb, cap, accumulator=accumulator)
    got = rt.spgemm(ta, tb, out_cap=cap, accumulator=accumulator, check=True)
    assert got.ngroups.shape == (bsz,)
    _same_coo(got, ref)
    np.testing.assert_array_equal(
        tsp.spgemm_dense_batched(ta, tb).numpy(),
        np.asarray(ref_sp.spgemm_dense_batched(ea, eb)))
    with pytest.raises(ValueError, match="concrete out_cap"):
        rt.spgemm(ta, tb)


def test_dense_streaming_and_spmm_match_reference():
    rng = np.random.default_rng(4)
    a, b = random_sparse(rng, 24, 40, 0.2), random_sparse(rng, 40, 32, 0.25)
    (ea, eb), (ta, tb) = _pair(a, b)
    for fn in ("spgemm_dense", "spgemm_streaming"):
        np.testing.assert_allclose(getattr(tsp, fn)(ta, tb).numpy(),
                                   np.asarray(getattr(ref_sp, fn)(ea, eb)),
                                   atol=1e-4)
    x = rng.standard_normal((40, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tsp.spmm_ell_dense(ta, torch.from_numpy(x)).numpy(),
        np.asarray(ref_sp.spmm_ell_dense(ea, jnp.asarray(x))), atol=1e-4)
    xd = rng.standard_normal((8, 40)).astype(np.float32)
    np.testing.assert_allclose(
        tsp.spmm_dense_ell(torch.from_numpy(xd), tb).numpy(),
        np.asarray(ref_sp.spmm_dense_ell(jnp.asarray(xd), eb)), atol=1e-4)
    ai, bi = _int_sparse(rng, 16, 16, 0.3), _int_sparse(rng, 16, 16, 0.3)
    got = tsp.spgemm_from_dense(ai, bi, 16, 16, 256, device="cpu")
    _same_coo(got, ref_sp.spgemm_from_dense(jnp.asarray(ai), jnp.asarray(bi),
                                            16, 16, 256))


def test_symbolic_counts_match_reference():
    rng = np.random.default_rng(5)
    (ea, eb), (ta, tb) = _pair(_int_sparse(rng, 40, 32, 0.2),
                               _int_sparse(rng, 32, 48, 0.3))
    for name in ("product_count", "upper_bound_nnz", "exact_nnz"):
        assert int(getattr(tsym, name)(ta, tb)) == \
            int(getattr(ref_sym, name)(ea, eb)), name
    for name in ("product_count_rows", "exact_nnz_rows"):
        np.testing.assert_array_equal(getattr(tsym, name)(ta, tb).numpy(),
                                      np.asarray(getattr(ref_sym, name)(ea, eb)))
    for exact in (True, False):
        assert tsym.out_cap_auto(ta, tb, exact=exact, slack=1.5) == \
            ref_sym.out_cap_auto(ea, eb, exact=exact, slack=1.5)


def test_poison_overflow_matches_reference():
    from repro.core.formats import coo_from_dense
    eye = np.eye(4, dtype=np.float32)
    coo = rt.coo_from_dense(eye, 8, device="cpu")
    ref = coo_from_dense(jnp.asarray(eye), 8)
    for dropped in (0, 3):
        got = tsp._poison_overflow(coo, torch.tensor(dropped))
        want = ref_sp._poison_overflow(ref, jnp.int32(dropped))
        assert int(got.ngroups) == int(want.ngroups)
        assert bool(got.overflowed()) == bool(want.overflowed()) \
            == (dropped > 0)


@pytest.mark.parametrize("kwargs", [
    dict(call="make_structure", backend="sort", n_dev=2),
    dict(mesh="cpu mesh of 2", axis="x"),
    dict(mesh=object(), axis="x"),
])
def test_unported_routes_raise(kwargs):
    """The two calls that raised until the distributed slice was ported now
    run, on a CPU mesh of 2: ``make_structure(..., n_dev=2)`` returns a
    structure whose ``dist_plan()`` equals the reference's
    ``make_dist_plan(..., n_dev=2)``, and ``spgemm(..., mesh=, axis=)``
    equals the single-device result. A ``mesh=`` that is not a port
    ``Mesh`` raises ``TypeError``."""
    from repro.plan import make_dist_plan as ref_make_dist_plan
    (ea, eb), (ta, tb) = _pair(*ZOO["dup_heavy"][:2])
    kwargs = dict(kwargs)
    if kwargs.pop("call", None) == "make_structure":
        st = rt.make_structure(ta, tb, **kwargs)
        got = st.dist_plan()
        want = ref_make_dist_plan(ea, eb, n_dev=2, backend="sort")
        for f in dataclasses.fields(want):
            if f.name not in ("base", "est"):
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.base.backend == want.base.backend == "sort"
        assert got.est == want.est
        return
    if not isinstance(kwargs["mesh"], str):
        with pytest.raises(TypeError, match="parallel.Mesh"):
            rt.spgemm(ta, tb, **kwargs)
        return
    kwargs["mesh"] = rt.parallel.make_mesh((2,), ("x",), devices=["cpu"] * 2)
    got = rt.spgemm(ta, tb, check=True, **kwargs)
    want = rt.spgemm(ta, tb, check=True)
    for f in ("row", "col", "val", "ngroups"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    _same_coo(got, spgemm_coo(ea, eb, out_cap="auto"))


@pytest.mark.parametrize("kwargs,match", [
    (dict(axis="x"), "axis= requires mesh="),
    (dict(mesh=object()), "mesh= requires axis=")])
def test_half_given_mesh_raises_value_error(kwargs, match):
    """``mesh=`` without ``axis=``, or ``axis=`` without ``mesh=``, is a
    caller's error (``ValueError``), as the reference raises on the same
    operands, before the mesh's type is looked at."""
    from repro.core.api import spgemm as ref_spgemm
    (ea, eb), (ta, tb) = _pair(*ZOO["dup_heavy"][:2])
    with pytest.raises(ValueError, match=match):
        rt.spgemm(ta, tb, **kwargs)
    with pytest.raises(ValueError, match=match):
        ref_spgemm(ea, eb, **kwargs)


@pytest.mark.parametrize("accumulator", ["sort", "search"])
def test_sharded_keywords_are_ignored_without_a_mesh(accumulator):
    """``schedule``/``dist_plan``/``overlap`` steer only the sharded paths:
    without a mesh the port ignores them, whatever their values, and gives
    the call without them, as the reference does."""
    from repro.core.api import spgemm as ref_spgemm
    a, b, k = ZOO["skewed"]
    (ea, eb), (ta, tb) = _pair(a, b, k)
    plain = rt.spgemm(ta, tb, accumulator=accumulator)
    same = rt.spgemm(ta, tb, accumulator=accumulator, schedule="auto",
                     dist_plan=None, overlap=True)
    for f in ("row", "col", "val", "ngroups"):
        assert torch.equal(getattr(same, f), getattr(plain, f))
    ring = rt.spgemm(ta, tb, accumulator=accumulator, schedule="ring",
                     overlap=False)
    _same_coo(ring, ref_spgemm(ea, eb, accumulator=accumulator,
                               schedule="ring", overlap=False))


@pytest.mark.parametrize("backend", ["sort", "stream"])
def test_make_plan_mem_budget_is_ignored_with_a_pinned_backend(backend):
    """``mem_budget`` feeds only the backend selection: with a pinned
    backend even a one-byte budget leaves the plan as it was, as in the
    reference, whose plan it still equals."""
    from repro_torch.plan import planner as tpl
    (ea, eb), (ta, tb) = _pair(*ZOO["skewed"][:2])
    plan = rt.make_plan(ta, tb, backend=backend)
    assert rt.make_plan(ta, tb, backend=backend, mem_budget=1) == plan
    ref = make_plan(ea, eb, backend=backend, mem_budget=1)
    for f in dataclasses.fields(plan):
        assert getattr(plan, f.name) == getattr(ref, f.name), f.name
    assert tpl.DEFAULT_MEM_BUDGET == 1 << 30


def test_unknown_accumulator_raises():
    (_, _), (ta, tb) = _pair(*ZOO["dup_heavy"][:2])
    with pytest.raises(ValueError, match="unknown accumulator"):
        rt.spgemm(ta, tb, accumulator="nope")


# ---------------------------------------------------------------------------
# Guards: no JAX in the port, no silent CPU fallback, no phantom launches
# ---------------------------------------------------------------------------

def test_port_and_chip_smoke_import_no_jax():
    code = ("import sys, repro_torch, repro_torch.core.api, "
            "repro_torch.plan.symbolic, repro_torch.plan.planner, "
            "repro_torch.plan.structure, repro_torch.kernels._build, "
            "repro_torch.kernels.bitonic_merge, "
            "repro_torch.kernels.radix_bucket, "
            "repro_torch.kernels.hash_accum, "
            "repro_torch.kernels.fused_sccp_stream, "
            "repro_torch.core.streaming, repro_torch.plan.cache, "
            "repro_torch.core.hwmodel, repro_torch.obs.roofline, "
            "repro_torch.core.hybrid, repro_torch.serve.engine, "
            "repro_torch.core.distributed, repro_torch.parallel.mesh, "
            "chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro')\n"
            "assert not bad, bad\nprint('clean')")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO / "src"), str(REPO)])
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_no_cuda_means_no_device_and_no_launches():
    if torch.cuda.is_available():
        assert rt.default_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.default_device()
    a = np.eye(4, dtype=np.float32)
    for make in (lambda: rt.ell_rows_from_dense(a, 1),
                 lambda: rt.ell_cols_from_dense(a, 1, device="cuda"),
                 lambda: rt.coo_from_dense(a, 4, device="cuda"),
                 lambda: rt.from_numpy(a, a.astype(np.int32), n_rows=4,
                                       device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    kernels.reset_launch_counts()
    ta = rt.ell_rows_from_dense(a, 1, device="cpu")
    tb = rt.ell_cols_from_dense(a, 1, device="cpu")
    rt.spgemm(ta, tb, accumulator="search")
    rt.spgemm(ta, tb, accumulator="stream")
    rt.spgemm(ta, tb, structure=rt.make_structure(ta, tb, backend="stream"))
    val, row, col = tsp.sccp_multiply(ta, tb)
    kernels.ops.search_merge(row, col, val, 4, 4, out_cap=8, faithful=True)
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)
