"""repro_torch's streaming engine ('stream') against the JAX reference on the
CPU.

The same numpy operands go through ``repro`` and ``repro_torch``. On
integer-valued operands (every float32 sum exact in any order) the sorted
COO of the slab-group engine is bit-identical to the reference's and to the
port's ``'sort'``: across the matrix zoo, every slab grouping, the flat
chunked path, undersized ``stream_cap`` and ``out_cap`` (drops poison
``ngroups``), the batched path and the extreme-key boundary; the float case
differs only in summation order (``rtol=atol=1e-5``). The engine's pieces
are held against the reference's too: the fused slab sort's plain twin
against the Pallas kernel (interpret mode) and its XLA realization, the merge
step and the compaction.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import repro
import repro_torch as rt
from repro.core import accumulate_stream as ref_accumulate_stream
from repro.core import spgemm_coo, spgemm_coo_batched
from repro.core import streaming as ref_st
from repro.core.formats import EllCols, EllRows
from repro.core.sccp import sccp_multiply as ref_sccp
from repro.kernels import bitonic_merge as ref_bm
from repro.kernels.fused_sccp_stream import (fused_slab_sort_pallas,
                                             fused_slab_sort_xla)
from repro.plan import make_plan as ref_make_plan
from repro_torch import kernels
from repro_torch.core import spgemm as tsp
from repro_torch.core import streaming as tst
from repro_torch.kernels import bitonic_merge as tbm
from repro_torch.kernels import fused_sccp_stream as tfs
from repro_torch.plan import make_plan
from repro_torch.plan import symbolic as tsym

from test_torch_spgemm import ZOO, _int_sparse, _pair, _same_coo

KI = 2 ** 31 - 1


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_arrays(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("case", sorted(ZOO))
def test_stream_matches_reference_zoo(case):
    """The zoo through the front door with ``out_cap="auto"`` (the stream
    plan): bit-identical to the reference's stream and to the port's 'sort'
    at the same cap; the reference's plan runs in the port too."""
    a, b, k = ZOO[case]
    (ea, eb), (ta, tb) = _pair(a, b, k)
    exact = case != "float"
    ref = spgemm_coo(ea, eb, accumulator="stream")
    got = rt.spgemm(ta, tb, accumulator="stream", check=True)
    _same_coo(got, ref, exact=exact)
    _same_coo(rt.spgemm(ta, tb, out_cap=got.cap), ref, exact=exact)
    np.testing.assert_allclose(got.to_dense().numpy(), a @ b, atol=1e-4)
    plan = ref_make_plan(ea, eb, backend="stream")
    _same_coo(rt.spgemm(ta, tb, plan=plan), ref, exact=exact)
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


def test_stream_group_invariance_matches_reference():
    """Any slab grouping gives the same sorted COO, each the reference's
    under the same plan (the padded last group included)."""
    rng = np.random.default_rng(1)
    (ea, eb), (ta, tb) = _pair(_int_sparse(rng, 32, 32, 0.3),
                               _int_sparse(rng, 32, 32, 0.3))
    plan = make_plan(ta, tb, backend="stream")
    want = tsp.spgemm_coo(ta, tb, out_cap=plan.out_cap)
    for group in (1, 2, 3, ta.k):
        p = dataclasses.replace(plan, stream_group=group, stream_cap=None)
        got = tsp.spgemm_coo(ta, tb, accumulator="stream", plan=p, check=True)
        _same_coo(got, spgemm_coo(ea, eb, accumulator="stream", plan=p))
        _same_coo(got, spgemm_coo(ea, eb, out_cap=plan.out_cap))
        for f in ("row", "col", "val", "ngroups"):
            assert torch.equal(getattr(got, f), getattr(want, f))


def test_stream_flat_and_slab_paths_match_reference():
    """``accumulate_stream(backend='stream')`` on the materialized 3-D stream
    equals the never-materialized path (same tiles, same order), and the
    1-D chunked path equals 'sort', both as the reference gives them."""
    rng = np.random.default_rng(2)
    (ea, eb), (ta, tb) = _pair(_int_sparse(rng, 32, 32, 0.3),
                               _int_sparse(rng, 32, 32, 0.3))
    plan = make_plan(ta, tb, backend="stream")
    val, row, col = tsp.sccp_multiply(ta, tb)
    got = tsp.accumulate_stream(row, col, val, plan.out_cap, 32, 32,
                                backend="stream", plan=plan)
    _same_coo(got, tsp.spgemm_coo(ta, tb, accumulator="stream", plan=plan))
    rv, rr, rc = ref_sccp(ea, eb)
    _same_coo(got, ref_accumulate_stream(rr, rc, rv, plan.out_cap, 32, 32,
                                         backend="stream", plan=plan))
    flat = tsp.accumulate_stream(row.reshape(-1), col.reshape(-1),
                                 val.reshape(-1), 1024, 32, 32,
                                 backend="stream", tile=512)
    _same_coo(flat, ref_accumulate_stream(
        rr.reshape(-1), rc.reshape(-1), rv.reshape(-1), 1024, 32, 32,
        backend="stream", tile=512))
    _same_coo(flat, spgemm_coo(ea, eb, out_cap=1024))


@pytest.mark.parametrize("stream_cap", [2, 16])
def test_undersized_stream_cap_poisons_like_reference(stream_cap):
    rng = np.random.default_rng(3)
    (ea, eb), (ta, tb) = _pair(_int_sparse(rng, 32, 32, 0.5),
                               _int_sparse(rng, 32, 32, 0.5))
    plan = make_plan(ta, tb, backend="stream")
    tiny = dataclasses.replace(plan, stream_cap=stream_cap)
    got = rt.spgemm(ta, tb, plan=tiny)
    _same_coo(got, spgemm_coo(ea, eb, accumulator="stream", plan=tiny))
    assert bool(got.overflowed())
    with pytest.raises(rt.AccumulatorOverflow):
        rt.spgemm(ta, tb, plan=tiny, check=True)
    assert not bool(rt.spgemm(ta, tb, plan=plan, check=True).overflowed())


def test_undersized_out_cap_overflows_like_reference():
    rng = np.random.default_rng(4)
    (ea, eb), (ta, tb) = _pair(_int_sparse(rng, 16, 16, 0.5),
                               _int_sparse(rng, 16, 16, 0.5))
    got = rt.spgemm(ta, tb, out_cap=4, accumulator="stream")
    _same_coo(got, spgemm_coo(ea, eb, out_cap=4, accumulator="stream"))
    with pytest.raises(rt.AccumulatorOverflow):
        rt.spgemm(ta, tb, out_cap=4, accumulator="stream", check=True)


def test_explicit_stream_cap_and_group_through_front_door():
    """``stream_cap=``/``group=`` route to ``spgemm_coo_stream``, as the
    reference's front door does; the batched form refuses them."""
    rng = np.random.default_rng(5)
    (ea, eb), (ta, tb) = _pair(_int_sparse(rng, 24, 24, 0.3),
                               _int_sparse(rng, 24, 24, 0.3))
    for kw in (dict(stream_cap=64, group=2), dict(group=3),
               dict(stream_cap=8)):
        got = rt.spgemm(ta, tb, accumulator="stream", **kw)
        _same_coo(got, repro.spgemm(ea, eb, accumulator="stream", **kw))
    ab = rt.EllRows(val=ta.val[None], idx=ta.idx[None], n_rows=ta.n_rows)
    bb = rt.EllCols(val=tb.val[None], idx=tb.idx[None], n_cols=tb.n_cols)
    with pytest.raises(ValueError, match="batched stream"):
        rt.spgemm(ab, bb, accumulator="stream", group=2)


def test_stream_batched_matches_reference():
    rng = np.random.default_rng(6)
    n, bsz, k = 24, 3, 10
    As = np.stack([_int_sparse(rng, n, n, 0.2) for _ in range(bsz)])
    Bs = np.stack([_int_sparse(rng, n, n, 0.2) for _ in range(bsz)])
    pairs = [_pair(As[i], Bs[i], k) for i in range(bsz)]
    ea = EllRows(val=jnp.stack([p[0][0].val for p in pairs]),
                 idx=jnp.stack([p[0][0].idx for p in pairs]), n_rows=n)
    eb = EllCols(val=jnp.stack([p[0][1].val for p in pairs]),
                 idx=jnp.stack([p[0][1].idx for p in pairs]), n_cols=n)
    ta = rt.EllRows(val=torch.stack([p[1][0].val for p in pairs]),
                    idx=torch.stack([p[1][0].idx for p in pairs]), n_rows=n)
    tb = rt.EllCols(val=torch.stack([p[1][1].val for p in pairs]),
                    idx=torch.stack([p[1][1].idx for p in pairs]), n_cols=n)
    plan = make_plan(*pairs[0][1], backend="stream", slack=2.0)
    ref = spgemm_coo_batched(ea, eb, accumulator="stream", plan=plan)
    got = rt.spgemm(ta, tb, accumulator="stream", plan=plan, check=True)
    assert tuple(got.ngroups.shape) == (bsz,)
    for f in ("row", "col", "val", "ngroups"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(ref, f)))


def test_planner_stream_sizing():
    """The stream plan the port makes is the reference's, groups a small
    operand's slabs (group > 1), and never drops: the compaction width
    covers any group tile's products."""
    rng = np.random.default_rng(7)
    (ea, eb), (ta, tb) = _pair(_int_sparse(rng, 48, 48, 0.2),
                               _int_sparse(rng, 48, 48, 0.2))
    plan = make_plan(ta, tb, backend="stream")
    want = ref_make_plan(ea, eb, backend="stream")
    assert (plan.stream_cap, plan.stream_group, plan.out_cap) == \
        (want.stream_cap, want.stream_group, want.out_cap)
    assert plan.stream_group > 1
    assert plan.stream_cap & (plan.stream_cap - 1) == 0
    assert plan.stream_cap >= plan.stream_group * int(
        tsym.max_slab_products(ta, tb))


def test_stream_extreme_key_boundary():
    """n_rows·n_cols = 2³¹−2: keys up to 2³¹−3 = KEY_INVALID−2 stream
    exactly, as in the reference; a space of 2³¹−1 is refused."""
    n_rows, n_cols = 2, (1 << 30) - 1
    r = np.asarray([[0, 1], [1, 0]], np.int32)
    c = np.asarray([[0, n_cols - 1], [n_cols - 1, 0]], np.int32)
    ones = np.ones((2, 2), np.float32)
    ea = EllRows(val=jnp.asarray(ones), idx=jnp.asarray(r), n_rows=n_rows)
    eb = EllCols(val=jnp.asarray(ones), idx=jnp.asarray(c.T), n_cols=n_cols)
    ta = rt.from_numpy(ones, r, n_rows=n_rows, device="cpu")
    tb = rt.from_numpy(ones, c.T, n_cols=n_cols, device="cpu")
    got = rt.spgemm(ta, tb, out_cap=16, accumulator="stream", check=True)
    _same_coo(got, spgemm_coo(ea, eb, out_cap=16, accumulator="stream"))
    rows, cols, _, _ = rt.to_numpy(got)
    keys = [int(x) * n_cols + int(y) for x, y in zip(rows, cols) if x >= 0]
    assert keys[0] == 0 and keys[-1] == 2 ** 31 - 3
    big = rt.from_numpy(ones, c.T, n_cols=n_cols + 1, device="cpu")
    with pytest.raises(ValueError, match="exceeds packed int32"):
        tst.spgemm_coo_stream(ta, big, out_cap=16)


# ---------------------------------------------------------------------------
# The engine's pieces
# ---------------------------------------------------------------------------

def _slab(seed, n, k_b, n_cols, dead=0.3, group=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if group is None else (group, n)
    a_val = rng.integers(-3, 4, shape).astype(np.float32)
    a_idx = np.where(rng.random(shape) < 1 - dead,
                     rng.integers(0, 64, shape), -1).astype(np.int32)
    b_val = rng.integers(-3, 4, (n, k_b)).astype(np.float32)
    b_idx = np.where(rng.random((n, k_b)) < 1 - dead,
                     rng.integers(0, n_cols, (n, k_b)), -1).astype(np.int32)
    return a_val, a_idx, b_val, b_idx


@pytest.mark.parametrize("n,k_b,n_cols,dead", [
    (96, 5, 64, 0.3),           # pot(480) = 512 lanes, ragged padding
    (16, 4, 8, 0.0),            # exactly 64 lanes, dense duplicates
    (40, 3, 100, 1.0),          # an all-invalid slab
])
def test_fused_slab_sort_plain_matches_pallas_and_xla(n, k_b, n_cols, dead):
    ops_in = _slab(n + k_b, n, k_b, n_cols, dead)
    got = tfs.fused_slab_sort_plain(*map(torch.from_numpy, ops_in),
                                    n_cols=n_cols)
    assert got[0].numel() == 1 << (n * k_b - 1).bit_length()
    jin = list(map(jnp.asarray, ops_in))
    _same_arrays(got, fused_slab_sort_xla(*jin, n_cols=n_cols))
    _same_arrays(got, fused_slab_sort_pallas(*jin, n_cols=n_cols,
                                             interpret=True))
    if dead == 1.0:
        assert bool((got[0] == KI).all()) and not bool(got[1].any())
    # the wrapper takes the plain twin for CPU operands and counts nothing
    kernels.reset_launch_counts()
    _same_arrays(tfs.fused_slab_sort(*map(torch.from_numpy, ops_in),
                                     n_cols=n_cols), got)
    assert kernels.launch_counts()["fused_slab_sort"] == 0


def test_fused_slab_sort_group_block_matches_reference_sort_tile():
    """A (group, n) block: the lanes the reference's ``_sort_tile`` sorts for
    a slab group, in its (group, n, k_b) order, and the extreme key."""
    group, n, k_b, n_cols = 3, 20, 4, 50
    a_val, a_idx, b_val, b_idx = _slab(11, n, k_b, n_cols, group=group)
    got = tfs.fused_slab_sort_plain(*map(torch.from_numpy,
                                         (a_val, a_idx, b_val, b_idx)),
                                    n_cols=n_cols)
    ok = (a_idx[:, :, None] >= 0) & (b_idx[None] >= 0)
    row = np.where(ok, a_idx[:, :, None], -1)
    col = np.where(ok, b_idx[None], -1)
    val = np.where(ok, a_val[:, :, None] * b_val[None], 0)
    _same_arrays(got, ref_st._sort_tile(jnp.asarray(row), jnp.asarray(col),
                                        jnp.asarray(val), n_cols))
    # row·n_cols + col = 2³¹−3 at n_rows·n_cols = 2³¹−2
    big = (1 << 30) - 1
    key, tot = tfs.fused_slab_sort_plain(
        torch.tensor([1.0, 2.0]), torch.tensor([1, 0], dtype=torch.int32),
        torch.tensor([[3.0], [4.0]]),
        torch.tensor([[big - 1], [big - 1]], dtype=torch.int32), n_cols=big)
    assert key.tolist() == [big - 1, 2 ** 31 - 3]
    assert tot.tolist() == [8.0, 3.0]


def test_fused_slab_sort_rejects_misaligned_operands():
    a_val, a_idx, b_val, b_idx = map(torch.from_numpy, _slab(0, 8, 2, 10))
    with pytest.raises(ValueError, match="fused_slab_sort"):
        tfs.fused_slab_sort(a_val[:7], a_idx[:7], b_val, b_idx, n_cols=10)


@pytest.mark.parametrize("length", [128, 256])
def test_merge_coalesce_pair_matches_reference(length):
    """One K6 level over two coalesced ascending lists (the buffer width down
    to its 128-lane minimum), as the reference's two-list network."""
    rng = np.random.default_rng(length)

    def coalesced(n_valid):
        key = np.full(length, KI, np.int32)
        key[:n_valid] = np.sort(rng.choice(3 * length, n_valid,
                                           replace=False))
        val = np.zeros(length, np.float32)
        val[:n_valid] = rng.integers(-4, 5, n_valid)
        return key, val

    ka, va = coalesced(length // 2)
    kb, vb = coalesced(length // 3)
    got = tbm.merge_coalesce_pair(*map(torch.from_numpy, (ka, va, kb, vb)))
    _same_arrays(got, ref_bm.merge_coalesce_pair(
        *map(jnp.asarray, (ka, va, kb, vb))))


def _unique_list(rng, length, n_valid, hi):
    """An ascending duplicate-free list: ``n_valid`` keys below ``hi`` with
    integer totals, then KEY_INVALID/0."""
    key = np.full(length, KI, np.int32)
    key[:n_valid] = np.sort(rng.choice(hi, n_valid, replace=False))
    val = np.zeros(length, np.float32)
    val[:n_valid] = rng.integers(-4, 5, n_valid)
    return key, val


@pytest.mark.parametrize("length,na,nb,cap,hi", [
    (128, 90, 17, 128, 1000),       # unequal valid lengths
    (256, 200, 150, 256, 300),      # many keys in both lists
    (128, 0, 60, 128, 500),         # an empty buffer (the first step)
    (128, 0, 0, 128, 10),           # nothing at all
    (256, 250, 240, 256, 400),      # uniques beyond cap: exact drops
    (256, 180, 160, 64, 1000),      # cap below the list length
])
def test_merge_compact_pair_plain_matches_reference(length, na, nb, cap, hi):
    """The stream's step on CPU tensors: the reference's
    ``merge_coalesce_pair`` followed by its ``_coalesce_compact``, bit for
    bit, ``count`` and ``dropped`` included; the step through
    ``streaming._merge_tile`` likewise."""
    rng = np.random.default_rng(length + na + nb + cap)
    ka, va = _unique_list(rng, length, na, hi)
    kb, vb = _unique_list(rng, length, nb, hi)
    got = tbm.merge_compact_pair(*map(torch.from_numpy, (ka, va, kb, vb)),
                                 cap=cap)
    mk, mt = ref_bm.merge_coalesce_pair(*map(jnp.asarray, (ka, va, kb, vb)))
    want = ref_st._coalesce_compact(mk, mt, cap)
    _same_arrays(got, want)
    assert got[2].dtype == torch.int32 and got[3].dtype == torch.int32
    if cap == length:
        state = tst.StreamState(
            key=torch.from_numpy(ka), tot=torch.from_numpy(va),
            count=torch.tensor(na, dtype=torch.int32),
            dropped=torch.tensor(2, dtype=torch.int32))
        step = tst._merge_tile(state, torch.from_numpy(kb),
                               torch.from_numpy(vb),
                               torch.tensor(nb, dtype=torch.int32),
                               torch.tensor(1, dtype=torch.int32))
        _same_arrays((step.key, step.tot, step.count), want[:3])
        assert int(step.dropped) == 3 + int(want[3])


@pytest.mark.parametrize("cap", [4, 64, 512])
def test_coalesce_compact_matches_reference(cap):
    rng = np.random.default_rng(cap)
    key = np.sort(np.concatenate([rng.integers(0, 80, 200),
                                  np.full(56, KI)])).astype(np.int32)
    val = rng.integers(-4, 5, 256).astype(np.float32)
    k_t, t_t = tbm.sort_tiles_plain(torch.from_numpy(key),
                                    torch.from_numpy(val), tile=256)
    got = tst._coalesce_compact(k_t, t_t, cap)
    want = ref_st._coalesce_compact(jnp.asarray(k_t.numpy()),
                                    jnp.asarray(t_t.numpy()), cap)
    _same_arrays(got, want)
