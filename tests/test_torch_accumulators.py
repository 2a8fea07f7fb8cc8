"""repro_torch's 'tiled', 'bucket' and 'hash' accumulators and its pinned
planner against the JAX reference on the CPU.

The same numpy operands go through ``repro`` and ``repro_torch``. On
integer-valued operands (every float32 sum exact in any order) the sorted COO
is bit-identical: across the matrix zoo, truncation, undersized bucket and
table caps (drops poison ``ngroups``), a hand-built multi-bucket plan, the
extreme-key boundary, the ≥ 2³¹−1 reroute and the batched path; the float
case differs only in summation order (``rtol=atol=1e-5``). The planner's
``Plan`` and the sparsity fingerprint equal the reference's, so either
package's plan runs in the other.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import repro_torch as rt
from repro.core import spgemm_coo, spgemm_coo_batched
from repro.core import spgemm as ref_sp
from repro.core.formats import EllCols, EllRows
from repro.kernels.bitonic_merge import sort_tiles_xla
from repro.kernels import hash_accum as ref_ha
from repro.kernels import radix_bucket as ref_rb
from repro.plan import make_plan as ref_make_plan
from repro.plan import symbolic as ref_sym
from repro.plan.planner import Plan as RefPlan
from repro.plan.structure import fingerprint as ref_fingerprint
from repro_torch import kernels
from repro_torch.core import spgemm as tsp
from repro_torch.kernels import hash_accum as tha
from repro_torch.kernels import radix_bucket as trb
from repro_torch.plan import make_plan, planner, structure
from repro_torch.plan import symbolic as tsym

from test_torch_spgemm import ZOO, _int_sparse, _pair, _same_coo

BACKENDS = ["tiled", "bucket", "hash"]
KI = 2 ** 31 - 1


def _plan_fields(plan):
    return {f.name: getattr(plan, f.name)
            for f in dataclasses.fields(planner.Plan)}


@pytest.mark.parametrize("accumulator", BACKENDS)
@pytest.mark.parametrize("case", sorted(ZOO))
def test_backends_match_reference_zoo(case, accumulator):
    """The zoo through the front door with ``out_cap="auto"``: bit-identical
    to the reference (float case: summation order only), which plans the
    same cap and blocking sizes; the reference's plan runs in the port too."""
    a, b, k = ZOO[case]
    (ea, eb), (ta, tb) = _pair(a, b, k)
    ref = spgemm_coo(ea, eb, accumulator=accumulator)
    got = rt.spgemm(ta, tb, accumulator=accumulator, check=True)
    _same_coo(got, ref, exact=case != "float")
    np.testing.assert_allclose(got.to_dense().numpy(), a @ b, atol=1e-4)
    plan = ref_make_plan(ea, eb, backend=accumulator)
    _same_coo(rt.spgemm(ta, tb, plan=plan), ref, exact=case != "float")
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


@pytest.mark.parametrize("accumulator", BACKENDS)
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


@pytest.mark.parametrize("accumulator,sizes", [
    ("bucket", dict(n_buckets=4, bucket_cap=128)),
    ("hash", dict(n_blocks=2, block_cap=128)),
    ("hash", dict(max_probes=1)),
])
def test_undersized_caps_poison_like_reference(accumulator, sizes):
    """A plan too small for the stream drops products; the drop set, the
    kept totals and the poisoned ``ngroups`` equal the reference's, and
    ``check=True`` raises."""
    rng = np.random.default_rng(11)
    (ea, eb), (ta, tb) = _pair(_int_sparse(rng, 40, 40, 0.3),
                               _int_sparse(rng, 40, 40, 0.3))
    plan = dataclasses.replace(ref_make_plan(ea, eb, backend=accumulator),
                               **sizes)
    ref = spgemm_coo(ea, eb, plan=plan)
    got = rt.spgemm(ta, tb, plan=plan)
    _same_coo(got, ref)
    assert bool(got.overflowed())
    with pytest.raises(rt.AccumulatorOverflow):
        rt.spgemm(ta, tb, plan=plan, check=True)


def test_multi_bucket_hand_built_plan():
    rng = np.random.default_rng(12)
    (ea, eb), (ta, tb) = _pair(_int_sparse(rng, 48, 40, 0.3),
                               _int_sparse(rng, 40, 48, 0.3))
    cap = ref_sym.out_cap_auto(ea, eb)
    for accumulator, sizes in (("bucket", dict(n_buckets=8, bucket_cap=4096)),
                               ("hash", dict(n_blocks=8, block_cap=1024))):
        ref = spgemm_coo(ea, eb, plan=RefPlan(backend=accumulator,
                                              out_cap=cap, **sizes))
        got = rt.spgemm(ta, tb, plan=planner.Plan(backend=accumulator,
                                                  out_cap=cap, **sizes),
                        check=True)
        _same_coo(got, ref)


@pytest.mark.parametrize("accumulator", BACKENDS)
def test_extreme_key_boundary(accumulator):
    """n_rows·n_cols = 2³¹−2: keys span 0 … KEY_INVALID−2, right below the
    run-tail sentinel; every backend stays exact and bit-identical."""
    n_rows, n_cols = 2, (1 << 30) - 1
    r = np.asarray([[0, 1], [1, 0]], np.int32)
    c = np.asarray([[0, n_cols - 1], [n_cols - 1, 0]], np.int32)
    ones = np.ones((2, 2), np.float32)
    ea = EllRows(val=jnp.asarray(ones), idx=jnp.asarray(r), n_rows=n_rows)
    eb = EllCols(val=jnp.asarray(ones), idx=jnp.asarray(c.T), n_cols=n_cols)
    ta = rt.from_numpy(ones, r, n_rows=n_rows, device="cpu")
    tb = rt.from_numpy(ones, c.T, n_cols=n_cols, device="cpu")
    for out_cap in (16, "auto"):
        ref = spgemm_coo(ea, eb, out_cap=out_cap, accumulator=accumulator,
                         check=True)
        got = rt.spgemm(ta, tb, out_cap=out_cap, accumulator=accumulator,
                        check=True)
        _same_coo(got, ref)
    rows, cols, _, _ = rt.to_numpy(got)
    keys = [int(x) * n_cols + int(y) for x, y in zip(rows, cols) if x >= 0]
    assert keys[0] == 0 and keys[-1] == 2 ** 31 - 3


@pytest.mark.parametrize("accumulator", BACKENDS)
def test_oversized_space_reroutes_to_sort(accumulator):
    n_rows, n_cols = 4, 1 << 29                     # 2³¹ coordinates
    rng = np.random.default_rng(3)
    r = rng.integers(0, n_rows, (3, 5)).astype(np.int32)
    c = rng.integers(0, n_cols, (5, 3)).astype(np.int32)
    v = rng.integers(1, 4, (3, 5)).astype(np.float32)
    w = rng.integers(1, 4, (5, 3)).astype(np.float32)
    ea = EllRows(val=jnp.asarray(v), idx=jnp.asarray(r), n_rows=n_rows)
    eb = EllCols(val=jnp.asarray(w), idx=jnp.asarray(c), n_cols=n_cols)
    ta = rt.from_numpy(v, r, n_rows=n_rows, device="cpu")
    tb = rt.from_numpy(w, c, n_cols=n_cols, device="cpu")
    ref = spgemm_coo(ea, eb, accumulator=accumulator)
    _same_coo(rt.spgemm(ta, tb, accumulator=accumulator, check=True), ref)
    _same_coo(rt.spgemm(ta, tb, out_cap=64, accumulator=accumulator),
              spgemm_coo(ea, eb, out_cap=64, accumulator=accumulator))
    with pytest.raises(ValueError, match="packed int32"):
        make_plan(ta, tb, backend=accumulator)
    with pytest.raises(ValueError, match="exceeds packed int32"):
        getattr(kernels.ops, f"{accumulator}_merge"
                if accumulator != "tiled" else "sort_merge")(
            torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
            torch.ones(1), n_rows, n_cols)


@pytest.mark.parametrize("accumulator", BACKENDS)
def test_batched_with_plan_matches_reference(accumulator):
    """A plan from one representative slice serves the batch (its
    fingerprint is not checked against the other slices), as in the
    reference."""
    rng = np.random.default_rng(2)
    n, bsz, k = 24, 3, 10
    pairs = [_pair(_int_sparse(rng, n, n, 0.2), _int_sparse(rng, n, n, 0.2),
                   k) for _ in range(bsz)]
    ea = EllRows(val=jnp.stack([p[0][0].val for p in pairs]),
                 idx=jnp.stack([p[0][0].idx for p in pairs]), n_rows=n)
    eb = EllCols(val=jnp.stack([p[0][1].val for p in pairs]),
                 idx=jnp.stack([p[0][1].idx for p in pairs]), n_cols=n)
    ta = rt.from_numpy(ea.val, ea.idx, n_rows=n, device="cpu")
    tb = rt.from_numpy(eb.val, eb.idx, n_cols=n, device="cpu")
    plan = ref_make_plan(*pairs[0][0], backend=accumulator, slack=1.5)
    ref = spgemm_coo_batched(ea, eb, plan=plan)
    got = rt.spgemm(ta, tb, plan=plan)
    assert got.ngroups.shape == (bsz,)
    _same_coo(got, ref)
    tplan = make_plan(*pairs[0][1], backend=accumulator, slack=1.5)
    _same_coo(rt.spgemm(ta, tb, plan=tplan), ref)


def test_tiled_small_tile_runs_the_merge_tree():
    """tile=256 under a 4,096-lane stream: four merge levels, bit-identical
    to the reference's merge tree at the same tile."""
    rng = np.random.default_rng(6)
    (ea, eb), (ta, tb) = _pair(_int_sparse(rng, 32, 32, 0.25),
                               _int_sparse(rng, 32, 32, 0.25))
    assert ea.k * ea.n_cols * eb.k > 2048
    ref = spgemm_coo(ea, eb, accumulator="tiled", tile=256)
    got = rt.spgemm(ta, tb, accumulator="tiled", tile=256, check=True)
    _same_coo(got, ref)
    plan = dataclasses.replace(make_plan(ta, tb, backend="tiled"), tile=256)
    _same_coo(rt.spgemm(ta, tb, plan=plan), ref)


# ---------------------------------------------------------------------------
# The planner and the fingerprint
# ---------------------------------------------------------------------------

PLAN_CASES = ["square", "rect", "skewed", "empty"]


@pytest.mark.parametrize("backend", list(planner.BACKENDS))
@pytest.mark.parametrize("case", PLAN_CASES)
def test_make_plan_matches_reference(case, backend):
    """Every field of a pinned-backend plan, fingerprint included, with the
    symbolic cap and with a pinned out_cap (the row-flop bound branch)."""
    a, b, k = ZOO[case]
    (ea, eb), (ta, tb) = _pair(a, b, k)
    for kw in (dict(), dict(out_cap=256), dict(slack=1.3, tile=512)):
        got = make_plan(ta, tb, backend=backend, **kw)
        want = ref_make_plan(ea, eb, backend=backend, **kw)
        assert _plan_fields(got) == _plan_fields(want), kw


def test_symbolic_histograms_match_reference():
    rng = np.random.default_rng(5)
    (ea, eb), (ta, tb) = _pair(_int_sparse(rng, 40, 32, 0.2),
                               _int_sparse(rng, 32, 48, 0.3))
    np.testing.assert_array_equal(tsym.per_slab_products(ta, tb).numpy(),
                                  np.asarray(ref_sym.per_slab_products(ea, eb)))
    assert int(tsym.max_slab_products(ta, tb)) == \
        int(ref_sym.max_slab_products(ea, eb))
    for exact in (True, False):
        for g, w in zip(tsym.per_row_counts(ta, tb, exact=exact),
                        ref_sym.per_row_counts(ea, eb, exact=exact)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fingerprint_matches_reference_and_stale_plans_raise():
    rng = np.random.default_rng(7)
    (ea, eb), (ta, tb) = _pair(_int_sparse(rng, 24, 24, 0.3),
                               _int_sparse(rng, 24, 24, 0.3))
    assert structure.fingerprint(ta, tb) == ref_fingerprint(ea, eb)
    (ea2, eb2), (ta2, tb2) = _pair(_int_sparse(rng, 24, 24, 0.3),
                                   _int_sparse(rng, 24, 24, 0.3), ea.k)
    assert structure.fingerprint(ta2, tb2) != structure.fingerprint(ta, tb)
    tplan = make_plan(ta, tb, backend="hash")
    rplan = ref_make_plan(ea, eb, backend="hash")
    # each package runs the other's plan
    _same_coo(rt.spgemm(ta, tb, plan=rplan), spgemm_coo(ea, eb, plan=tplan))
    for plan in (tplan, rplan):
        with pytest.raises(ValueError, match="stale plan"):
            rt.spgemm(ta2, tb2, plan=plan)
    with pytest.raises(ValueError, match="stale plan"):
        spgemm_coo(ea2, eb2, plan=tplan)
    loose = dataclasses.replace(tplan, fp=None, out_cap=1024)
    _same_coo(rt.spgemm(ta2, tb2, plan=loose),
              spgemm_coo(ea2, eb2, plan=loose))


# ---------------------------------------------------------------------------
# The accumulations' building blocks
# ---------------------------------------------------------------------------

def _packed(seed, n, hi, n_valid, dup=1):
    rng = np.random.default_rng(seed)
    key = np.repeat(rng.integers(0, hi, -(-n // dup)), dup)[:n]
    key = rng.permutation(key).astype(np.int32)
    key[n_valid:] = KI
    val = rng.integers(-4, 5, n).astype(np.float32)
    val[n_valid:] = 0
    return key, val


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_hash_matches_reference():
    keys = np.concatenate([np.arange(4096), [KI, KI - 1, KI - 2, 1 << 30],
                           np.random.default_rng(0).integers(0, KI, 4096)])
    keys = keys.astype(np.int32)
    for cap in (128, 1 << 20):
        np.testing.assert_array_equal(
            tha._hash(torch.from_numpy(keys), cap).numpy(),
            np.asarray(ref_ha._hash(jnp.asarray(keys), cap)))


@pytest.mark.parametrize("n_blocks,block_cap,max_probes", [
    (4, 256, None), (4, 256, 1), (2, 64, None), (1, 1024, 3)])
def test_hash_merge_matches_reference(n_blocks, block_cap, max_probes):
    """Table order, totals and the drop count, with and without drops
    (max_probes=1: the round-synchronous claim decides who stays)."""
    key, val = _packed(block_cap + n_blocks, 1024, 1500, 900, dup=2)
    kpb = -(-1500 // n_blocks)
    got = tha.hash_merge(torch.from_numpy(key), torch.from_numpy(val),
                         n_blocks=n_blocks, block_cap=block_cap,
                         keys_per_block=kpb, max_probes=max_probes)
    want = ref_ha.hash_merge(jnp.asarray(key), jnp.asarray(val),
                             n_blocks=n_blocks, block_cap=block_cap,
                             keys_per_block=kpb, max_probes=max_probes)
    _same(got, want)
    if max_probes == 1 or block_cap == 64:
        assert int(got[2]) > 0


@pytest.mark.parametrize("n_buckets,bucket_cap", [(4, 512), (8, 64), (1, 1024)])
def test_bucket_merge_matches_reference(n_buckets, bucket_cap):
    key, val = _packed(bucket_cap, 1024, 2000, 800, dup=3)
    kpb = trb.bucket_bounds(40, 50, n_buckets)
    assert kpb == ref_rb.bucket_bounds(40, 50, n_buckets)
    got = trb.bucket_merge(torch.from_numpy(key), torch.from_numpy(val),
                           n_buckets=n_buckets, bucket_cap=bucket_cap,
                           keys_per_bucket=kpb)
    want = ref_rb.bucket_merge(jnp.asarray(key), jnp.asarray(val),
                               n_buckets=n_buckets, bucket_cap=bucket_cap,
                               keys_per_bucket=kpb)
    _same(got, want)


def test_coo_from_merged_matches_reference():
    """Compaction of a merged stream: tails by cumsum, truncation to the
    first out_cap groups, ngroups the true count."""
    key, val = _packed(5, 512, 300, 400, dup=2)
    k, t = (np.array(x) for x in sort_tiles_xla(jnp.asarray(key),
                                                 jnp.asarray(val), tile=512))
    for out_cap in (512, 128):
        _same_coo(tsp._coo_from_merged(torch.from_numpy(k),
                                       torch.from_numpy(t), out_cap, 20, 15),
                  ref_sp._coo_from_merged(jnp.asarray(k), jnp.asarray(t),
                                          out_cap, 20, 15))
