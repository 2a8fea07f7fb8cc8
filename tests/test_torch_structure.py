"""repro_torch's structures, warm numeric phase and structure cache against
the JAX reference on the CPU.

The same numpy operands go through ``repro`` and ``repro_torch``. A
structure's sorted keys, per-row counts, segment boundaries and true nnz
equal the reference's ``make_structure``; on integer-valued operands the warm
numeric phase is bit-identical to the cold path and to the reference's
numeric phase for every pinned backend (``'stream'`` by slab groups),
batched included; a stale structure raises, and with ``validate=False``
poisons ``ngroups`` as the reference's does. The cache's LRU order and disk
layer follow the reference, and each package reads the other's ``.npz``
files.
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import repro_torch as rt
from repro.core.formats import EllCols, EllRows
from repro.core.spgemm import spgemm_coo_numeric as ref_numeric
from repro.core.spgemm import spgemm_coo_numeric_batched as ref_numeric_batched
from repro.core.streaming import spgemm_coo_stream_numeric as ref_stream_numeric
from repro.plan import StructureCache as RefCache
from repro.plan import make_structure as ref_make_structure
from repro.plan import make_structure_batched as ref_make_structure_batched
from repro_torch import kernels
from repro_torch.core import spgemm as tsp
from repro_torch.core import streaming as tst
from repro_torch.plan import (StructureCache, make_structure,
                              make_structure_batched, planner)

from test_torch_spgemm import _int_sparse, _pair, _same_coo

BACKENDS = list(planner.BACKENDS)


def _operands(seed, n=40, m=32, p=36, density=0.1):
    rng = np.random.default_rng(seed)
    return _int_sparse(rng, n, m, density), _int_sparse(rng, m, p, density)


def _perturb_pattern(ad):
    """Move one nonzero to a zero slot of the same column, so the ELLPACK
    width is kept and the pattern changes."""
    out = ad.copy()
    r, c = np.argwhere(out != 0)[0]
    z = np.flatnonzero(out[:, c] == 0)[0]
    out[r, c], out[z, c] = 0.0, 3.0
    return out


def _same_structure(got, want):
    for f in ("key", "row_nnz", "seg", "nnz"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
        assert getattr(got, f).dtype == torch.int32, f
    assert (got.n_rows, got.n_cols, got.out_cap, got.fp) == \
        (want.n_rows, want.n_cols, want.out_cap, want.fp)
    fields = [f.name for f in dataclasses.fields(planner.Plan)]
    assert [getattr(got.plan, f) for f in fields] == \
        [getattr(want.plan, f) for f in fields]


# ---------------------------------------------------------------------------
# Structures and the numeric phase
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_numeric_bitident_per_backend(backend):
    """A structure per pinned backend equals the reference's; its numeric
    phase equals the cold path and the reference's numeric phase."""
    a, b = _operands(0)
    (ea, eb), (ta, tb) = _pair(a, b)
    st = make_structure(ta, tb, backend=backend)
    ref_st = ref_make_structure(ea, eb, backend=backend)
    _same_structure(st, ref_st)
    kernels.reset_launch_counts()
    warm = rt.spgemm(ta, tb, structure=st, check=True)
    cold = rt.spgemm(ta, tb, plan=st.plan, check=True)
    for f in ("row", "col", "val", "ngroups"):
        assert torch.equal(getattr(warm, f), getattr(cold, f)), f
    _same_coo(warm, ref_numeric(ea, eb, ref_st))
    np.testing.assert_array_equal(warm.to_dense().numpy(), a @ b)
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


def test_structure_counts_match_dense_pattern():
    a, b = _operands(1)
    (_, _), (ta, tb) = _pair(a, b)
    st = make_structure(ta, tb, backend="sort", out_cap=1024)
    pattern = (a != 0).astype(np.int64) @ (b != 0).astype(np.int64) > 0
    np.testing.assert_array_equal(st.row_nnz.numpy(), pattern.sum(1))
    np.testing.assert_array_equal(st.seg.numpy(),
                                  np.concatenate([[0], pattern.sum(1).cumsum()]))
    assert int(st.nnz) == int(pattern.sum()) and st.out_cap == 1024
    assert bool((st.key[int(st.nnz):] == 2 ** 31 - 1).all())
    with pytest.raises(ValueError, match="smaller than nnz"):
        make_structure(ta, tb, backend="sort", out_cap=128)


def test_value_only_update_reuses_structure():
    a, b = _operands(2)
    (_, _), (ta, tb) = _pair(a, b)
    st = make_structure(ta, tb, backend="stream")
    (_, _), (ta5, _) = _pair(a * 5, b, ta.k)
    warm = rt.spgemm(ta5, tb, structure=st)
    cold = rt.spgemm(ta5, tb, out_cap=st.out_cap)
    for f in ("row", "col", "val", "ngroups"):
        assert torch.equal(getattr(warm, f), getattr(cold, f)), f


def test_numeric_stream_entry_point_matches_reference():
    """``spgemm_coo_stream_numeric`` forces the slab-group scan on any
    structure, with the group of its plan (here grouped, stream_group > 1)."""
    a, b = _operands(3, n=48, m=48, p=48, density=0.2)
    (ea, eb), (ta, tb) = _pair(a, b)
    for backend in ("sort", "stream"):
        st = make_structure(ta, tb, backend=backend)
        got = tst.spgemm_coo_stream_numeric(ta, tb, st, check=True)
        _same_coo(got, ref_stream_numeric(
            ea, eb, ref_make_structure(ea, eb, backend=backend)))
        _same_coo(got, rt.spgemm(ta, tb, structure=st))
    assert st.plan.stream_group > 1


def test_numeric_batched_matches_reference():
    bsz, n, k = 3, 24, 8
    rng = np.random.default_rng(4)
    As = np.stack([_int_sparse(rng, n, n, 0.15) for _ in range(bsz)])
    Bs = np.stack([_int_sparse(rng, n, n, 0.15) for _ in range(bsz)])
    pairs = [_pair(As[i], Bs[i], k) for i in range(bsz)]
    ea = EllRows(val=jnp.stack([p[0][0].val for p in pairs]),
                 idx=jnp.stack([p[0][0].idx for p in pairs]), n_rows=n)
    eb = EllCols(val=jnp.stack([p[0][1].val for p in pairs]),
                 idx=jnp.stack([p[0][1].idx for p in pairs]), n_cols=n)
    ta = rt.EllRows(val=torch.stack([p[1][0].val for p in pairs]),
                    idx=torch.stack([p[1][0].idx for p in pairs]), n_rows=n)
    tb = rt.EllCols(val=torch.stack([p[1][1].val for p in pairs]),
                    idx=torch.stack([p[1][1].idx for p in pairs]), n_cols=n)
    st = make_structure_batched(ta, tb, backend="sort")
    ref_st = ref_make_structure_batched(ea, eb, backend="sort")
    assert st.batched and tuple(st.key.shape) == tuple(ref_st.key.shape)
    _same_structure(st, ref_st)
    warm = rt.spgemm(ta, tb, structure=st, check=True)
    ref = ref_numeric_batched(ea, eb, ref_st)
    for f in ("row", "col", "val", "ngroups"):
        np.testing.assert_array_equal(getattr(warm, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    cold = rt.spgemm(ta, tb, plan=dataclasses.replace(st.plan, fp=None))
    for f in ("row", "col", "val", "ngroups"):
        assert torch.equal(getattr(warm, f), getattr(cold, f)), f
    with pytest.raises(ValueError, match="unbatched"):
        tsp.spgemm_coo_numeric_batched(
            ta, tb, make_structure(*pairs[0][1], backend="sort"),
            validate=False)


@pytest.mark.parametrize("backend", ["sort", "stream"])
def test_stale_structure_raises_and_poisons_like_reference(backend):
    a, b = _operands(5)
    (ea, eb), (ta, tb) = _pair(a, b)
    a2 = _perturb_pattern(a)
    (ea2, _), (ta2, _) = _pair(a2, b, ta.k)
    st = make_structure(ta, tb, backend=backend)
    with pytest.raises(ValueError, match="stale structure"):
        rt.spgemm(ta2, tb, structure=st)
    got = rt.spgemm(ta2, tb, structure=st, validate=False)
    want = ref_numeric(ea2, eb, ref_make_structure(ea, eb, backend=backend),
                       validate=False)
    _same_coo(got, want)
    assert bool(got.overflowed()) and int(got.ngroups) > st.out_cap
    with pytest.raises(rt.AccumulatorOverflow):
        rt.spgemm(ta2, tb, structure=st, validate=False, check=True)


def test_structure_extreme_key_boundary():
    """n_rows·n_cols = 2³¹−2: the structure holds key 2³¹−3 and the numeric
    phase finds it, as in the reference."""
    n_rows, n_cols = 2, (1 << 30) - 1
    r = np.asarray([[0, 1], [1, 0]], np.int32)
    c = np.asarray([[0, n_cols - 1], [n_cols - 1, 0]], np.int32)
    ones = np.ones((2, 2), np.float32)
    ea = EllRows(val=jnp.asarray(ones), idx=jnp.asarray(r), n_rows=n_rows)
    eb = EllCols(val=jnp.asarray(ones), idx=jnp.asarray(c.T), n_cols=n_cols)
    ta = rt.from_numpy(ones, r, n_rows=n_rows, device="cpu")
    tb = rt.from_numpy(ones, c.T, n_cols=n_cols, device="cpu")
    for backend in ("sort", "stream"):
        st = make_structure(ta, tb, backend=backend, out_cap=128)
        assert int(st.key[int(st.nnz) - 1]) == 2 ** 31 - 3
        _same_structure(st, ref_make_structure(ea, eb, backend=backend,
                                               out_cap=128))
        _same_coo(rt.spgemm(ta, tb, structure=st, check=True),
                  rt.spgemm(ta, tb, out_cap=128))


# ---------------------------------------------------------------------------
# StructureCache
# ---------------------------------------------------------------------------

def test_cache_hit_on_value_only_change_and_miss_on_pattern_change():
    a, b = _operands(6)
    (_, _), (ta, tb) = _pair(a, b)
    cache = StructureCache(capacity=4)
    st = cache.get(ta, tb, backend="sort")
    (_, _), (ta7, _) = _pair(a * 7, b, ta.k)
    assert cache.get(ta7, tb, backend="sort") is st
    (_, _), (ta2, _) = _pair(_perturb_pattern(a), b, ta.k)
    st2 = cache.get(ta2, tb, backend="sort")
    assert st2 is not st
    assert cache.stats() == dict(hits=1, misses=2, evictions=0, disk_hits=0,
                                 autotuned=0, size=2)
    _same_coo(rt.spgemm(ta2, tb, structure=st2),
              rt.spgemm(ta2, tb, out_cap=st2.out_cap))
    cache.clear()
    assert cache.stats() == dict(hits=0, misses=0, evictions=0, disk_hits=0,
                                 autotuned=0, size=0)


def test_cache_lru_eviction_order():
    _, b = _operands(7)
    mats = []
    for s in range(3):
        ad = _int_sparse(np.random.default_rng(50 + s), 40, 32, 0.1)
        mats.append(rt.ell_rows_from_dense(
            ad, max(1, int((ad != 0).sum(0).max())), device="cpu"))
    tb = rt.ell_cols_from_dense(b, max(1, int((b != 0).sum(1).max())),
                                device="cpu")
    cache = StructureCache(capacity=2)
    cache.get(mats[0], tb, backend="sort")
    cache.get(mats[1], tb, backend="sort")
    cache.get(mats[0], tb, backend="sort")   # touch 0: 1 is least recent
    cache.get(mats[2], tb, backend="sort")   # evicts 1, not 0
    assert cache.stats()["evictions"] == 1
    hits = cache.stats()["hits"]
    cache.get(mats[0], tb, backend="sort")   # survived: a hit
    assert cache.stats()["hits"] == hits + 1
    cache.get(mats[1], tb, backend="sort")   # evicted: a miss
    assert cache.stats()["misses"] == 4


def test_cache_disk_round_trip(tmp_path):
    a, b = _operands(8)
    (_, _), (ta, tb) = _pair(a, b)
    st1 = StructureCache(capacity=4, cache_dir=str(tmp_path)).get(
        ta, tb, backend="stream")
    c2 = StructureCache(capacity=4, cache_dir=str(tmp_path))
    st2 = c2.get(ta, tb)
    assert c2.stats() == dict(hits=0, misses=0, evictions=0, disk_hits=1,
                              autotuned=0, size=1)
    for f in ("key", "row_nnz", "seg", "nnz"):
        assert torch.equal(getattr(st1, f), getattr(st2, f))
    assert st2.plan == st1.plan and st2.plan.backend == "stream"
    _same_coo(rt.spgemm(ta, tb, structure=st2), rt.spgemm(ta, tb,
                                                          structure=st1))
    for f in tmp_path.iterdir():                # corrupt: a plain miss
        f.write_bytes(b"not an npz")
    c3 = StructureCache(capacity=4, cache_dir=str(tmp_path))
    c3.get(ta, tb, backend="sort")
    assert c3.stats()["disk_hits"] == 0 and c3.stats()["misses"] == 1


@pytest.mark.parametrize("backend", ["sort", "stream"])
def test_cache_files_cross_packages(tmp_path, backend):
    """A file the reference's cache writes is a disk hit for the port's, and
    the other way round, with equal structures and plans."""
    a, b = _operands(9)
    (ea, eb), (ta, tb) = _pair(a, b)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_st = RefCache(cache_dir=str(ref_dir)).get(ea, eb, backend=backend)
    port = StructureCache(cache_dir=str(ref_dir))
    st = port.get(ta, tb)
    assert port.stats()["disk_hits"] == 1
    _same_structure(st, ref_st)
    _same_coo(rt.spgemm(ta, tb, structure=st), ref_numeric(ea, eb, ref_st))

    StructureCache(cache_dir=str(port_dir)).get(ta, tb, backend=backend)
    ref = RefCache(cache_dir=str(port_dir))
    back = ref.get(ea, eb)
    assert ref.stats()["disk_hits"] == 1
    _same_structure(st, back)


def test_cache_thread_safety():
    a, b = _operands(10)
    (_, _), (ta, tb) = _pair(a, b)
    (_, _), (ta2, _) = _pair(_perturb_pattern(a), b, ta.k)
    cache = StructureCache(capacity=8)
    errors = []

    def worker(op):
        try:
            for _ in range(6):
                cache.get(op, tb, backend="sort").validate(op, tb)
        except Exception as exc:  # noqa: BLE001 — surface any thread failure
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(ta if i % 2 else ta2,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    s = cache.stats()
    assert s["hits"] + s["misses"] == 48 and s["size"] == 2
