"""The port's CUDA kernels against their plain torch versions, on a GPU.

Every test is marked ``cuda`` and skips where there is no CUDA device (the
kernels have no CPU mode); the plain versions are themselves held against
the JAX reference by ``test_torch_kernels.py``. Run on a GPU machine with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it runs where only torch is installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch as rt
from repro_torch import kernels
from repro_torch.kernels import bitonic_merge as tbm
from repro_torch.kernels import ell_spmm as tes
from repro_torch.kernels import fused_sccp_stream as tfs
from repro_torch.kernels import insitu_search as tis
from repro_torch.kernels import nm_spmm as tnm
from repro_torch.kernels import radix_bucket as trb
from repro_torch.kernels import sccp_multiply as tsm

KI = tis.KEY_INVALID
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _keys(seed, n, hi, dead=0.1):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, hi, n).astype(np.int32)
    key[rng.random(n) < dead] = KI
    return torch.from_numpy(key)


@pytest.mark.parametrize("k_a,n,k_b", [(1, 1, 1), (5, 37, 3), (72, 1000, 72),
                                       (8, 4099, 16)])
def test_sccp_multiply_kernel(cuda, k_a, n, k_b):
    rng = np.random.default_rng(n)
    a_val = torch.from_numpy(rng.standard_normal((k_a, n)).astype(np.float32))
    b_val = torch.from_numpy(rng.standard_normal((n, k_b)).astype(np.float32))
    a_idx = torch.from_numpy(rng.integers(-1, 50, (k_a, n)).astype(np.int32))
    b_idx = torch.from_numpy(rng.integers(-1, 50, (n, k_b)).astype(np.int32))
    args = [t.to(cuda) for t in (a_val, a_idx, b_val, b_idx)]
    before = tsm.sccp_multiply.launches
    got = tsm.sccp_multiply(*args)
    torch.cuda.synchronize()
    assert tsm.sccp_multiply.launches == before + 1
    for g, w in zip(got, tsm.sccp_multiply_plain(*args)):
        assert torch.equal(g, w)
    with pytest.raises(TypeError):
        tsm.sccp_multiply(args[0].double(), *args[1:])


@pytest.mark.parametrize("n,tile", [(1, 4096), (2, 4096), (4096, 4096),
                                    (1 << 13, 4096), (1 << 20, 4096),
                                    (1 << 12, 64), (1 << 15, 256)])
def test_emit_sort_kernel(cuda, n, tile):
    key = _keys(n + tile, n, KI).to(cuda)
    before = tis.emit_sort_keys.launches
    got = tis.emit_sort_keys(key, tile=tile)
    torch.cuda.synchronize()
    assert tis.emit_sort_keys.launches > before
    assert torch.equal(got, tis.emit_sort_keys_plain(key))
    with pytest.raises(ValueError):
        tis.emit_sort_keys(key[: n - 1] if n > 2 else key, tile=3)


@pytest.mark.parametrize("s,u,pad", [(1, 1, 0), (1000, 300, 0),
                                     (1 << 20, 1 << 16, 1000),
                                     (4096, 4096, 4096)])
def test_align_keys_kernel(cuda, s, u, pad):
    rng = np.random.default_rng(s + u)
    uk = np.sort(rng.choice(1 << 24, u - pad, replace=False)).astype(np.int32)
    uk = torch.from_numpy(np.concatenate([uk, np.full(pad, KI, np.int32)]))
    pk = _keys(u, s, 1 << 24).to(cuda)
    if u > pad:                                        # plenty of hits
        pk[: s // 2] = uk[torch.randint(0, u - pad, (s // 2,))].to(cuda)
    uk = uk.to(cuda)
    slot, hit = tis.align_keys(pk, uk)
    slot_p, hit_p = tis.align_keys_plain(pk, uk)
    torch.cuda.synchronize()
    assert torch.equal(slot, slot_p) and torch.equal(hit, hit_p)


@pytest.mark.parametrize("n,hi,dead", [(1, 8, 0.0), (1000, 4, 0.2),
                                       (1 << 20, 1 << 30, 0.1),
                                       (3000, 100, 1.0)])
def test_minima_mask_kernel(cuda, n, hi, dead):
    v = _keys(n, n, hi, dead).to(cuda)
    got = tis.minima_mask(v)
    torch.cuda.synchronize()
    assert torch.equal(got, tis.minima_mask_plain(v))


@pytest.mark.parametrize("cap", [64, 600])
def test_faithful_emission_matches_batched(cuda, cap):
    key = _keys(cap, 1024, 500).to(cuda)
    uk_f, nnz_f = tis.emit_sorted_unique(key, cap, faithful=True)
    uk_b, nnz_b = tis.emit_sorted_unique(key, cap)
    assert torch.equal(uk_f, uk_b)
    n_uniq = int(nnz_b)
    assert int(nnz_f) == (n_uniq if n_uniq <= cap else cap + 1)


def _pairs(seed, n, hi, dead=0.1):
    """Keys from a small range (long runs of duplicates across tile and row
    edges), integer values (every total exact), dead lanes."""
    key = _keys(seed, n, hi, dead)
    rng = np.random.default_rng(seed + 1)
    val = torch.from_numpy(rng.integers(-4, 5, n).astype(np.float32))
    val[key == KI] = 0
    return key, val


def _same_pairs(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n,tile,hi", [
    (1, 1, 8), (2, 2, 8), (256, 64, 40),             # rows inside one tile
    (1 << 14, 4096, 1 << 12),                        # 'tiled' rows
    (1 << 15, 8192, 300),                            # rows of two tiles
    (4 * (1 << 16), 1 << 16, 1 << 20),               # odd rows ascend too
    (1 << 21, 1 << 20, 1 << 10),                     # 'bucket'-sized rows
])
def test_sort_tiles_kernel(cuda, n, tile, hi):
    key, val = (t.to(cuda) for t in _pairs(n + tile, n, hi))
    before = tbm.sort_tiles.launches
    got = tbm.sort_tiles(key, val, tile=tile)
    torch.cuda.synchronize()
    assert tbm.sort_tiles.launches > before
    _same_pairs(got, tbm.sort_tiles_plain(key, val, tile=tile))
    rows = got[0].view(-1, tile)
    assert bool((rows[:, 1:] >= rows[:, :-1]).all())  # every row ascends


@pytest.mark.parametrize("n,run", [(2, 1), (1024, 64), (1 << 13, 2048),
                                   (1 << 14, 4096), (1 << 15, 8192),
                                   (1 << 18, 1 << 16)])
def test_merge_runs_kernel(cuda, n, run):
    key, val = (t.to(cuda) for t in _pairs(n + run, n, max(2, n // 4)))
    key, val = tbm.sort_tiles_plain(key, val, tile=run)
    before = tbm.merge_runs.launches
    got = tbm.merge_runs(key, val, run=run)
    torch.cuda.synchronize()
    assert tbm.merge_runs.launches > before
    _same_pairs(got, tbm.merge_runs_plain(key, val, run=run))


@pytest.mark.parametrize("n,tile", [(1 << 16, 4096), (1 << 12, 1 << 12)])
def test_sort_merge_tree_kernels(cuda, n, tile):
    key, val = (t.to(cuda) for t in _pairs(n, n, n // 3))
    got = tbm.sort_merge_tree(key, val, tile=tile)
    _same_pairs(got, tbm.sort_tiles_plain(key, val, tile=n))


@pytest.mark.parametrize("n,n_buckets,dead", [
    (1, 1, 0.0), (1000, 8, 0.2), (4096, 64, 0.5), (1 << 20, 64, 0.6),
    (123457, 256, 0.1), (5000, 3, 1.0)])
def test_bin_ranks_kernel(cuda, n, n_buckets, dead):
    rng = np.random.default_rng(n + n_buckets)
    # runs of one id (neighbouring products share a row), some ids out of
    # range, dead lanes
    bid = np.repeat(rng.integers(0, n_buckets + 2, -(-n // 37)), 37)[:n]
    bid[rng.random(n) < dead] = -1
    bid = torch.from_numpy(bid.astype(np.int32)).to(cuda)
    before = trb.bin_ranks.launches
    got = trb.bin_ranks(bid, n_buckets=n_buckets)
    torch.cuda.synchronize()
    assert trb.bin_ranks.launches == before + 3
    assert torch.equal(got, trb.bin_ranks_plain(bid, n_buckets=n_buckets))
    with pytest.raises(ValueError):
        trb.bin_ranks(bid, n_buckets=trb.MAX_BUCKETS + 1)


@pytest.mark.parametrize("accumulator,kw", [
    ("tiled", {}), ("tiled", dict(tile=256)), ("bucket", {}), ("hash", {})])
def test_backends_match_sort_on_card(cuda, accumulator, kw):
    """Each new backend through the front door on the card, bit-identical to
    'sort' on integer operands, with its kernels launched."""
    rng = np.random.default_rng(21)
    m = 300
    a = ((rng.random((m, m)) < 0.05) * rng.integers(-4, 5, (m, m)))
    a = a.astype(np.float32)
    k = int((a != 0).sum(0).max())
    ta = rt.ell_rows_from_dense(a, k, device=cuda)
    tb = rt.ell_cols_from_dense(a.T.copy(), k, device=cuda)
    want = rt.spgemm(ta, tb, check=True)
    kernels.reset_launch_counts()
    got = rt.spgemm(ta, tb, accumulator=accumulator, check=True, **kw)
    counts = kernels.launch_counts()
    for f in ("row", "col", "val", "ngroups"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert counts["sccp_multiply"] == 1 and counts["sort_tiles"] > 0
    assert (counts["merge_runs"] > 0) == (accumulator == "tiled")
    assert (counts["bin_ranks"] > 0) == (accumulator == "bucket")


def _slab(seed, group, n, k_b, n_cols, dead=0.3):
    """A block of A slabs (group, n) and B (n, k_b): integer values, indices
    drawn from few rows and columns (long runs of equal keys)."""
    rng = np.random.default_rng(seed)
    a_val = rng.integers(-3, 4, (group, n)).astype(np.float32)
    a_idx = np.where(rng.random((group, n)) < 1 - dead,
                     rng.integers(0, 40, (group, n)), -1).astype(np.int32)
    b_val = rng.integers(-3, 4, (n, k_b)).astype(np.float32)
    b_idx = np.where(rng.random((n, k_b)) < 1 - dead,
                     rng.integers(0, n_cols, (n, k_b)), -1).astype(np.int32)
    return [torch.from_numpy(x) for x in (a_val, a_idx, b_val, b_idx)]


@pytest.mark.parametrize("group,n,k_b,dead", [
    (1, 16, 4, 0.3),             # 2^6 lanes: one tile, one residency
    (1, 1024, 4, 0.3),           # 2^12 lanes: exactly one shared tile
    (1, 4096, 16, 0.3),          # 2^16 lanes: global strides and totals
    (1, 1000, 3, 0.3),           # 3,000 lanes padded to 4,096
    (3, 700, 9, 0.2),            # a group block, 18,900 lanes → 2^15
    (1, 500, 8, 1.0),            # an all-invalid slab
])
def test_fused_slab_sort_kernel(cuda, group, n, k_b, dead):
    ops_in = [t.to(cuda) for t in _slab(n + group, group, n, k_b, 97, dead)]
    if group == 1:
        ops_in[:2] = [t[0].contiguous() for t in ops_in[:2]]
    before = tfs.fused_slab_sort.launches
    got = tfs.fused_slab_sort(*ops_in, n_cols=97)
    torch.cuda.synchronize()
    assert tfs.fused_slab_sort.launches > before
    _same_pairs(got, tfs.fused_slab_sort_plain(*ops_in, n_cols=97))
    assert got[0].numel() == 1 << (group * n * k_b - 1).bit_length()
    assert bool((got[0][1:] >= got[0][:-1]).all())
    with pytest.raises(TypeError):
        tfs.fused_slab_sort(ops_in[0].double(), *ops_in[1:], n_cols=97)


def test_fused_slab_sort_kernel_extreme_key(cuda):
    """row·n_cols + col = 2³¹−3 at n_rows·n_cols = 2³¹−2 packs and sorts."""
    big = (1 << 30) - 1
    ops_in = [torch.tensor([1.0, 2.0]), torch.tensor([1, 0], dtype=torch.int32),
              torch.tensor([[3.0], [4.0]]),
              torch.tensor([[big - 1], [big - 1]], dtype=torch.int32)]
    key, tot = tfs.fused_slab_sort(*[t.to(cuda) for t in ops_in], n_cols=big)
    assert key.tolist() == [big - 1, 2 ** 31 - 3] and tot.tolist() == [8, 3]


@pytest.mark.parametrize("length", [128, 1 << 14])
def test_merge_coalesce_pair_kernel(cuda, length):
    """The streaming engine's merge step (one K6 level), the buffer width
    down to its 128-lane minimum."""
    rng = np.random.default_rng(length)
    lists = []
    for n_valid in (length // 2, length // 3):
        key = np.full(length, KI, np.int32)
        key[:n_valid] = np.sort(rng.choice(3 * length, n_valid,
                                           replace=False))
        val = np.zeros(length, np.float32)
        val[:n_valid] = rng.integers(-4, 5, n_valid)
        lists += [torch.from_numpy(key).to(cuda),
                  torch.from_numpy(val).to(cuda)]
    got = tbm.merge_coalesce_pair(*lists)
    want = tbm.merge_runs_plain(torch.cat(lists[0::2]), torch.cat(lists[1::2]),
                                run=length)
    _same_pairs(got, want)


def _square(cuda, m=300, density=0.05, seed=21):
    rng = np.random.default_rng(seed)
    a = ((rng.random((m, m)) < density) * rng.integers(-4, 5, (m, m)))
    a = a.astype(np.float32)
    k = int((a != 0).sum(0).max())
    return (a, rt.ell_rows_from_dense(a, k, device=cuda),
            rt.ell_cols_from_dense(a.T.copy(), k, device=cuda))


@pytest.mark.parametrize("kw", [{}, dict(group=3),
                                dict(stream_cap=1 << 13, group=1)])
def test_stream_matches_sort_on_card(cuda, kw):
    """'stream' through the front door on the card: K8 every step, K6 for
    every merge, bit-identical to 'sort' on integer operands."""
    a, ta, tb = _square(cuda)
    want = rt.spgemm(ta, tb, check=True)
    kernels.reset_launch_counts()
    got = rt.spgemm(ta, tb, accumulator="stream", **kw)
    counts = kernels.launch_counts()
    for f in ("row", "col", "val", "ngroups"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert counts["fused_slab_sort"] > 0 and counts["merge_runs"] > 0
    assert counts["sccp_multiply"] == 0


def test_undersized_stream_cap_poisons_on_card(cuda):
    """A ``stream_cap`` below a group tile's uniques drops them on the card
    too: ``ngroups`` is poisoned past the cap and ``check=True`` raises."""
    _, ta, tb = _square(cuda)
    got = rt.spgemm(ta, tb, accumulator="stream", stream_cap=256, group=1)
    assert bool(got.overflowed())
    with pytest.raises(rt.AccumulatorOverflow):
        rt.spgemm(ta, tb, accumulator="stream", stream_cap=256, group=1,
                  check=True)


@pytest.mark.parametrize("backend", ["sort", "stream"])
def test_numeric_phase_on_card(cuda, backend):
    """The warm numeric phase through K1 and K3, bit-identical to the cold
    path; a stale structure with validate=False poisons ngroups."""
    a, ta, tb = _square(cuda, seed=22)
    st = rt.make_structure(ta, tb, backend=backend)
    cold = rt.spgemm(ta, tb, plan=st.plan, check=True)
    kernels.reset_launch_counts()
    warm = rt.spgemm(ta, tb, structure=st, check=True)
    counts = kernels.launch_counts()
    for f in ("row", "col", "val", "ngroups"):
        assert torch.equal(getattr(warm, f), getattr(cold, f)), f
    assert counts["sccp_multiply"] > 0 and counts["align_keys"] > 0
    a2 = a.copy()                  # move one nonzero within its column
    r, c = np.argwhere(a2 != 0)[0]
    z = np.flatnonzero(a2[:, c] == 0)[0]
    a2[r, c], a2[z, c] = 0.0, 3.0
    ta2 = rt.ell_rows_from_dense(a2, ta.k, device=cuda)
    stale = rt.spgemm(ta2, tb, structure=st, validate=False)
    assert int(stale.ngroups) > st.out_cap


def test_launch_counters_reset(cuda):
    tis.minima_mask(_keys(0, 64, 10).to(cuda))
    assert kernels.launch_counts()["minima_mask"] > 0
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


# ---------------------------------------------------------------------------
# K9 (ELLPACK x dense SpMM) and K10 (N:M SpMM)
# ---------------------------------------------------------------------------

def _ints(rng, shape):
    return rng.integers(-4, 5, shape).astype(np.float32)


@pytest.mark.parametrize("k,n,n_rows,d,hot", [
    (1, 1, 1, 1, 0.0), (3, 300, 150, 70, 0.0), (6, 4096, 480, 128, 0.0),
    (1, 2000, 7, 2048, 0.0), (4, 513, 129, 36, 0.9), (2, 1000, 64, 3, 0.5)])
def test_ell_spmm_kernel(cuda, k, n, n_rows, d, hot):
    """Integer-valued operands: bit-identical to the plain twin whatever
    order the atomics land in. Ragged n, n_rows and d (d % 4 != 0 takes the
    scalar atomics), idx −1 lanes, and ``hot`` of the lanes on row 0 (many
    atomics on one output row)."""
    rng = np.random.default_rng(n + d)
    a_val = _ints(rng, (k, n))
    a_idx = rng.integers(-1, n_rows, (k, n)).astype(np.int32)
    a_idx[rng.random((k, n)) < hot] = 0
    x = _ints(rng, (n, d))
    args = [torch.from_numpy(t).to(cuda) for t in (a_val, a_idx, x)]
    before = tes.ell_spmm.launches
    got = tes.ell_spmm(*args, n_rows)
    torch.cuda.synchronize()
    assert tes.ell_spmm.launches == before + 1
    assert torch.equal(got, tes.ell_spmm_plain(*args, n_rows))


def test_ell_spmm_kernel_float_and_checks(cuda):
    """Float operands within float32 summation order; a wrong dtype or a
    non-contiguous plane raises."""
    rng = np.random.default_rng(9)
    a_val = torch.from_numpy(rng.standard_normal((6, 777))
                             .astype(np.float32)).to(cuda)
    a_idx = torch.from_numpy(rng.integers(-1, 100, (6, 777))
                             .astype(np.int32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((777, 256))
                         .astype(np.float32)).to(cuda)
    torch.testing.assert_close(tes.ell_spmm(a_val, a_idx, x, 100),
                               tes.ell_spmm_plain(a_val, a_idx, x, 100),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError):
        tes.ell_spmm(a_val, a_idx, x.double(), 100)
    with pytest.raises(TypeError):
        tes.ell_spmm(a_val, a_idx.long(), x, 100)
    with pytest.raises(ValueError):
        tes.ell_spmm(a_val.T.contiguous().T, a_idx, x, 100)


@pytest.mark.parametrize("t,d_in,d_out,nm", [
    (1, 4, 1, (1, 4)), (130, 64, 131, (2, 4)), (257, 96, 300, (1, 4)),
    (129, 128, 129, (2, 8)), (200, 256, 257, (4, 8)), (64, 1032, 96, (2, 4)),
    (128, 66, 128, (3, 6))])
def test_nm_spmm_kernel(cuda, t, d_in, d_out, nm):
    """Every NM_CANDIDATES window (and a 3:6 one), ragged t, d_out and
    window chunks, integer-valued operands: bit-identical to the plain twin
    and to X @ W."""
    n, m = nm
    rng = np.random.default_rng(t + d_in + d_out)
    w = torch.from_numpy(_ints(rng, (d_in, d_out))).to(cuda)
    wp = rt.models.magnitude_prune_nm(w, n, m)
    w_nm = rt.nm_from_dense(wp, n, m)
    x = torch.from_numpy(_ints(rng, (t, d_in))).to(cuda)
    before = tnm.nm_spmm.launches
    got = tnm.nm_spmm(x, w_nm.val, w_nm.off, n=n, m=m)
    torch.cuda.synchronize()
    assert tnm.nm_spmm.launches == before + 1
    assert torch.equal(got, tnm.nm_spmm_plain(x, w_nm.val, w_nm.off, n=n,
                                              m=m))
    assert torch.equal(got, x @ wp)


def test_nm_spmm_kernel_checks(cuda):
    """Offsets outside [0, M) add nothing, as in the masked products; a
    wrong dtype or a non-contiguous plane raises."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_ints(rng, (70, 32))).to(cuda)
    val = torch.from_numpy(_ints(rng, (16, 40))).to(cuda)
    off = torch.from_numpy(rng.integers(-2, 6, (16, 40))
                           .astype(np.int8)).to(cuda)
    assert torch.equal(tnm.nm_spmm(x, val, off, n=2, m=4),
                       tnm.nm_spmm_plain(x, val, off, n=2, m=4))
    with pytest.raises(TypeError):
        tnm.nm_spmm(x, val, off.to(torch.int32), n=2, m=4)
    with pytest.raises(TypeError):
        tnm.nm_spmm(x.double(), val, off, n=2, m=4)
    with pytest.raises(ValueError):
        tnm.nm_spmm(x.T.contiguous().T, val, off, n=2, m=4)
    with pytest.raises(ValueError):
        tnm.nm_spmm(x, val[:, ::2], off[:, ::2], n=2, m=4)



def test_nm_spmm_broadcast_probe(cuda):
    """The probe build (every lane reads its window's first column) counts
    no launch, and equals K10 where every offset is 0."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(_ints(rng, (130, 64))).to(cuda)
    val = torch.from_numpy(_ints(rng, (32, 131))).to(cuda)
    off = torch.zeros((32, 131), dtype=torch.int8, device=cuda)
    before = tnm.nm_spmm.launches
    got = tnm.launch("nm_spmm_broadcast", x, val, off, n=2, m=4)
    torch.cuda.synchronize()
    assert tnm.nm_spmm.launches == before
    assert torch.equal(got, tnm.nm_spmm(x, val, off, n=2, m=4))

def test_sparse_layers_on_card(cuda):
    """SparseMLP's N:M route launches K10 once a layer and equals the dense
    product of the pruned weights; the ELLPACK twin equals the N:M route."""
    rng = np.random.default_rng(5)
    w_in = torch.from_numpy(_ints(rng, (64, 96))).to(cuda)
    w_out = torch.from_numpy(_ints(rng, (96, 64))).to(cuda)
    mlp = rt.SparseMLP(w_in, w_out, 0.5, nm=(2, 4))
    x = torch.from_numpy(_ints(rng, (33, 64))).to(cuda)
    kernels.reset_launch_counts()
    mlp(x)
    assert kernels.launch_counts()["nm_spmm"] == 2
    wp = rt.models.magnitude_prune_nm(w_in, 2, 4)
    assert torch.equal(mlp.fc_in(x), x @ wp)
    assert torch.equal(rt.models.sparse_linear_apply(x, mlp.fc_in.w_ell),
                       mlp.fc_in(x))


def test_moe_apply_on_card(cuda):
    """dispatch='spmm' launches K9 twice a call and agrees with the same
    call on CPU tensors (the plain twins) within float32 summation order."""
    import dataclasses
    from repro_torch.configs import deepseek_v2_lite
    from repro_torch.core.formats import params_from_numpy
    base = deepseek_v2_lite.CONFIG.reduced()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, dispatch="spmm"))
    rng = np.random.default_rng(6)
    d, e, f = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
    p = {"router": rng.standard_normal((d, e)) / 8,
         "w_gate": rng.standard_normal((e, d, f)) / 8,
         "w_up": rng.standard_normal((e, d, f)) / 8,
         "w_down": rng.standard_normal((e, f, d)) / 8,
         "shared": {"w_gate": rng.standard_normal((d, 2 * f)) / 8,
                    "w_up": rng.standard_normal((d, 2 * f)) / 8,
                    "w_down": rng.standard_normal((2 * f, d)) / 8}}
    x = rng.standard_normal((2, 40, d)).astype(np.float32)
    kernels.reset_launch_counts()
    y, aux = rt.moe_apply(params_from_numpy(p, device=cuda,
                                            dtype=torch.float32),
                          torch.from_numpy(x).to(cuda), cfg, torch.float32)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ell_spmm"] == 2
    y_c, aux_c = rt.moe_apply(params_from_numpy(p, device="cpu",
                                                dtype=torch.float32),
                              torch.from_numpy(x), cfg, torch.float32)
    torch.testing.assert_close(y.cpu(), y_c, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), aux_c, rtol=1e-5, atol=1e-5)
