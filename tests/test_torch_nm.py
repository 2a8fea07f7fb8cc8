"""repro_torch's N:M format, SpMM kernels' plain twins and SparseLinear
against the JAX reference on the CPU.

The same numpy operands go through ``repro`` and ``repro_torch``. On
integer-valued operands every float32 sum is exact in any order, so K10's
plain twin (``nm_spmm_plain``) equals the reference's interpret-mode Pallas
``nm_spmm`` and its ``nm_spmm_xla`` bit for bit, and K9's plain twin (the
port's ``ops.ell_spmm``) equals the reference's ``ops.ell_spmm``; on float
operands K9 is held at rtol = atol = 1e-5 (float32 summation order). The
condensed planes, the prunes, ``sparsify_linear``'s slab width (σ with
ddof 0), ``detect_nm``/``plan_spmm_format`` and ``SparseLinear`` /
``SparseMLP`` / ``matmul_sparse`` follow the reference.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import repro_torch as rt
from repro.core.formats import EllRows as RefEllRows
from repro.core.formats import ell_rows_from_dense as ref_ell_rows
from repro.core.nm import detect_nm as ref_detect_nm
from repro.core.nm import nm_from_dense as ref_nm_from_dense
from repro.kernels import ops as ref_ops
from repro.kernels.nm_spmm import nm_spmm as ref_nm_spmm
from repro.kernels.nm_spmm import nm_spmm_xla as ref_nm_spmm_xla
from repro.models import sparse as ref_sparse
from repro.models.ffn import SparseMLP as RefSparseMLP
from repro.plan import plan_spmm_format as ref_plan_spmm_format
from repro_torch import kernels
from repro_torch.core.formats import from_numpy, nm_from_numpy
from repro_torch.kernels import nm_spmm as tnm
from repro_torch.kernels import ops
from repro_torch.models import sparse as tsp

CPU = torch.device("cpu")

# (t, d_in, d_out, n, m) — the reference's tests/test_nm.py zoo
_ZOO = [
    (8, 16, 12, 2, 4),
    (16, 64, 48, 2, 4),
    (4, 32, 40, 1, 4),
    (8, 64, 24, 4, 8),
    (8, 48, 16, 2, 8),
]


def _int(rng, shape):
    """Integer-valued float32: float sums are order-exact."""
    return rng.integers(-4, 5, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("t,d_in,d_out,n,m", _ZOO)
def test_nm_spmm_plain_matches_reference(t, d_in, d_out, n, m):
    rng = np.random.default_rng(d_in * 31 + d_out)
    w = _int(rng, (d_in, d_out))
    x = _int(rng, (t, d_in))
    wp = np.asarray(ref_sparse.magnitude_prune_nm(jnp.asarray(w), n, m))
    ref = ref_nm_from_dense(jnp.asarray(wp), n, m)
    got = tnm.nm_spmm(_t(x), _t(ref.val), _t(ref.off), n=n, m=m)
    _eq(got, ref_nm_spmm(jnp.asarray(x), ref.val, ref.off, n=n, m=m,
                         interpret=True))
    _eq(got, ref_nm_spmm_xla(jnp.asarray(x), ref.val, ref.off, n=n, m=m))
    _eq(got, x @ wp)
    assert tnm.nm_spmm.launches == 0           # plain twin launches nothing


def test_nm_spmm_front_checks_shapes():
    x = torch.zeros((4, 16))
    with pytest.raises(ValueError):
        tnm.nm_spmm(x, torch.zeros((6, 3)), torch.zeros((6, 3),
                                                        dtype=torch.int8),
                    n=2, m=4)
    with pytest.raises(ValueError):
        tnm.nm_spmm(x, torch.zeros((8, 3)), torch.zeros((8, 2),
                                                        dtype=torch.int8),
                    n=2, m=4)


@pytest.mark.parametrize("n,m", [(1, 4), (2, 4), (2, 8), (4, 8)])
def test_nm_from_dense_planes_match_reference(n, m):
    rng = np.random.default_rng(n * 10 + m)
    w = _int(rng, (4 * m, 10))
    wp = np.array(ref_sparse.magnitude_prune_nm(jnp.asarray(w), n, m))
    wp[:m, 0] = 0                  # an empty window: padded slots
    wp[m:2 * m, 1] = 0
    wp[m, 1] = 3.0                 # a window below N non-zeros
    ref = ref_nm_from_dense(jnp.asarray(wp), n, m)
    got = rt.nm_from_dense(_t(wp), n, m)
    assert got.off.dtype == torch.int8 and got.val.shape == (4 * n, 10)
    assert (got.n, got.m, got.d_in, got.d_out, got.r, got.windows) == \
        (ref.n, ref.m, ref.d_in, ref.d_out, ref.r, ref.windows)
    _eq(got.val, ref.val)
    _eq(got.off, ref.off)
    _eq(got.to_dense(), ref.to_dense())
    _eq(got.to_dense(), wp)
    carried = nm_from_numpy(np.asarray(ref.val), np.asarray(ref.off), n=n,
                            m=m, d_in=ref.d_in, device="cpu")
    _eq(carried.to_dense(), wp)


def test_nm_from_dense_validation():
    w = torch.ones((12, 4))
    with pytest.raises(ValueError):
        rt.nm_from_dense(w, 2, 8)             # d_in % m != 0
    with pytest.raises(ValueError):
        rt.nm_from_dense(w, 2, 4)             # dense rows: 4 nnz a window


def _weights():
    rng = np.random.default_rng(5)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    out = {"dense": w, "global_90": np.asarray(
        ref_sparse.magnitude_prune(jnp.asarray(w), 0.9))}
    for n, m in [(1, 4), (2, 4), (2, 8), (4, 8)]:
        out[f"{n}:{m}"] = np.asarray(
            ref_sparse.magnitude_prune_nm(jnp.asarray(w), n, m))
    out["zeros"] = np.zeros((64, 32), np.float32)
    return out


@pytest.mark.parametrize("name", ["dense", "global_90", "1:4", "2:4", "2:8",
                                  "4:8", "zeros"])
def test_detect_nm_and_plan_spmm_format_match_reference(name):
    w = _weights()[name]
    assert rt.detect_nm(_t(w)) == ref_detect_nm(jnp.asarray(w))
    assert rt.plan_spmm_format(_t(w)) == ref_plan_spmm_format(jnp.asarray(w))
    cands = ((4, 8), (2, 8))
    assert rt.plan_spmm_format(_t(w), cands) == \
        ref_plan_spmm_format(jnp.asarray(w), cands)


@pytest.mark.parametrize("sparsity", [0.0, 0.3, 0.5, 0.9, 1.0])
def test_magnitude_prune_matches_reference(sparsity):
    rng = np.random.default_rng(int(sparsity * 10))
    w = _int(rng, (24, 20))                  # integer weights: many ties
    _eq(tsp.magnitude_prune(_t(w), sparsity),
        ref_sparse.magnitude_prune(jnp.asarray(w), sparsity))


@pytest.mark.parametrize("n,m", [(1, 4), (2, 4), (2, 8), (4, 8), (4, 4)])
def test_magnitude_prune_nm_matches_reference(n, m):
    rng = np.random.default_rng(n * m)
    w = _int(rng, (8 * m, 12))               # ties break toward the front
    _eq(tsp.magnitude_prune_nm(_t(w), n, m),
        ref_sparse.magnitude_prune_nm(jnp.asarray(w), n, m))
    with pytest.raises(ValueError):
        tsp.magnitude_prune_nm(_t(w), m + 1, m)


@pytest.mark.parametrize("sparsity", [0.5, 0.8, 0.95])
def test_sparsify_linear_width_matches_reference(sparsity):
    rng = np.random.default_rng(7)
    w = rng.standard_normal((40, 64)).astype(np.float32)
    w[::3] *= 4.0                              # uneven rows: σ matters
    ref = ref_sparse.sparsify_linear(jnp.asarray(w), sparsity)
    got = tsp.sparsify_linear(_t(w), sparsity)
    assert got.k == ref.k and got.n_cols == ref.n_cols
    _eq(got.val, ref.val)
    _eq(got.idx, ref.idx)


def test_sparsify_linear_sigma_takes_ddof_0():
    w = np.zeros((4, 8), np.float32)
    w[2, [1, 5]] = [3.0, -4.0]
    w[3, [0, 2]] = [1.0, 2.0]              # nnz per row 0, 0, 2, 2
    ref = ref_sparse.sparsify_linear(jnp.asarray(w), 0.875)
    got = tsp.sparsify_linear(_t(w), 0.875)
    assert got.k == ref.k == 2             # ceil(1 + 1)
    _eq(got.val, ref.val)
    # torch.std's default correction (1) would give ceil(1 + 1.155) = 3
    nnz = (_t(w) != 0).sum(1).float()
    assert math.ceil(float(nnz.mean() + nnz.std())) == 3


def test_ell_from_pruned_matches_reference():
    rng = np.random.default_rng(9)
    wp = np.asarray(ref_sparse.magnitude_prune_nm(
        jnp.asarray(_int(rng, (32, 16))), 2, 4))
    ref = ref_sparse.ell_from_pruned(jnp.asarray(wp))
    got = tsp.ell_from_pruned(_t(wp))
    assert got.k == ref.k
    _eq(got.val, ref.val)
    _eq(got.idx, ref.idx)


# ---------------------------------------------------------------------------
# K9's plain twin through ops.ell_spmm
# ---------------------------------------------------------------------------

def _ell_operands(rng, k, n, n_rows, d, integer):
    draw = (lambda s: _int(rng, s)) if integer else \
        (lambda s: rng.standard_normal(s).astype(np.float32))
    a_val = draw((k, n)) * (rng.random((k, n)) < 0.6)
    a_idx = np.where(a_val != 0, rng.integers(0, n_rows, (k, n)),
                     -1).astype(np.int32)
    return a_val.astype(np.float32), a_idx, draw((n, d))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("k,n,n_rows,d", [(1, 128, 128, 8), (4, 256, 128, 64),
                                          (8, 128, 256, 128)])
def test_ell_spmm_plain_matches_reference(k, n, n_rows, d, integer):
    rng = np.random.default_rng(k * n + d)
    a_val, a_idx, x = _ell_operands(rng, k, n, n_rows, d, integer)
    got = ops.ell_spmm(_t(a_val), _t(a_idx), _t(x), n_rows)
    want = ref_ops.ell_spmm(jnp.asarray(a_val), jnp.asarray(a_idx),
                            jnp.asarray(x), n_rows)
    assert got.dtype == torch.float32 and got.shape == (n_rows, d)
    if integer:
        _eq(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert kernels.ell_spmm.ell_spmm.launches == 0


def _emulate_ell_spmm(a_val, a_idx, x, n_rows):
    """K9's design (csrc/ell_spmm.cu), emulated: the lane ids sorted stably
    by row over ``transpose_passes`` 8-bit digits of the flipped key
    (invalid lanes INT32_MAX, last), each row's first sorted lane found as
    the row-bounds grid finds it, and every row summed from 0 in lane order
    by one rounded product and one rounded add a term."""
    from repro_torch.kernels import ell_spmm as tes
    k, n = a_idx.shape
    lanes = a_idx.reshape(-1).astype(np.int64)
    key = np.where((lanes >= 0) & (lanes < n_rows), lanes, 2 ** 31 - 1)
    order = np.arange(k * n)
    for p in range(tes.transpose_passes(n_rows)):
        digit = ((key[order] + 2 ** 31) >> (8 * p)) & 255
        order = order[np.argsort(digit, kind="stable")]
    sorted_key = key[order]
    rowptr = np.empty(n_rows + 1, np.int64)
    for r in range(n_rows + 1):             # a lower-bound search a row
        lo, hi = 0, k * n
        while lo < hi:
            mid = (lo + hi) // 2
            if sorted_key[mid] < r:
                lo = mid + 1
            else:
                hi = mid
        rowptr[r] = lo
    out = np.zeros((n_rows, x.shape[1]), np.float32)
    val = a_val.reshape(-1)
    for r in range(n_rows):
        for lane in order[rowptr[r]:rowptr[r + 1]]:
            out[r] = out[r] + val[lane] * x[lane % n]   # float32 ops
    return out


@pytest.mark.parametrize("k,n,n_rows,d,hot", [
    (1, 40, 7, 5, 0.0), (3, 100, 300, 8, 0.0), (6, 64, 256, 4, 0.0),
    (2, 50, 255, 3, 0.5), (1, 300, 70000, 2, 0.0), (4, 30, 20, 6, 0.9)])
def test_ell_spmm_design_sums_like_the_plain_twin(k, n, n_rows, d, hot):
    """Emulated on float operands, K9's transpose and gather give the plain
    twin's bits on the CPU: the twin's ``index_add_`` sums every row in
    lane order from 0, as the gather does. Row counts across the one-,
    two- and three-digit transposes, negative indices, a hot row."""
    rng = np.random.default_rng(k * n + n_rows)
    a_val = rng.standard_normal((k, n)).astype(np.float32)
    a_idx = rng.integers(-1, n_rows, (k, n)).astype(np.int32)
    a_idx[rng.random((k, n)) < hot] = 0
    a_idx[0, :2] = [-5, -1]                 # negative: adds nothing
    x = rng.standard_normal((n, d)).astype(np.float32)
    got = _emulate_ell_spmm(a_val, a_idx, x, n_rows)
    want = ops.ell_spmm(_t(a_val), _t(a_idx), _t(x), n_rows)
    _eq(got, want)


def test_ell_spmm_transpose_geometry():
    """The transpose's digits, buffers and the grids one call launches
    (counted on ``ell_spmm.launches``)."""
    from repro_torch.kernels import ell_spmm as tes
    assert [tes.transpose_passes(r) for r in
            (1, 255, 256, 4096, 30720, 65535, 65536, 2 ** 24, 2 ** 31 - 1)] \
        == [1, 1, 2, 2, 2, 2, 3, 4, 4]
    assert tes.sorted_lanes(4096) == 4096 and tes.sorted_lanes(4097) == 8192
    assert tes.grids(6, 4096, 30720, 2048) == 3 * 2 + 2    # MoE dispatch
    assert tes.grids(1, 30720, 4096, 2048) == 3 * 2 + 2    # MoE combine
    assert tes.grids(4, 513, 129, 36) == 1 + 2             # one tile
    assert tes.grids(0, 10, 5, 3) == 2 and tes.grids(2, 3, 0, 3) == 0
    assert tes.scratch_ints(6, 4096, 30720) == 4 * 24576 + 7 * 256 + 30721


@pytest.mark.parametrize("integer", [True, False])
def test_ell_spmm_plain_ragged_matches_reference(integer):
    rng = np.random.default_rng(300)
    draw = (lambda s: _int(rng, s)) if integer else \
        (lambda s: rng.standard_normal(s).astype(np.float32))
    a_val = draw((3, 300))
    a_idx = rng.integers(0, 150, (3, 300)).astype(np.int32)
    a_idx[1, ::7] = -1                     # empty lanes add nothing
    x = draw((300, 70))
    got = ops.ell_spmm(_t(a_val), _t(a_idx), _t(x), 150)
    want = ref_ops.ell_spmm(jnp.asarray(a_val), jnp.asarray(a_idx),
                            jnp.asarray(x), 150)
    if integer:
        _eq(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# SparseLinear, SparseMLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nm", [(2, 4), (1, 4), "auto", "auto_balanced", None])
def test_sparse_linear_matches_reference(nm):
    rng = np.random.default_rng(7)
    w = _int(rng, (64, 48))
    x = _int(rng, (9, 64))
    if nm == "auto_balanced":              # 'auto' on a 2:4 pattern
        w = np.asarray(ref_sparse.magnitude_prune_nm(jnp.asarray(w), 2, 4))
        nm = "auto"
    ref = ref_sparse.SparseLinear(jnp.asarray(w), 0.5, nm=nm)
    got = rt.SparseLinear(w, 0.5, nm=nm, device="cpu")
    assert (got.w_nm is None) == (ref.w_nm is None)
    if got.w_nm is not None:
        assert (got.w_nm.n, got.w_nm.m) == (ref.w_nm.n, ref.w_nm.m)
        _eq(got.w_nm.val, ref.w_nm.val)
        _eq(got.w_nm.off, ref.w_nm.off)
    assert got.w_ell.k == ref.w_ell.k
    _eq(got.w_ell.val, ref.w_ell.val)
    _eq(got.w_ell.idx, ref.w_ell.idx)
    want = np.asarray(ref(jnp.asarray(x)))
    _eq(got(_t(x)), want)
    _eq(tsp.sparse_linear_apply(_t(x), got.w_ell), want)  # either route
    xb = _int(rng, (3, 5, 64))             # leading axes flattened inside
    _eq(got(_t(xb)), ref(jnp.asarray(xb)))


def test_sparse_linear_from_reference_planes():
    rng = np.random.default_rng(8)
    w = _int(rng, (32, 24))
    x = _int(rng, (6, 32))
    ref = ref_sparse.SparseLinear(jnp.asarray(w), 0.5, nm=(2, 4))
    w_ell = from_numpy(ref.w_ell.val, ref.w_ell.idx,
                       n_cols=ref.w_ell.n_cols, device="cpu")
    w_nm = nm_from_numpy(ref.w_nm.val, ref.w_nm.off, n=2, m=4,
                         d_in=ref.w_nm.d_in, device="cpu")
    want = np.asarray(ref(jnp.asarray(x)))
    _eq(rt.SparseLinear.from_planes(w_ell, w_nm)(_t(x)), want)
    _eq(rt.SparseLinear.from_planes(w_ell)(_t(x)), want)


@pytest.mark.parametrize("nm", [(2, 4), None])
def test_sparse_mlp_matches_reference(nm):
    rng = np.random.default_rng(11)
    w_in, w_out = _int(rng, (32, 48)), _int(rng, (48, 32))
    x = _int(rng, (7, 32))
    ref = RefSparseMLP(jnp.asarray(w_in), jnp.asarray(w_out), 0.5, nm=nm)
    got = rt.SparseMLP(w_in, w_out, 0.5, nm=nm, device="cpu")
    assert got.fc_in.cache is got.fc_out.cache is got.cache
    _eq(got.fc_in(_t(x)), ref.fc_in(jnp.asarray(x)))
    # the GELU (tanh form) is evaluated by two libraries: float32 ulps
    np.testing.assert_allclose(got(_t(x)).numpy(),
                               np.asarray(ref(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-5)
    ref_stats = ref.cache_stats()
    assert got.cache_stats() == {k: ref_stats[k] for k in got.cache_stats()}


def _activation(rng, n_rows, d_in, k):
    a = _int(rng, (n_rows, d_in)) * (rng.random((n_rows, d_in)) < 0.15)
    ra = ref_ell_rows(jnp.asarray(a), k)
    ta = rt.ell_rows_from_dense(a, k, device="cpu")
    return ra, ta


def test_matmul_sparse_sort_matches_reference_and_hits_cache():
    rng = np.random.default_rng(12)
    w = _int(rng, (48, 40))
    ref = ref_sparse.SparseLinear(jnp.asarray(w), 0.6, nm=None)
    got = rt.SparseLinear(w, 0.6, nm=None, device="cpu")
    ra, ta = _activation(rng, 16, 48, 6)
    assert isinstance(ra, RefEllRows)
    for call in range(2):
        want = ref.matmul_sparse(ra, backend="sort")
        coo = got.matmul_sparse(ta, backend="sort")
        for f in ("row", "col", "val", "ngroups"):
            _eq(getattr(coo, f), getattr(want, f))
        assert coo.shape == tuple(want.shape)
    assert got.cache.stats()["hits"] == ref.cache.stats()["hits"] == 1
    assert got.cache.stats()["misses"] == 1
    # without a pinned backend both packages plan one, on a fresh cache
    coo = rt.SparseLinear(w, 0.6, nm=None, device="cpu").matmul_sparse(ta)
    want = ref_sparse.SparseLinear(jnp.asarray(w), 0.6,
                                   nm=None).matmul_sparse(ra)
    for f in ("row", "col", "val", "ngroups"):
        _eq(getattr(coo, f), getattr(want, f))



def test_build_variant_is_its_own_library():
    """A variant of a source builds with its defines under its own name, and
    its library name hashes them, so it never shadows the kernel's: K10's
    one-TF32-product probe."""
    from repro_torch.kernels import _build
    src, flags = _build._spec("nm_spmm_one_tf32")
    assert src == _build.SRC_DIR / "nm_spmm.cu"
    assert flags == _build.NVCC_FLAGS + ("-DNM_SPMM_ONE_TF32",)
    assert "NM_SPMM_ONE_TF32" in src.read_text()
    assert _build._spec("nm_spmm") == (src, _build.NVCC_FLAGS)
    names = {_build._target(n).name.rsplit("-", 1)[0]
             for n in ("nm_spmm", "nm_spmm_one_tf32")}
    assert names == {"nm_spmm", "nm_spmm_one_tf32"}


@pytest.mark.parametrize("m,windows,cols", [
    (4, 8, 32), (8, 4, 32), (2, 16, 32), (1, 32, 32), (6, 5, 32),
    (3, 10, 32), (11, 2, 24), (64, 1, 64), (100, 1, 104), (128, 1, 128)])
def test_nm_k_chunk(m, windows, cols):
    """K10's K-chunk: whole windows up to 32 input columns (at least one),
    padded to the MMA depth of 8."""
    from repro_torch.kernels import nm_spmm as tnm
    assert tnm.k_chunk(m) == (windows, cols)
    assert cols % tnm.MMA_K == 0 and 0 <= cols - windows * m < tnm.MMA_K
    with pytest.raises(ValueError):
        tnm.k_chunk(0)


def test_sparse_linear_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only default; a CUDA device is present")
    with pytest.raises(RuntimeError):
        rt.SparseLinear(np.ones((8, 4), np.float32), 0.5)
    # a CPU tensor stays on the CPU
    lyr = rt.SparseLinear(torch.ones((8, 4)), 0.5, nm=None)
    assert lyr.w_ell.val.device == CPU
