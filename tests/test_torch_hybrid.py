"""repro_torch.core.hybrid against the JAX reference on the same numpy
operands: the width rule, both splits field by field, ``to_dense``, the
numpy carry-over, and ``hybrid_spgemm_dense``: bit for bit on integer
values, and within the reference test's ``atol=1e-3`` on float values
(float32 sums of up to n terms in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro_torch as rt
from repro.core import hybrid as ref
from repro_torch.core import hybrid as th

from test_hybrid import _skewed

FLOAT_ATOL = 1e-3          # tests/test_hybrid.py's tolerance against a @ b

# (seed, n, density, n_hot, hot_density): the reference test's skew regimes
CASES = [(0, 48, 0.1, 5, 0.8), (1, 40, 0.15, 4, 0.9), (2, 24, 0.3, 2, 0.5),
         (3, 13, 0.05, 2, 1.0)]


def _int_skewed(rng, n, density, n_hot, hot_density):
    """``_skewed``'s pattern with integer values in [-4, 4] \\ {0}, so every
    float32 sum is exact in any order."""
    a = _skewed(rng, n, density, n_hot, hot_density)
    mag = rng.integers(1, 5, a.shape).astype(np.float32)
    return np.where(a != 0, np.sign(a) * mag, 0).astype(np.float32)


def _widths(a, bt):
    """The reference test's ``_hybrid_pair`` sizes: the NNZ-a + σ width of
    each operand and an ample COO cap."""
    k_a = ref.ell_width_rule((a != 0).sum(0))
    k_b = ref.ell_width_rule((bt != 0).sum(1))
    coo_cap = int(max((a != 0).sum(), (bt != 0).sum()))
    return k_a, k_b, coo_cap


def _splits(a, b):
    k_a, k_b, cap = _widths(a, b)
    refs = (ref.split_rows_hybrid(jnp.array(a), k_a, coo_cap=cap),
            ref.split_cols_hybrid(jnp.array(b), k_b, coo_cap=cap))
    ports = (th.split_rows_hybrid(a, k_a, cap, device="cpu"),
             th.split_cols_hybrid(b, k_b, cap, device="cpu"))
    return refs, ports


def _eq(got, want):
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))


def _eq_split(got, want):
    for f in ("val", "idx"):
        _eq(getattr(got.ell, f), getattr(want.ell, f))
    assert (got.ell.n_rows, got.ell.n_cols) == (want.ell.n_rows,
                                                want.ell.n_cols)
    for f in ("row", "col", "val", "ngroups"):
        _eq(getattr(got.coo, f), getattr(want.coo, f))
    assert got.coo.shape == tuple(want.coo.shape)


@pytest.mark.parametrize("seed", range(6))
def test_ell_width_rule_equal(seed):
    rng = np.random.default_rng(seed)
    counts = rng.poisson(rng.uniform(0.5, 40), rng.integers(1, 300))
    assert th.ell_width_rule(counts) == ref.ell_width_rule(counts)
    assert rt.hybrid.ell_width_rule(np.zeros(4)) == 1


def _check_splits(a, b, ra, rb, ta, tb):
    """Both splits field by field, ``to_dense``, and the carry-over."""
    n = a.shape[0]
    assert isinstance(ta, th.HybridRows) and isinstance(tb, th.HybridCols)
    _eq_split(ta, ra)
    _eq_split(tb, rb)
    assert int(ta.coo.nnz()) > 0 and int(tb.coo.nnz()) > 0
    for got, want, dense in ((ta, ra, a), (tb, rb, b)):
        _eq(got.to_dense(), want.to_dense())
        _eq(got.to_dense(), dense)                  # the split is lossless
    # the reference's split carried across as numpy is the port's split
    for want, kw, cls in ((ra, dict(n_rows=n), th.HybridRows),
                          (rb, dict(n_cols=n), th.HybridCols)):
        got = th.hybrid_from_numpy(want.ell.val, want.ell.idx, want.coo.row,
                                   want.coo.col, want.coo.val,
                                   want.coo.ngroups, device="cpu", **kw)
        _eq_split(got, want)
        assert type(got) is cls


@pytest.mark.parametrize("case", CASES)
def test_splits_and_product_integer_bit_for_bit(case):
    seed, n, density, n_hot, hot = case
    rng = np.random.default_rng(seed)
    a = _int_skewed(rng, n, density, min(n_hot, n // 2), hot)
    b = _int_skewed(rng, n, density, min(n_hot, n // 2), hot)
    (ra, rb), (ta, tb) = _splits(a, b)
    _check_splits(a, b, ra, rb, ta, tb)
    got = th.hybrid_spgemm_dense(ta, tb)
    assert got.dtype == torch.float32 and got.shape == (n, n)
    _eq(got, jax.jit(ref.hybrid_spgemm_dense)(ra, rb))
    _eq(got, a @ b)


@pytest.mark.parametrize("case", CASES[:2])
def test_splits_and_product_float(case):
    seed, n, density, n_hot, hot = case
    rng = np.random.default_rng(seed + 100)
    a = _skewed(rng, n, density, min(n_hot, n // 2), hot)
    b = _skewed(rng, n, density, min(n_hot, n // 2), hot)
    (ra, rb), (ta, tb) = _splits(a, b)
    _check_splits(a, b, ra, rb, ta, tb)
    got = th.hybrid_spgemm_dense(ta, tb).numpy()
    want = np.asarray(jax.jit(ref.hybrid_spgemm_dense)(ra, rb))
    np.testing.assert_allclose(got, want, atol=FLOAT_ATOL)
    np.testing.assert_allclose(got, a @ b, atol=FLOAT_ATOL)


@pytest.fixture(scope="module")
def int_split():
    rng = np.random.default_rng(7)
    a = _int_skewed(rng, 20, 0.2, 3, 0.9)
    b = _int_skewed(rng, 20, 0.2, 3, 0.9)
    return _splits(a, b)


@pytest.mark.parametrize("left", [True, False])
@pytest.mark.parametrize("chunk", [1, 3, 7])
def test_coo_matmul_dense_in_chunks(int_split, left, chunk):
    """More than one chunk of COO entries (pad slots included) gives the
    one-chunk sum and the reference's, bit for bit on integer values."""
    (ra, rb), (ta, tb) = int_split
    coo, rcoo = (ta.coo, ra.coo) if left else (tb.coo, rb.coo)
    other = tb.to_dense() if left else ta.ell.to_dense()
    rother = rb.to_dense() if left else ra.ell.to_dense()
    assert coo.cap > 2 * chunk and int(coo.nnz()) < coo.cap
    got = th._coo_matmul_dense(coo, other, left, chunk=chunk)
    _eq(got, th._coo_matmul_dense(coo, other, left))
    _eq(got, ref._coo_matmul_dense(rcoo, rother, left))


def test_split_needs_a_device(monkeypatch):
    """``device=None`` is CUDA or an error, never a silent CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.eye(4, dtype=np.float32)
    for split in (th.split_rows_hybrid, th.split_cols_hybrid):
        with pytest.raises(RuntimeError, match="CUDA"):
            split(a, 1, 4)
