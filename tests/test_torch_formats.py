"""repro_torch formats against the JAX reference: the dense → ELLPACK/COO
converters, the scipy host constructors, ``to_dense`` and the numpy
carry-over, all bit-identical on the same numpy inputs; and the package's
top level against the reference's (its names and its module aliases)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import scipy.sparse as sp

import repro_torch as rt
from repro.core import formats as ref
from repro_torch.core import formats as tf

from conftest import random_sparse


def _mat(seed, m, n, density, heavy_col=None, zero=False):
    rng = np.random.default_rng(seed)
    a = random_sparse(rng, m, n, density)
    if heavy_col is not None:
        a[:, heavy_col] = rng.standard_normal(m).astype(np.float32)
    return np.zeros_like(a) if zero else a


MATS = {
    "square": (_mat(0, 32, 32, 0.2), None),
    "rect": (_mat(1, 24, 40, 0.3), None),
    "heavy": (_mat(2, 20, 20, 0.1, heavy_col=3), None),
    "truncated": (_mat(3, 16, 16, 0.5), 3),         # k below max nnz
    "padding": (_mat(4, 32, 32, 0.05), 12),         # k far above max nnz
    "empty": (_mat(5, 16, 16, 0.0, zero=True), 2),
}


def _k(mask_counts, k):
    return k if k is not None else max(1, int(mask_counts.max()))


def _eq(got, want):
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(MATS))
def test_ell_and_coo_from_dense_bit_identical(name):
    a, k = MATS[name]
    ka = _k((a != 0).sum(0), k)
    kb = _k((a != 0).sum(1), k)
    er, tr = ref.ell_rows_from_dense(jnp.array(a), ka), \
        rt.ell_rows_from_dense(a, ka, device="cpu")
    ec, tc = ref.ell_cols_from_dense(jnp.array(a), kb), \
        rt.ell_cols_from_dense(a, kb, device="cpu")
    for got, want in ((tr, er), (tc, ec)):
        _eq(got.val, want.val)
        _eq(got.idx, want.idx)
        assert got.idx.dtype == torch.int32
        assert (got.k, got.n_rows, got.n_cols) == (want.k, want.n_rows,
                                                    want.n_cols)
        _eq(got.to_dense(), want.to_dense())
        _eq(got.valid_mask(), want.valid_mask())
    cap = a.size
    ecoo = ref.coo_from_dense(jnp.array(a), cap)
    tcoo = rt.coo_from_dense(a, cap, device="cpu")
    for f in ("row", "col", "val", "ngroups"):
        _eq(getattr(tcoo, f), getattr(ecoo, f))
    _eq(tcoo.to_dense(), ecoo.to_dense())
    assert int(tcoo.nnz()) == int(ecoo.nnz()) == int((a != 0).sum())
    assert not bool(tcoo.overflowed())


@pytest.mark.parametrize("k", [3, 9])
def test_scipy_constructors_and_numpy_carry_over(k):
    """Host ELLPACK planes match the reference's; ``from_numpy`` carries the
    reference's planes across unchanged and ``to_numpy`` brings a Coo
    back."""
    a = sp.random(30, 20, density=0.2, format="csr", dtype=np.float32,
                  random_state=np.random.default_rng(k))
    for fn in ("np_ell_rows_from_scipy", "np_ell_cols_from_scipy"):
        src = a.tocsc() if fn == "np_ell_rows_from_scipy" else a
        for got, want in zip(getattr(tf, fn)(src, k), getattr(ref, fn)(src, k)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
    er = ref.ell_rows_from_dense(jnp.array(a.toarray()), k)
    ec = ref.ell_cols_from_dense(jnp.array(a.toarray()), k)
    tr = rt.from_numpy(er.val, er.idx, n_rows=er.n_rows, device="cpu")
    tc = rt.from_numpy(ec.val, ec.idx, n_cols=ec.n_cols, device="cpu")
    assert isinstance(tr, rt.EllRows) and isinstance(tc, rt.EllCols)
    assert tr.idx.dtype == tc.idx.dtype == torch.int32
    _eq(tr.to_dense(), er.to_dense())
    _eq(tc.to_dense(), ec.to_dense())
    coo = rt.coo_from_dense(a.toarray(), 64, device="cpu")
    row, col, val, ng = rt.to_numpy(coo)
    ecoo = ref.coo_from_dense(jnp.array(a.toarray()), 64)
    for got, want in ((row, ecoo.row), (col, ecoo.col), (val, ecoo.val),
                      (ng, ecoo.ngroups)):
        np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(ValueError):
        rt.from_numpy(er.val, er.idx, device="cpu")


PORTED_MODULES = {"configs": "repro_torch.configs", "core": "repro_torch.core",
                  "hwmodel": "repro_torch.core.hwmodel",
                  "hybrid": "repro_torch.core.hybrid",
                  "kernels": "repro_torch.kernels",
                  "models": "repro_torch.models", "obs": "repro_torch.obs",
                  "plan": "repro_torch.plan",
                  "sccp": "repro_torch.core.sccp",
                  "serve": "repro_torch.serve"}


@pytest.mark.parametrize("name", sorted(PORTED_MODULES))
def test_reference_modules_resolve_in_a_fresh_process(name):
    """Each submodule the reference reaches as ``repro.<name>``
    (``repro._MODULES``) and the port has ported resolves as
    ``repro_torch.<name>`` right after ``import repro_torch``, in a process
    that imported nothing else; the unported ones stay absent."""
    import repro
    unported = set()
    assert set(repro._MODULES) == set(PORTED_MODULES) | unported
    assert repro._MODULES[name].replace("repro.", "repro_torch.", 1) \
        == PORTED_MODULES[name]
    code = (f"import sys, repro_torch\n"
            f"m = repro_torch.{name}\n"
            f"assert m is sys.modules[{PORTED_MODULES[name]!r}], m\n"
            f"assert {name!r} in repro_torch.__all__\n"
            f"assert not any(hasattr(repro_torch, u) for u in "
            f"{sorted(unported)!r})\n"
            f"assert 'jax' not in sys.modules\nprint('ok')")
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr


def test_coo_overflow_flag():
    a = np.eye(8, dtype=np.float32)
    coo = rt.coo_from_dense(a, 5, device="cpu")     # 8 nnz, cap 5
    assert int(coo.ngroups) == 8 and bool(coo.overflowed())
    ecoo = ref.coo_from_dense(jnp.array(a), 5)
    for f in ("row", "col", "val"):
        _eq(getattr(coo, f), getattr(ecoo, f))
    bare = rt.Coo(row=coo.row, col=coo.col, val=coo.val, shape=coo.shape)
    assert not bool(bare.overflowed())


def test_top_level_names_are_the_references_ported_ones():
    """Every name of the reference's top level is the port's too, the
    distributed planning's (``make_dist_plan``, ``DistPlan``) included;
    the port's own extras (device helpers, host constructors, the MoE
    layer, ``parallel``) are not the reference's top-level names."""
    import repro
    ref_names = set(repro._NAMES)
    shared = {n for n in rt.__all__ if n in ref_names}
    assert shared == ref_names          # nothing of the reference unported
    for name in shared:
        assert getattr(rt, name) is not None
    assert rt.nm_spmm is rt.kernels.nm_spmm.nm_spmm
    assert rt.make_plan is rt.plan.make_plan
    assert rt.make_dist_plan is rt.plan.planner.make_dist_plan
    assert rt.DistPlan is rt.plan.planner.DistPlan
