"""The inputs a cell makes from its seed, the reference product, and the
kernel counts, at tiny sizes on the CPU."""
import itertools

import numpy as np
import pytest
import torch

from conftest import TINY
from portbench import operands as ops
from portbench import verdict
from portbench.bench import HERE, _load
from portbench.reference import generator
from portbench.reference.product import product

CPU = torch.device("cpu")


def tiny_matrix(c_rows=TINY["c_rows"]):
    cfg = dict(TINY, count_seed=11, place_seed=12, c_rows=c_rows)
    return ops.load_matrix(cfg, CPU)


def test_generator_is_the_table1_generator():
    indptr, indices = generator.pattern(300, 9000, 4.0, 1003, 2003)
    assert indptr[-1] == 9000 and indices.dtype == np.int32
    counts = generator.row_counts(300, 9000, 4.0, 1003)
    assert (np.diff(indptr) == counts).all()
    for r in range(300):                # distinct columns in every row
        row = indices[indptr[r]:indptr[r + 1]]
        assert len(set(row.tolist())) == len(row)
    assert generator.table1_row("bcsstk32")[2:4] == (45_000, 2_000_000)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7, 2 ** 62 + 3])
def test_inputs_repeat_for_a_seed_and_differ_across_seeds(seed):
    m = tiny_matrix()
    v1, v2 = ops.draw_values(m, 2, seed), ops.draw_values(m, 2, seed)
    assert torch.equal(v1, v2)
    assert not torch.equal(v1, ops.draw_values(m, 2, seed + 1))
    assert set(v1.unique().tolist()) == {-4., -3., -2., -1., 1., 2., 3., 4.}
    k1 = ops.draw_keeps(m, [0.0, 0.1], seed)
    assert torch.equal(k1, ops.draw_keeps(m, [0.0, 0.1], seed))
    assert not torch.equal(k1, ops.draw_keeps(m, [0.0, 0.1], seed + 1))
    assert int((~k1[1]).sum()) == round(0.1 * m.nnz) and bool(k1[0].all())
    g1 = ops.device_generator(seed, "relabel", CPU)
    g2 = ops.device_generator(seed, "relabel", CPU)
    assert torch.equal(torch.randperm(50, generator=g1),
                       torch.randperm(50, generator=g2))


def _dense_from_planes(pl, vs, c_rows, dim):
    """C = A·B from the ELLPACK planes by brute force."""
    a = torch.zeros(c_rows, dim, dtype=torch.float64)
    b = torch.zeros(dim, dim, dtype=torch.float64)
    for s, c in itertools.product(range(pl.a_idx.shape[0]), range(dim)):
        if pl.a_idx[s, c] >= 0:
            a[pl.a_idx[s, c], c] = pl.a_val[vs, s, c]
    for r, s in itertools.product(range(dim), range(pl.b_idx.shape[1])):
        if pl.b_idx[r, s] >= 0:
            b[r, pl.b_idx[r, s]] = pl.b_val[vs, r, s]
    return a @ b


def test_planes_hold_x_top_rows_and_its_transpose():
    m = tiny_matrix(c_rows=100)
    vals = ops.draw_values(m, 1, 5)
    keep = ops.draw_keeps(m, [0.05], 5)
    pl = ops.planes(m, vals, keep[0])
    x = torch.zeros(m.dim, m.dim, dtype=torch.float64)
    ok = keep[0][m.csr_pos]
    x[m.row[ok], m.col[ok]] = vals[0][m.csr_pos][ok].double()
    want = x[:100] @ x.T
    assert torch.equal(_dense_from_planes(pl, 0, 100, m.dim), want)
    assert pl.products == int(((x[:100] != 0).double()
                               @ (x.T != 0).double()).sum())


def test_a_relabelled_product_mapped_back_is_the_reference():
    import repro_torch
    m = tiny_matrix()
    vals = ops.draw_values(m, 1, 9)
    pl = ops.planes(m, vals)
    g = ops.device_generator(9, "relabel", CPU)
    p = torch.randperm(m.c_rows, generator=g)
    q = torch.randperm(m.dim, generator=g)
    a = repro_torch.EllRows(val=pl.a_val[0], idx=ops.relabel(pl.a_idx, p),
                            n_rows=m.c_rows)
    b = repro_torch.EllCols(val=pl.b_val[0], idx=ops.relabel(pl.b_idx, q),
                            n_cols=m.dim)
    c = repro_torch.spgemm(a, b, accumulator="auto")
    val = vals[0][m.csr_pos]
    blocks = list(product(m.row, m.col, val, dim=m.dim, c_rows=m.c_rows,
                          p=p, q=q, max_products=3000))
    assert len(blocks) > 1
    got = verdict.compare(c.row, c.col, c.val, c.ngroups, blocks, m.dim)
    assert got == {"coord_mismatch": 0, "val_err": 0.0, "ngroups_gap": 0}
    # mapped back through the inverse permutations: the plain product
    ok = c.row >= 0
    dense = torch.zeros(m.c_rows, m.dim, dtype=torch.float64)
    pinv, qinv = torch.argsort(p), torch.argsort(q)
    dense[pinv[c.row[ok].long()], qinv[c.col[ok].long()]] = c.val[ok].double()
    assert torch.equal(dense, _dense_from_planes(pl, 0, m.c_rows, m.dim))


def test_compare_counts_each_kind_of_fault():
    m = tiny_matrix()
    val = ops.draw_values(m, 1, 3)[0][m.csr_pos]
    blocks = list(product(m.row, m.col, val, dim=m.dim, c_rows=m.c_rows))
    key = torch.cat([b.key for b in blocks])
    v = torch.cat([b.val for b in blocks]).float()
    row, col = key // m.dim, key % m.dim
    n = key.numel()
    same = verdict.compare(row, col, v, n, blocks, m.dim)
    assert same == {"coord_mismatch": 0, "val_err": 0.0, "ngroups_gap": 0}
    v2 = v.clone()
    v2[7] += 1
    assert verdict.compare(row, col, v2, n, blocks, m.dim)["val_err"] == 1.0
    half = verdict.compare(row[: n // 2], col[: n // 2], v[: n // 2], n // 2,
                           blocks, m.dim)
    assert half["coord_mismatch"] > 0 and half["ngroups_gap"] > 0


def _brute(x, c_rows):
    """nnz_a, nnz_b, products, nnz_c of X[:c_rows]·Xᵀ by enumeration."""
    nz = [(r, c) for r in range(x.shape[0]) for c in range(x.shape[1])
          if x[r, c]]
    prods, coords = 0, set()
    for (r, s), (j, t) in itertools.product(nz, nz):
        if r < c_rows and s == t:
            prods += 1
            coords.add((r, j))
    return {"nnz_a": sum(r < c_rows for r, _ in nz), "nnz_b": len(nz),
            "products": prods, "nnz_c": len(coords)}


def test_counts_match_a_hand_count():
    x = np.array([[1, 0, 2, 0], [0, 3, 0, 0], [4, 0, 0, 5], [0, 6, 7, 0]])
    s = _brute(x, 2)
    # rows 0, 1 against all: row 0 meets rows 0, 2, 3 (columns 0, 2);
    # row 1 meets rows 1, 3 (column 1)
    assert s == {"nnz_a": 3, "nnz_b": 7, "products": 6, "nnz_c": 5}
    want = {"sccp_multiply": (8 * 10 + 8 * 6, 6),
            "fused_slab_sort": (8 * 10 + 8 * 6, 6),
            "align_product_keys": (8 * 6 + 4 * 5, 0),
            "align_keys": (8 * 6 + 4 * 5, 0),
            "emit_sort": (16 * 6, 0), "sort_tiles": (16 * 6, 0),
            "merge_runs": (16 * 6, 0), "bin_ranks": (16 * 6, 0),
            "minima_mask": (4 * 6, 0)}
    for path in sorted((HERE / "counts").glob("*.py")):
        assert _load(path).need(s) == want[path.stem], path.stem
    m = ops.matrix_from_csr(*_csr(x), dim=4, c_rows=2, device=CPU)
    assert ops.planes(m, torch.ones(1, 7)).products == 6


def _csr(x):
    indptr = np.concatenate([[0], np.cumsum((x != 0).sum(1))]).astype(
        np.int64)
    indices = np.concatenate([np.nonzero(r)[0] for r in x]).astype(np.int32)
    return indptr, indices
