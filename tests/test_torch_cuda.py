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
from repro_torch.kernels import radix_sort as trs
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


@pytest.mark.parametrize("k_a,n,k_b", [(1, 45000, 72), (3, 1001, 7),
                                       (2, 5, 2), (1, 3, 1)])
def test_sccp_multiply_kernel_edges(cuda, k_a, n, k_b):
    """Integer-valued operands: a one-slab call (the streaming step's
    shape), n·k_b not a multiple of 4 (slabs that start off a 16-byte
    boundary, a partial last block), fewer lanes than four."""
    rng = np.random.default_rng(k_a * n + k_b)
    a_val = rng.integers(-4, 5, (k_a, n)).astype(np.float32)
    b_val = rng.integers(-4, 5, (n, k_b)).astype(np.float32)
    a_idx = rng.integers(-1, 9, (k_a, n)).astype(np.int32)
    b_idx = rng.integers(-1, 9, (n, k_b)).astype(np.int32)
    args = [torch.from_numpy(t).to(cuda) for t in (a_val, a_idx, b_val,
                                                   b_idx)]
    got = tsm.sccp_multiply(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, tsm.sccp_multiply_plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("k_b", [72, 5])
def test_sccp_multiply_kernel_row_slices(cuda, k_b):
    """A row slice of A, as the warm 'stream' loop passes one slab group
    (``a_val[sl]``), and B starting one row in, so B's planes lie 16-byte
    aligned (k_b = 72) or not (k_b = 5): the plain twin's planes bit for
    bit."""
    rng = np.random.default_rng(k_b)
    n = 2003
    a_val = torch.from_numpy(rng.integers(-4, 5, (6, n)).astype(np.float32))
    a_idx = torch.from_numpy(rng.integers(-1, 40, (6, n)).astype(np.int32))
    b_val = torch.from_numpy(rng.integers(-4, 5, (n + 1, k_b))
                             .astype(np.float32))
    b_idx = torch.from_numpy(rng.integers(-1, 40, (n + 1, k_b))
                             .astype(np.int32))
    a_val, a_idx, b_val, b_idx = (t.to(cuda) for t in (a_val, a_idx, b_val,
                                                       b_idx))
    for sl in (slice(1, 2), slice(2, 5)):
        args = (a_val[sl], a_idx[sl], b_val[1:], b_idx[1:])
        got = tsm.sccp_multiply(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, tsm.sccp_multiply_plain(*args)):
            assert torch.equal(g, w)


def _radix_grids(row):
    """Grids of one radix sort: one in shared memory for a row of at most a
    tile, else a count, a scan and a scatter for each digit."""
    return 1 if row <= trs.TILE else 3 * trs.PASSES


def _emit_keys(kind, seed, n):
    """K2 operands: packed-range keys with dead lanes, one key everywhere,
    or keys over the whole int32 range (negatives, INT32_MIN and
    KEY_INVALID among them)."""
    if kind == "random":
        return _keys(seed, n, KI)
    rng = np.random.default_rng(seed)
    if kind == "equal":
        return torch.full((n,), int(rng.integers(-KI, KI)), dtype=torch.int32)
    key = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    key[rng.random(n) < 0.05] = KI
    key[rng.random(n) < 0.05] = -2 ** 31
    return torch.from_numpy(key)


@pytest.mark.parametrize("n,tile,kind", [
    (1, 4096, "random"), (2, 4096, "random"), (4096, 4096, "random"),
    (1 << 13, 4096, "random"), (1 << 20, 4096, "random"),
    (1 << 12, 64, "random"), (1 << 15, 256, "random"),
    (1, 4096, "int32"), (2, 4096, "int32"), (4096, 4096, "int32"),
    (1 << 22, 4096, "int32"), (1 << 24, 4096, "int32"),  # 4 tiles a block
    (4096, 4096, "equal"), (1 << 20, 4096, "equal")])
def test_emit_sort_kernel(cuda, n, tile, kind):
    key = _emit_keys(kind, n + tile, n).to(cuda)
    kept = key.clone()
    before = tis.emit_sort_keys.launches
    got = tis.emit_sort_keys(key, tile=tile)
    torch.cuda.synchronize()
    assert tis.emit_sort_keys.launches - before == _radix_grids(n)
    assert torch.equal(got, tis.emit_sort_keys_plain(key))
    assert torch.equal(key, kept)                    # the input is not written
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


def _product_stream(seed, k_a, n, k_b, n_rows, n_cols, *, dead_as=KI,
                    pad=True, dead=0.3, heavy=0.0):
    """K3's operands as the main path forms them: packed keys of SCCP's
    (k_a, n, k_b) lanes (dead lanes packed as ``dead_as``: KEY_INVALID on
    the cold 'search' path, 0 on the warm one), padded with KEY_INVALID to
    a power of two where ``pad``, B's valid slots first, and each group's
    row as ``ops.align_products`` takes it (A's row where the group's first
    B slot is valid, else −1). A share ``heavy`` of A's slots fall in rows
    0 and 1 (skewed rows)."""
    rng = np.random.default_rng(seed)
    a_idx = np.where(rng.random((k_a, n)) < 1 - dead,
                     rng.integers(0, n_rows, (k_a, n)), -1)
    a_idx = np.where((a_idx >= 0) & (rng.random((k_a, n)) < heavy),
                     a_idx % 2, a_idx)
    nb = rng.binomial(k_b, 1 - dead, n)
    b_idx = np.where(np.arange(k_b)[None, :] < nb[:, None],
                     rng.integers(0, n_cols, (n, k_b)), -1)
    row = np.broadcast_to(a_idx[:, :, None], (k_a, n, k_b))
    col = np.broadcast_to(b_idx[None, :, :], (k_a, n, k_b))
    ok = (row >= 0) & (col >= 0)
    pk = np.where(ok, row * n_cols + col, dead_as).reshape(-1)
    if pad:
        pot = 1 << max(0, pk.size - 1).bit_length()
        pk = np.concatenate([pk, np.full(pot - pk.size, KI)])
    group_row = np.where(b_idx[None, :, 0] >= 0, a_idx, -1)
    return pk.astype(np.int32), group_row.astype(np.int32)


def _unique_keys(rng, pk, *, stale=False, equal=False, pad=0):
    """The ascending unique keys of ``pk`` (a structure's or the emission's
    ``uk``; key 0 left out, as dead lanes may be packed as 0); ``stale``
    drops a tenth of them and adds keys no product has; ``equal`` repeats
    every seventh (an ascending list that is not unique); ``pad``
    KEY_INVALID slots after them."""
    uk = np.unique(pk[(pk != KI) & (pk > 0)])
    if stale and uk.size:
        uk = uk[rng.random(uk.size) > 0.1]
        uk = np.unique(np.concatenate([uk, rng.integers(0, uk.max() + 9,
                                                        uk.size // 10)]))
    if equal:
        uk = np.sort(np.concatenate([uk, uk[::7]]))
    return np.concatenate([uk, np.full(pad, KI)]).astype(np.int32)


ALIGN_CASES = {
    # name: (k_a, n, k_b, n_rows, n_cols, stream kwargs, uk kwargs)
    "search": (6, 700, 9, 300, 310, {}, {}),
    "numeric": (6, 700, 9, 300, 310, dict(dead_as=0, pad=False),
                dict(pad=77)),
    "empty_rows": (2, 50, 5, 4000, 4000, {}, {}),
    "long_rows": (8, 3000, 8, 4, 40000, {}, dict(pad=3)),
    "wide_rows": (8, 3000, 8, 4, 200000, {}, dict(pad=3)),
    "wide_short": (4, 500, 8, 4, 300000, dict(dead_as=0, pad=False), {}),
    "equal_keys": (6, 700, 9, 300, 310, {}, dict(equal=True)),
    "few_rows": (16, 5000, 64, 4, 4000, dict(dead_as=0, pad=False), {}),
    "skewed_rows": (16, 5000, 64, 300, 4000,
                    dict(dead_as=0, pad=False, heavy=0.5), {}),
    "stale": (5, 900, 11, 200, 250, dict(dead_as=0, pad=False),
              dict(stale=True, pad=5)),
    "no_unique": (3, 64, 4, 16, 16, dict(dead=1.0), {}),
    "one_lane": (1, 1, 1, 1, 1, dict(pad=False), {}),
    "bcsstk32_cut": (16, 5000, 16, 5000, 5000, dict(dead_as=0, pad=False),
                     {}),
}


@pytest.mark.parametrize("case", sorted(ALIGN_CASES))
def test_align_product_keys_kernel(cuda, case):
    """The grouped K3 against the plain twin (``torch.searchsorted``) bit
    for bit, and the flat kernel: dead lanes of A and B packed as
    KEY_INVALID or 0, the power-of-two padding, empty rows of C, rows
    ranked in a bitmap (n_cols up to 131,072) and rows searched in place
    (wider, with long and short segments), equal keys in uk (searched),
    four rows of 1.28M lanes each (cut into runs, one a block), two rows of
    ~1.3M lanes among 298 light ones (as many blocks as each row's lanes
    need), a stale uk, u = 0 and one lane;
    then the same keys under group rows drawn at random (wrong, out of
    range); the grids one call launches."""
    k_a, n, k_b, n_rows, n_cols, skw, ukw = ALIGN_CASES[case]
    rng = np.random.default_rng(len(case))
    pk, group_row = _product_stream(n + k_b, k_a, n, k_b, n_rows, n_cols,
                                    **skw)
    uk = _unique_keys(rng, pk, **ukw)
    wrong = rng.integers(-3, n_rows + 3, group_row.shape).astype(np.int32)
    pk, uk = torch.from_numpy(pk).to(cuda), torch.from_numpy(uk).to(cuda)
    want = tis.align_keys_plain(pk, uk)
    for rows in (group_row, wrong):
        before = tis.align_product_keys.launches
        got = tis.align_product_keys(pk, uk, torch.from_numpy(rows).to(cuda),
                                     k_b=k_b, n_rows=n_rows, n_cols=n_cols)
        torch.cuda.synchronize()
        assert tis.align_product_keys.launches - before == tis.align_grids(
            pk.numel(), rows.size, k_b, n_rows)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    flat = tis.align_keys(pk, uk)
    assert torch.equal(flat[0], want[0]) and torch.equal(flat[1], want[1])


def test_align_product_keys_kernel_checks(cuda):
    """A wrong dtype or layout, or groups that overrun the keys, raise."""
    pk, group_row = _product_stream(3, 2, 40, 3, 20, 20)
    pk = torch.from_numpy(pk).to(cuda)
    uk = torch.unique(pk)
    rows = torch.from_numpy(group_row).to(cuda)
    kw = dict(k_b=3, n_rows=20, n_cols=20)
    with pytest.raises(TypeError):
        tis.align_product_keys(pk, uk, rows.long(), **kw)
    with pytest.raises(TypeError):
        tis.align_product_keys(pk, uk, rows.T, **kw)
    with pytest.raises(ValueError):
        tis.align_product_keys(pk[:100], uk, rows, **kw)


def _lanes(n):
    """``n``, or ``"C"`` / ``"C+1"``: one block's keys of the K4 kernels
    (``minima_chunk()``, the built library's answer), and one more."""
    if isinstance(n, int):
        return n
    return tis.minima_chunk() + int(n.partition("+")[2] or 0)


def test_minima_chunk(cuda):
    """A block of the K4 kernels holds 1,024 threads x 16 keys."""
    assert tis.minima_chunk() == 16384


@pytest.mark.parametrize("n,parts", [(0, 0), (1, 0), ("C", 0), ("C+1", 2),
                                     (1 << 20, 64), (1 << 28, 1024),
                                     (2 ** 31 - 1, 1024)])
def test_minima_parts(cuda, n, parts):
    """The mask entry's scratch: none while one block holds the keys, one
    value a block of grid 1 above, at most 1,024 blocks."""
    assert tis.minima_parts(_lanes(n)) == parts


@pytest.mark.parametrize("n,hi,dead", [(1, 8, 0.0), (1000, 4, 0.2),
                                       (1 << 20, 1 << 30, 0.1),
                                       (3000, 100, 1.0), ("C", 4, 0.3),
                                       ("C+1", 1 << 30, 0.1),
                                       (1 << 20, 16, 0.5)])
def test_minima_mask_kernel(cuda, n, hi, dead):
    n = _lanes(n)
    v = _keys(n, n, hi, dead).to(cuda)
    got = tis.minima_mask(v)
    torch.cuda.synchronize()
    assert torch.equal(got, tis.minima_mask_plain(v))


@pytest.mark.parametrize("n,grids", [(0, 0), (1, 1), ("C", 1), ("C+1", 2),
                                     (1 << 20, 2)])
def test_minima_mask_kernel_grids(cuda, n, grids):
    """One grid while one block holds the keys, two above (each block's
    value, then the mask), none for an empty stream."""
    n = _lanes(n)
    v = _keys(n + 1, n, 1 << 30, 0.1).to(cuda)
    before = tis.minima_mask.launches
    got = tis.minima_mask(v)
    torch.cuda.synchronize()
    assert tis.minima_mask.launches == before + grids
    assert got.shape == v.shape and got.dtype == torch.bool
    if n:                          # the plain min has no empty reduction
        assert torch.equal(got, tis.minima_mask_plain(v))


@pytest.mark.parametrize("n,hi,dead,cap", [
    (1, 8, 0.0, 4),                        # one key
    (1000, 4, 0.2, 2),                     # ties, cap below the unique count
    (1000, 500, 0.1, 1200),                # cap far above: the early stop
    (8192, 400, 0.5, 512),                 # the faithful cut's shape
    ("C", 1 << 20, 0.1, 300), ("C", 3000, 0.1, 4096),
    ("C", 1 << 20, 0.0, 2048),             # a cap of 2,048, all emitted
    ("C", 1025, 0.0, 4096),                # 1,025 keys emitted, then padding
    ("C+1", 200, 0.1, 256),                # past one block: the step loop
    ("C+1", 1 << 20, 0.1, 64),
    (3000, 100, 1.0, 64)])                 # every lane dead
def test_faithful_emit_kernel(cuda, n, hi, dead, cap):
    """The one-launch emission against its plain loop (values, counts and
    nnz bit for bit) and the batched emission (uk, on the stream padded to
    a power of two with dead lanes); the caller's keys are
    never written; one launch up to a block's keys, the step loop's two
    grids a step above."""
    n = _lanes(n)
    key = _keys(n + cap, n, hi, dead).to(cuda)
    kept = key.clone()
    want = tis.faithful_emit_plain(key, cap)
    before = tis.minima_mask.launches
    got = tis.faithful_emit(key, cap)
    torch.cuda.synchronize()
    assert tis.minima_mask.launches - before == \
        (1 if n <= tis.minima_chunk() else 2 * cap)
    assert torch.equal(key, kept)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    vals, counts = tis.search_emit_sorted(key, cap)
    assert torch.equal(vals, want[0]) and torch.equal(counts, want[1])
    uk_f, nnz_f = tis.emit_sorted_unique(key, cap, faithful=True)
    pad = key.new_full((tis.next_pot(n) - n,), KI)   # the batched sort's
    uk_b, nnz_b = tis.emit_sorted_unique(torch.cat([key, pad]), cap)
    assert torch.equal(uk_f, uk_b) and torch.equal(uk_f, want[0])
    n_uniq = int(nnz_b)
    assert int(nnz_f) == int(want[2]) == (n_uniq if n_uniq <= cap
                                          else cap + 1)
    assert torch.equal(key, kept)


def test_minima_kernels_refuse_bad_keys(cuda):
    """int64 or strided keys, and streams of 2^31 lanes (a broadcast view,
    nothing allocated), are refused."""
    v = _keys(3, 1000, 64).to(cuda)
    for bad in (v.long(), v[::2]):
        with pytest.raises(TypeError):
            tis.minima_mask(bad)
        with pytest.raises(TypeError):
            tis.faithful_emit(bad, 8)
        with pytest.raises(TypeError):
            tis.emit_sorted_unique(bad, 8, faithful=True)
    big = torch.zeros(1, dtype=torch.int32, device=cuda).expand(2 ** 31)
    with pytest.raises(ValueError, match="2147483647 lanes"):
        tis.minima_mask(big)
    with pytest.raises(ValueError, match="2147483647 lanes"):
        tis.faithful_emit(big, 8)


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


def _same_compact(got, want):
    """A merge-and-compact result: buffer, totals, count and dropped."""
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w.to(g.device))


def _row_pairs(kind, seed, n, tile, hi):
    """K5 operands. "random": keys from [0, hi) with dead lanes; "int32":
    the whole int32 range; "padded": each row's real keys share their high
    digits and its tail is KEY_INVALID padding, as a 'bucket' or 'hash' row
    is; "runs": long runs of a few keys (every total exact on integer
    values)."""
    if kind == "random":
        return _pairs(seed, n, hi)
    rng = np.random.default_rng(seed)
    val = rng.integers(-4, 5, n).astype(np.float32)
    if kind == "int32":
        key = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
        key = key.astype(np.int32)
        key[rng.random(n) < 0.05] = KI
    elif kind == "padded":
        rows = n // tile
        base = (np.arange(rows) + 64) << 20          # a row's high digits
        key = (base[:, None] + rng.integers(0, 1 << hi, (rows, tile)))
        real = rng.integers(tile // 4, tile, rows)
        key[np.arange(tile)[None, :] >= real[:, None]] = KI
        key = key.reshape(-1).astype(np.int32)
    else:
        lengths = rng.integers(1, 3 * tile // 2, n // (tile // 2) + 8)
        key = np.resize(np.repeat(rng.integers(0, 40, lengths.size), lengths),
                        n)
        key = np.sort(key.reshape(-1, tile), axis=1)[:, ::-1].reshape(-1)
        key = np.ascontiguousarray(key).astype(np.int32)
    val[key == KI] = 0
    return torch.from_numpy(key), torch.from_numpy(val)


@pytest.mark.parametrize("n,tile,hi,kind", [
    (1, 1, 8, "random"), (2, 2, 8, "random"),
    (256, 64, 40, "random"),                         # rows inside one tile
    (1 << 14, 4096, 1 << 12, "random"),              # 'tiled' rows
    (1 << 15, 8192, 300, "random"),                  # rows of two tiles
    (4 * (1 << 16), 1 << 16, 1 << 20, "random"),     # odd rows ascend too
    (1 << 21, 1 << 20, 1 << 10, "random"),           # 'bucket'-sized rows
    (1 << 12, 512, 0, "int32"), (1 << 14, 4096, 0, "int32"),
    (1 << 17, 1 << 15, 0, "int32"),
    (1 << 24, 1 << 22, 0, "int32"),                  # 4 tiles a block
    (1 << 14, 4096, 0, "equal"), (1 << 18, 1 << 16, 0, "equal"),
    (1 << 18, 1 << 16, 12, "padded"), (1 << 22, 1 << 21, 16, "padded"),
    (1 << 16, 4096, 0, "runs"), (1 << 20, 1 << 18, 0, "runs"),
    # several rows a shared tile (a partial last tile in three): one row pass
    (3 * 4096 + 256, 256, 40, "random"), (3 * 4096, 16, 0, "int32"),
    (6144, 2048, 0, "runs"), (1 << 16, 256, 4, "padded"),
    (1 << 14, 64, 0, "equal"),
    # two row passes (more than 256 rows a tile)
    (4096 * 2 + 8 * 7, 8, 0, "int32"), (10000, 2, 8, "random"),
    (1 << 13, 1, 8, "random"),
])
def test_sort_tiles_kernel(cuda, n, tile, hi, kind):
    if kind == "equal":
        key = torch.full((n,), 7, dtype=torch.int32)
        val = torch.from_numpy(np.random.default_rng(n).integers(
            -4, 5, n).astype(np.float32))
    else:
        key, val = _row_pairs(kind, n + tile, n, tile, hi)
    key, val = key.to(cuda), val.to(cuda)
    before = tbm.sort_tiles.launches
    got = tbm.sort_tiles(key, val, tile=tile)
    torch.cuda.synchronize()
    assert tbm.sort_tiles.launches - before == _radix_grids(tile) + 1
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
    # rows of at most a window: the merge grid; longer: partition + merge
    assert tbm.merge_runs.launches - before == (1 if 2 * run <= 4096 else 2)
    _same_pairs(got, tbm.merge_runs_plain(key, val, run=run))


@pytest.mark.parametrize("n,run", [(2, 1), (1024, 64), (1 << 13, 2048),
                                   (1 << 14, 4096), (1 << 15, 8192),
                                   (1 << 18, 1 << 16)])
def test_merge_runs_kernel_shared_keys(cuda, n, run):
    """Both runs of a row hold the same keys, with repeats and float
    totals: every group straddles the runs (and the windows' edges), and
    its total is the two tails' sum, bit for bit as the plain twin's."""
    rng = np.random.default_rng(n + 7)
    rows = n // (2 * run)
    key = np.sort(rng.integers(0, max(2, run // 3), (rows, run)), axis=1)
    key = np.concatenate([key, key], axis=1).reshape(-1).astype(np.int32)
    key[-3:] = KI                          # a KEY_INVALID tail in the last run
    val = rng.standard_normal(n).astype(np.float32)
    k, v = tbm.sort_tiles_plain(torch.from_numpy(key), torch.from_numpy(val),
                                tile=run)
    k, v = k.to(cuda), v.to(cuda)
    _same_pairs(tbm.merge_runs(k, v, run=run),
                tbm.merge_runs_plain(k, v, run=run))


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


def test_bin_ranks_kernel_lane_limit(cuda):
    """Counts and ranks are int32: a stream of 2^31 lanes (a broadcast
    view, nothing allocated) is refused with the limit named."""
    big = torch.zeros(1, dtype=torch.int32, device=cuda).expand(2 ** 31)
    with pytest.raises(ValueError, match="2147483647 lanes"):
        trb.bin_ranks(big, n_buckets=4)
    with pytest.raises(ValueError, match="2147483647 lanes"):
        trb.bin_stream(big, big.float(), n_buckets=4, bucket_cap=1 << 20,
                       keys_per_bucket=100)


def _bin_keys(seed, n, n_buckets, kpb, dead, kind):
    """Keys for the binning: runs of one key range with some past the last
    bucket's span, all in one bucket, or keys below 0 among them; dead
    lanes; float values that are not integers."""
    rng = np.random.default_rng(seed)
    if kind == "one":
        key = rng.integers(kpb, 2 * kpb, n)
    else:
        key = np.repeat(rng.integers(0, (n_buckets + 1) * kpb, -(-n // 37)),
                        37)[:n] + rng.integers(0, 5, n)
    key = key.astype(np.int32)
    if kind == "negative":
        neg = rng.random(n) < 0.05
        key[neg] = rng.integers(-2 ** 31, 0, int(neg.sum()))
    key[rng.random(n) < dead] = KI
    val = rng.standard_normal(n).astype(np.float32)
    return torch.from_numpy(key), torch.from_numpy(val)


@pytest.mark.parametrize("n,n_buckets,cap,kpb,dead,kind", [
    (1, 1, 1, 1, 0.0, "runs"),                # one lane
    (5000, 3, 1024, 1000, 0.2, "runs"),       # drops in some buckets
    (1 << 20, 64, 1 << 15, 9000, 0.4, "runs"),  # empty tails, 256 tiles
    (123457, 256, 512, 300, 0.1, "runs"),     # n not a multiple of the tile
    (4096, 1, 4096, 7, 0.0, "runs"),          # one bucket, ids clamped
    (20000, 8, 1 << 14, 1000, 1.0, "runs"),   # every lane dead
    (70000, 64, 1 << 17, 5000, 0.1, "one"),   # one bucket holds everything
    (30001, 5, 4096, 1, 0.3, "negative"),     # keys_per_bucket 1, keys < 0
    (1 << 16, 3, 16, 2 ** 31 - 1, 0.0, "runs")])  # the widest span
def test_bin_stream_kernel(cuda, n, n_buckets, cap, kpb, dead, kind):
    """The binning entry against its plain twin, bit for bit on float
    values: both layouts and the drop count, in three grids."""
    key, val = (t.to(cuda) for t in _bin_keys(n + n_buckets, n, n_buckets,
                                              kpb, dead, kind))
    kw = dict(n_buckets=n_buckets, bucket_cap=cap, keys_per_bucket=kpb)
    before = trb.bin_ranks.launches
    got = trb.bin_stream(key, val, **kw)
    torch.cuda.synchronize()
    assert trb.bin_ranks.launches == before + 3
    want = trb.bin_stream_plain(key, val, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    with pytest.raises(TypeError):
        trb.bin_stream(key, val.double(), **kw)
    with pytest.raises(ValueError):
        trb.bin_stream(key, val, **dict(kw, n_buckets=trb.MAX_BUCKETS + 1))


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
    (1, 16385, 4, 0.3),          # 65,540 lanes → 2^17: pad and dead lanes
                                 # are more than half of pot
    (3, 2000, 24, 0.2),          # a group of 3, 144,000 lanes → 2^18
    (1, 26368, 80, 0.3),         # 515 tiles: blocks of 2, the last of 1
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


@pytest.mark.parametrize("group,n,k_b", [(1, 4096, 16), (2, 1000, 9),
                                         (1, 60, 64)])
def test_fused_slab_sort_kernel_float_values(cuda, group, n, k_b):
    """Normal float operands, long runs: the keys are bit-identical to the
    plain twin's; the sort is stable, so each total is bit for bit the sum
    of its run's products in lane order from the tail back (how the totals
    grid walks a run). The plain twin sums a run by a log-step scan, so on
    runs of four lanes or more the two round differently: they agree within
    2·len·2^-24 of the run's sum of magnitudes."""
    ops_in = _slab(group + n + k_b, group, n, k_b, 13, 0.2)
    rng = np.random.default_rng(k_b)
    for i in (0, 2):
        ops_in[i] = torch.from_numpy(
            rng.standard_normal(tuple(ops_in[i].shape)).astype(np.float32))
    if group == 1:
        ops_in[:2] = [t[0].contiguous() for t in ops_in[:2]]
    dev_in = [t.to(cuda) for t in ops_in]
    key, tot = tfs.fused_slab_sort(*dev_in, n_cols=13)
    want_key, want_tot = tfs.fused_slab_sort_plain(*ops_in, n_cols=13)
    assert torch.equal(key.cpu(), want_key)
    pot = key.numel()
    pk, pv = tfs._pack_tile(*ops_in, 13, pot)
    order = torch.sort(pk, stable=True).indices.numpy()
    k, v = pk.numpy()[order], pv.numpy()[order]
    seq = np.zeros(pot, np.float32)
    mag = np.zeros(pot, np.float64)
    length = np.zeros(pot, np.int64)
    for i in range(pot):
        if k[i] == KI or (i + 1 < pot and k[i + 1] == k[i]):
            continue
        s, j = v[i], i - 1
        while j >= 0 and k[j] == k[i]:
            s = np.float32(s + v[j])
            j -= 1
        seq[i], length[i] = s, i - j
        mag[i] = np.abs(v[j + 1:i + 1].astype(np.float64)).sum()
    assert length.max() >= 8                     # long runs were formed
    np.testing.assert_array_equal(tot.cpu().numpy(), seq)
    gap = np.abs(tot.cpu().numpy().astype(np.float64)
                 - want_tot.numpy().astype(np.float64))
    assert (gap <= 2 * length * 2.0 ** -24 * mag).all()


def test_fused_slab_sort_grids(cuda):
    """Above one tile a step is the radix sort's 12 grids (three a digit,
    the first digit's two forming the lanes) and the totals; a step of at
    most one tile is one grid."""
    for group, n, k_b, grids in ((1, 4096, 16, 13), (2, 1000, 9, 13),
                                 (1, 1024, 4, 1), (1, 5, 3, 1)):
        ops_in = [t.to(cuda) for t in _slab(n, group, n, k_b, 97)]
        if group == 1:
            ops_in[:2] = [t[0].contiguous() for t in ops_in[:2]]
        before = tfs.fused_slab_sort.launches
        tfs.fused_slab_sort(*ops_in, n_cols=97)
        torch.cuda.synchronize()
        assert tfs.fused_slab_sort.launches - before == grids


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


def _unique_list(rng, length, n_valid, keys):
    """An ascending duplicate-free list of ``n_valid`` of ``keys`` with
    float totals, then KEY_INVALID/0."""
    key = np.full(length, KI, np.int32)
    key[:n_valid] = np.sort(rng.choice(keys, n_valid, replace=False))
    val = np.zeros(length, np.float32)
    val[:n_valid] = rng.standard_normal(n_valid)
    return key, val


@pytest.mark.parametrize("length,na,nb,cap,hi", [
    (128, 100, 60, 128, 400),               # the 128-lane minimum buffer
    (128, 0, 0, 128, 10),                   # an all-KEY_INVALID step
    (1 << 14, 0, 5000, 1 << 14, 1 << 20),   # an empty buffer
    (1 << 14, 9000, 1200, 1 << 14, 20000),  # many keys in both lists
    (1 << 16, 50000, 40000, 1 << 16, 120000),   # drops: uniques > cap
    (1 << 18, 200000, 3000, 1 << 18, 1 << 22),
    (1 << 20, 700000, 500000, 1 << 20, 1 << 21),
])
def test_merge_compact_pair_kernel(cuda, length, na, nb, cap, hi):
    """The stream's merge-and-compact step against its plain twin, bit for
    bit on float totals (each is one two-term sum), ``count`` and
    ``dropped`` included, with the valid counts given on the device and
    without them; four grids a call."""
    rng = np.random.default_rng(length + na + nb)
    lists = [torch.from_numpy(t).to(cuda) for t in
             _unique_list(rng, length, na, hi) + _unique_list(rng, length,
                                                              nb, hi)]
    want = tbm.merge_compact_pair_plain(*lists, cap=cap)
    counts = [torch.tensor(c, dtype=torch.int32, device=cuda)
              for c in (na, nb)]
    before = tbm.merge_runs.launches
    got = tbm.merge_compact_pair(*lists, cap=cap, n_a=counts[0],
                                 n_b=counts[1])
    torch.cuda.synchronize()
    assert tbm.merge_runs.launches - before == 4
    _same_compact(got, want)
    _same_compact(tbm.merge_compact_pair(*lists, cap=cap), want)


def test_merge_compact_pair_kernel_window_edges(cuda):
    """A holds every key, B every odd one, so the merged order repeats
    (A), (A, B): a pair straddles every third 4,096-lane window edge. B's
    valid lanes are half of it. Then a cap below the uniques."""
    n = 1 << 15
    a = np.arange(n, dtype=np.int32)
    b = np.full(n, KI, np.int32)
    b[:n // 2] = a[1::2]
    rng = np.random.default_rng(3)
    va = rng.standard_normal(n).astype(np.float32)
    vb = np.where(b != KI, rng.standard_normal(n), 0).astype(np.float32)
    lists = [torch.from_numpy(t).to(cuda) for t in (a, va, b, vb)]
    counts = [torch.tensor(c, dtype=torch.int32, device=cuda)
              for c in (n, n // 2)]
    for cap in (n, n - 100):
        _same_compact(tbm.merge_compact_pair(*lists, cap=cap, n_a=counts[0],
                                           n_b=counts[1]),
                    tbm.merge_compact_pair_plain(*lists, cap=cap))


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
    assert counts["sccp_multiply"] > 0
    # a 'sort' structure aligns grouped by row of C; the 'stream' loop's
    # one-slab steps keep the flat kernel
    grouped = backend == "sort"
    assert (counts["align_product_keys"] > 0) == grouped
    assert (counts["align_keys"] > 0) != grouped
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
    """Integer-valued operands: bit-identical to the plain twin, whose
    atomics on the card sum in any order. Ragged n, n_rows and d (d % 4 !=
    0 takes the scalar gather), one-tile and multi-tile transposes, idx −1
    lanes, and ``hot`` of the lanes on row 0 (many sources on one output
    row); the grids one call launches."""
    rng = np.random.default_rng(n + d)
    a_val = _ints(rng, (k, n))
    a_idx = rng.integers(-1, n_rows, (k, n)).astype(np.int32)
    a_idx[rng.random((k, n)) < hot] = 0
    x = _ints(rng, (n, d))
    args = [torch.from_numpy(t).to(cuda) for t in (a_val, a_idx, x)]
    before = tes.ell_spmm.launches
    got = tes.ell_spmm(*args, n_rows)
    torch.cuda.synchronize()
    assert tes.ell_spmm.launches == before + tes.grids(k, n, n_rows, d)
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
    with pytest.raises(TypeError):                  # mixed value dtypes
        tes.ell_spmm(a_val, a_idx, x.bfloat16(), 100)
    y = tes.ell_spmm(a_val.bfloat16(), a_idx, x.bfloat16(), 100)
    assert y.dtype == torch.bfloat16 and y.shape == (100, 256)
    with pytest.raises(ValueError):
        tes.ell_spmm(a_val.T.contiguous().T, a_idx, x, 100)


@pytest.mark.parametrize("k,n,n_rows,d,hot", [
    (6, 777, 100, 256, 0.0), (6, 4096, 30720, 128, 0.0),
    (1, 30720, 4096, 64, 0.0), (4, 513, 129, 36, 0.9),
    (3, 5000, 70000, 8, 0.0)])
def test_ell_spmm_kernel_float_deterministic(cuda, k, n, n_rows, d, hot):
    """Float operands: two calls give the same bits; each row's terms are
    summed in lane order by rounded products and adds, the plain twin's
    order on the CPU, so the kernel equals the twin on CPU tensors bit for
    bit; the twin on the card sums with atomics in another order, so they
    agree within float32 summation order: for a row of m terms, each sum's
    error is at most (m - 1)·2⁻²⁴·Σ|v·x| (m = 1: exact), so the two differ
    by at most twice that (the hot row sums ~1,850 terms)."""
    rng = np.random.default_rng(k + n + d)
    a_val = rng.standard_normal((k, n)).astype(np.float32)
    a_idx = rng.integers(-1, n_rows, (k, n)).astype(np.int32)
    a_idx[rng.random((k, n)) < hot] = 0
    x = rng.standard_normal((n, d)).astype(np.float32)
    cpu = [torch.from_numpy(t) for t in (a_val, a_idx, x)]
    args = [t.to(cuda) for t in cpu]
    first = tes.ell_spmm(*args, n_rows)
    second = tes.ell_spmm(*args, n_rows)
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    assert torch.equal(first.cpu(), tes.ell_spmm_plain(*cpu, n_rows))
    mag = tes.ell_spmm_plain(args[0].abs(), args[1], args[2].abs(), n_rows)
    ok = (args[1] >= 0) & (args[1] < n_rows)
    terms = torch.bincount(args[1][ok].long(), minlength=n_rows)
    tol = 2 * (terms - 1).clamp(min=0)[:, None] * 2.0 ** -24 * mag
    assert bool(((first - tes.ell_spmm_plain(*args, n_rows)).abs()
                 <= tol).all())


@pytest.mark.parametrize("t,d_in,d_out,nm", [
    (1, 4, 1, (1, 4)), (130, 64, 131, (2, 4)), (257, 96, 300, (1, 4)),
    (129, 128, 129, (2, 8)), (200, 256, 257, (4, 8)), (64, 1032, 96, (2, 4)),
    (128, 66, 128, (3, 6)), (200, 222, 200, (3, 6))])
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



@pytest.mark.parametrize("t,d_in,d_out,nm", [
    (512, 2048, 640, (2, 4)), (300, 1032, 257, (4, 8)),
    (256, 600, 128, (3, 6))])
def test_nm_spmm_kernel_normal_operands(cuda, t, d_in, d_out, nm):
    """Normal operands: against the float64 product, the kernel's
    max abs error is at most 4x that of the plain fp32 twin (TF32 off)."""
    n, m = nm
    rng = np.random.default_rng(t + d_in)
    w = rng.standard_normal((d_in, d_out)).astype(np.float32)
    x = rng.standard_normal((t, d_in)).astype(np.float32)
    wp = rt.models.magnitude_prune_nm(torch.from_numpy(w), n, m)
    w_nm = rt.nm_from_dense(wp.to(cuda), n, m)
    xd = torch.from_numpy(x).to(cuda)
    want = torch.from_numpy(x).double() @ wp.double()
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        plain = tnm.nm_spmm_plain(xd, w_nm.val, w_nm.off, n=n, m=m)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    got = tnm.nm_spmm(xd, w_nm.val, w_nm.off, n=n, m=m)
    err = float((got.cpu().double() - want).abs().max())
    err_plain = float((plain.cpu().double() - want).abs().max())
    assert 0 < err <= 4 * err_plain


def test_nm_spmm_kernel_duplicate_offsets(cuda):
    """Condensed rows of one window that share an offset add, as the masked
    products add them (integer values: exact in any order); offsets out of
    range add nothing."""
    rng = np.random.default_rng(7)
    n, m, d_in, d_out, t = 2, 4, 136, 150, 70
    r = d_in * n // m
    x = torch.from_numpy(_ints(rng, (t, d_in))).to(cuda)
    val = torch.from_numpy(_ints(rng, (r, d_out))).to(cuda)
    off = rng.integers(0, m, (r, d_out)).astype(np.int8)
    off[1::2] = off[0::2]                       # every window doubles up
    off[0, :5] = [-1, 4, 7, -128, 127]
    off = torch.from_numpy(off).to(cuda)
    got = tnm.nm_spmm(x, val, off, n=n, m=m)
    assert torch.equal(got, tnm.nm_spmm_plain(x, val, off, n=n, m=m))


def test_nm_spmm_one_tf32_probe(cuda):
    """The probe build (one TF32 product in place of the FP64 one) counts
    no launch, and equals K10 on integer operands, which TF32 holds
    exactly."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(_ints(rng, (130, 64))).to(cuda)
    val = torch.from_numpy(_ints(rng, (32, 131))).to(cuda)
    off = torch.from_numpy(rng.integers(0, 4, (32, 131))
                           .astype(np.int8)).to(cuda)
    before = tnm.nm_spmm.launches
    got = tnm.launch("nm_spmm_one_tf32", x, val, off, n=2, m=4)
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
    """dispatch='spmm' calls K9 twice a call (dispatch and combine, each
    its transpose, row bounds and gather grids) and agrees with the same
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
    t = x.shape[0] * x.shape[1]            # one group of every token
    slots = cfg.moe.n_experts * rt.models.ffn.moe_capacity(t, cfg)
    assert kernels.launch_counts()["ell_spmm"] == (      # dispatch, combine
        tes.grids(cfg.moe.top_k, t, slots, d) + tes.grids(1, slots, t, d))
    y_c, aux_c = rt.moe_apply(params_from_numpy(p, device="cpu",
                                                dtype=torch.float32),
                              torch.from_numpy(x), cfg, torch.float32)
    torch.testing.assert_close(y.cpu(), y_c, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), aux_c, rtol=1e-5, atol=1e-5)


def _bf16_tol(val, idx, x, n_rows):
    """The kernel's bfloat16 result may differ from the float32 sum of the
    same bfloat16 operands by one rounding to bfloat16 (≤ 2⁻⁸·|y|) plus
    float32 summation order: (m - 1)·2⁻²⁴·Σ|v·x| for a row of m terms,
    twice over (the card twin's atomics sum in another order)."""
    mag = tes.ell_spmm_plain(val.float().abs(), idx, x.float().abs(), n_rows)
    ok = (idx >= 0) & (idx < n_rows)
    terms = torch.bincount(idx[ok].long(), minlength=n_rows)
    return 2 * (terms - 1).clamp(min=0)[:, None] * 2.0 ** -24 * mag


@pytest.mark.parametrize("t,d", [(512, 2048), (4096, 2048), (8, 2048),
                                 (300, 2047), (64, 36)])
def test_ell_spmm_kernel_bf16_moe_shapes(cuda, t, d):
    """K9's bfloat16 entry at the MoE dispatch ((6, T) planes of value 1
    into 64·cap slots) and combine ((1, 64·cap) planes of routing weights
    back into T tokens) shapes of deepseek-v2-lite, d = 2048 and d that is
    not a multiple of 8 (the scalar path): dispatch bit for bit against the
    plain twin (every slot row holds at most one lane of value 1), combine
    within one bfloat16 rounding of the float32 sum; the grids counted."""
    from repro_torch.configs import deepseek_v2_lite
    from repro_torch.models import ffn
    cfg = deepseek_v2_lite.CONFIG
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    g = torch.Generator(device=cuda).manual_seed(t + d)
    logits = torch.randn((1, t, e), generator=g, device=cuda)
    w, _, _, kept, slot = ffn._spmm_route(logits, cfg)
    n_slots = e * ffn.moe_capacity(t, cfg)
    disp = ffn.dispatch_planes(kept[0], slot[0], n_slots, torch.bfloat16)
    comb = ffn.combine_planes(kept[0], slot[0], w[0], n_slots,
                              torch.bfloat16)
    for a, n_rows, rows_in in ((disp, n_slots, t), (comb, t, n_slots)):
        x = torch.randn((rows_in, d), generator=g, device=cuda) \
            .to(torch.bfloat16)
        before = tes.ell_spmm.launches
        got = tes.ell_spmm(a.val, a.idx, x, n_rows)
        torch.cuda.synchronize()
        assert tes.ell_spmm.launches - before == tes.grids(*a.val.shape,
                                                           n_rows, d)
        assert got.dtype == torch.bfloat16 and got.shape == (n_rows, d)
        assert torch.equal(got, tes.ell_spmm(a.val, a.idx, x, n_rows))
        want = tes.ell_spmm_plain(a.val, a.idx, x, n_rows)
        if a is disp:
            assert torch.equal(got, want)
        f32 = tes.ell_spmm_plain(a.val.float(), a.idx, x.float(), n_rows)
        tol = 2.0 ** -8 * f32.abs() + _bf16_tol(a.val, a.idx, x, n_rows)
        assert bool(((got.float() - f32).abs() <= tol).all())
        # on the CPU the twin sums in lane order too: the same bits
        cpu = tes.ell_spmm_plain(a.val.cpu(), a.idx.cpu(), x.cpu(), n_rows)
        assert torch.equal(got.cpu(), cpu)


# ---------------------------------------------------------------------------
# Backend selection and the obs layer on the card
# ---------------------------------------------------------------------------

# the kernels each accumulator's cold path launches on CUDA operands
BACKEND_KERNELS = {
    "sort": ("sccp_multiply",),
    "search": ("sccp_multiply", "emit_sort", "align_product_keys"),
    "tiled": ("sccp_multiply", "sort_tiles", "merge_runs"),
    "bucket": ("sccp_multiply", "bin_ranks", "sort_tiles"),
    "hash": ("sccp_multiply", "sort_tiles"),
    "stream": ("fused_slab_sort", "merge_runs"),
}


def _mid_operands(cuda, n=3000, density=0.004, seed=8):
    """A with integer values (every float32 sum exact), times Aᵀ."""
    rng = np.random.default_rng(seed)
    a = ((rng.random((n, n)) < density)
         * rng.integers(-4, 5, (n, n))).astype(np.float32)
    k = int((a != 0).sum(0).max())
    return (rt.ell_rows_from_dense(a, k, device=cuda),
            rt.ell_cols_from_dense(a.T.copy(), k, device=cuda))


def test_auto_equals_sort_and_runs_its_backend(cuda):
    a, b = _mid_operands(cuda)
    plan = rt.make_plan(a, b)
    assert plan.backend in BACKEND_KERNELS and plan.stats is not None
    kernels.reset_launch_counts()
    got = rt.spgemm(a, b, accumulator="auto", check=True)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for kname in BACKEND_KERNELS[plan.backend]:
        assert counts[kname] > 0, (plan.backend, kname)
    want = rt.spgemm(a, b, check=True)
    for f in ("row", "col", "val", "ngroups"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_autotune_runs_each_candidates_kernels(cuda):
    a, b = _mid_operands(cuda)
    cache = rt.StructureCache(autotune=True, probe_iters=2)
    kernels.reset_launch_counts()
    st = cache.get(a, b)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert set(st.plan.est["autotune_us"]) == set(BACKEND_KERNELS)
    assert cache.stats()["autotuned"] == 1
    for bk, knames in BACKEND_KERNELS.items():
        for kname in knames:
            assert counts[kname] > 0, (bk, kname)
    want = rt.spgemm(a, b, check=True)
    got = rt.spgemm(a, b, structure=st, check=True)
    for f in ("row", "col", "val", "ngroups"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_sync_waits_once_for_a_cuda_tensor(cuda, monkeypatch):
    from repro_torch import obs
    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: (calls.append(a), real(*a))[1])
    x = torch.ones(8, device=cuda)
    obs.disable()
    assert obs.sync(x) is x and calls == []
    obs.enable(reset=True)
    try:
        assert obs.sync((x, [x], {"k": x}, torch.ones(2))) is not None
    finally:
        obs.disable()
        obs.reset()
    assert len(calls) == 1 and calls[0][0] == x.device


def test_reference_bw_under_the_hbm_peak(cuda):
    from repro_torch.obs.roofline import measure_reference_bw
    bw = measure_reference_bw(device=cuda)
    assert 1e11 < bw < 3.35e12
    # with no device the anchor measures the card, not the host
    assert 1e11 < measure_reference_bw() < 3.35e12


# ---------------------------------------------------------------------------
# The dense converters, the hybrid format and the serving lane
# ---------------------------------------------------------------------------

def _skewed_ints(seed, n, density=0.05, n_hot=3, hot=0.9):
    """Integer values in [-4, 4] \\ {0}, a few near-dense rows and columns
    (what the hybrid width rule exists for)."""
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < density).astype(np.float32)
    h = rng.choice(n, n_hot, replace=False)
    a[h] = rng.random((n_hot, n)) < hot
    a[:, h] = rng.random((n, n_hot)) < hot
    sign = rng.choice(np.array([-1, 1], np.float32), (n, n))
    return a * sign * rng.integers(1, 5, (n, n)).astype(np.float32)


def _hybrid_widths(a, b):
    from repro_torch.core import hybrid as th
    return (th.ell_width_rule((a != 0).sum(0)),
            th.ell_width_rule((b != 0).sum(1)),
            int(max((a != 0).sum(), (b != 0).sum())))


def _coo_fields(coo):
    return [coo.row, coo.col, coo.val, coo.ngroups]


@pytest.mark.parametrize("n,k", [(48, 5), (300, 12), (1000, 40)])
def test_dense_converters_on_card(cuda, n, k):
    """ELLPACK both ways and COO from a dense operand on the card equal the
    same calls on the CPU, truncation and padding included."""
    a = _skewed_ints(n, n)
    for fn, arg in ((rt.ell_rows_from_dense, k), (rt.ell_cols_from_dense, k),
                    (rt.coo_from_dense, int((a != 0).sum()) + 7),
                    (rt.coo_from_dense, int((a != 0).sum()) // 2)):
        got, want = fn(a, arg, device=cuda), fn(a, arg, device="cpu")
        fields = (_coo_fields if isinstance(got, rt.Coo)
                  else lambda e: [e.val, e.idx])
        for g, w in zip(fields(got), fields(want)):
            assert g.is_cuda and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n", [64, 700])
def test_hybrid_on_card(cuda, n):
    """Both splits and ``hybrid_spgemm_dense`` on the card equal the CPU's,
    bit for bit on integer values, and the product runs K1 once; the COO
    term in several chunks equals one chunk."""
    from repro_torch.core import hybrid as th
    a, b = _skewed_ints(n, n), _skewed_ints(n + 1, n)
    k_a, k_b, cap = _hybrid_widths(a, b)
    splits = {dev: (th.split_rows_hybrid(a, k_a, cap, device=dev),
                    th.split_cols_hybrid(b, k_b, cap, device=dev))
              for dev in (cuda, "cpu")}
    for got, want in zip(splits[cuda], splits["cpu"]):
        for g, w in zip([got.ell.val, got.ell.idx, *_coo_fields(got.coo)],
                        [want.ell.val, want.ell.idx, *_coo_fields(want.coo)]):
            assert g.is_cuda and torch.equal(g.cpu(), w)
        assert int(got.coo.ngroups) > 0
    ha, hb = splits[cuda]
    assert torch.equal(ha.to_dense().cpu(), torch.from_numpy(a))
    before = tsm.sccp_multiply.launches
    got = th.hybrid_spgemm_dense(ha, hb)
    torch.cuda.synchronize()
    assert tsm.sccp_multiply.launches == before + 1
    assert torch.equal(got.cpu(), th.hybrid_spgemm_dense(*splits["cpu"]))
    assert torch.equal(got.cpu(), torch.from_numpy(a @ b))
    for left, coo, other in ((True, ha.coo, hb.to_dense()),
                             (False, hb.coo, ha.ell.to_dense())):
        one = th._coo_matmul_dense(coo, other, left)
        assert torch.equal(th._coo_matmul_dense(coo, other, left, chunk=5),
                           one)


def _serve_requests(n_req, n=400, k=12, seed=30):
    """Integer operand pairs at one ELLPACK width: three patterns (A, and A
    less 2% and 4% of its non-zeros), fresh values a request."""
    rng = np.random.default_rng(seed)
    base = (rng.random((n, n)) < 0.015).astype(np.float32)
    base[np.arange(n), np.arange(n)] = 1          # no empty column
    pats = [base]
    for frac in (0.02, 0.04):
        p = base.copy()
        r, c = np.nonzero(p)
        drop = rng.choice(r.size, int(frac * r.size), replace=False)
        p[r[drop], c[drop]] = 0
        pats.append(p)
    k = max(k, int(base.sum(0).max()))
    out = []
    for i in range(n_req):
        x = pats[i % 3] * rng.integers(1, 5, (n, n)) \
            * rng.choice(np.array([-1, 1]), (n, n))
        out.append((x.astype(np.float32), k))
    return out


def _serve(reqs, device, max_batch=4, **flush_kw):
    from repro_torch.serve import ServeConfig, ServingEngine
    eng = ServingEngine(None, None, ServeConfig(max_batch=max_batch))
    rids = [eng.submit_spgemm(rt.ell_rows_from_dense(x, k, device=device),
                              rt.ell_cols_from_dense(x.T.copy(), k,
                                                     device=device))
            for x, k in reqs]
    return eng, rids, eng.flush_spgemm(**flush_kw)


@pytest.mark.parametrize("n_req,flush_kw", [(7, {}), (1, {}),
                                            (1, dict(backend="stream")),
                                            (3, dict(backend="stream"))])
def test_serving_lane_on_card(cuda, n_req, flush_kw):
    """The engine's SpGEMM lane on the card equals the same requests on the
    CPU: every result (its first ngroups entries), the counters and the
    cache's hits and misses. Waves run K1 and K3: grouped by row of C,
    but for a singleton on a 'stream' structure (by slab groups, flat)."""
    reqs = _serve_requests(n_req)
    kernels.reset_launch_counts()
    eng, rids, got = _serve(reqs, cuda, **flush_kw)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    ceng, _, want = _serve(reqs, "cpu", **flush_kw)
    for rid in rids:
        n = int(want[rid].ngroups)
        assert int(got[rid].ngroups) == n and got[rid].cap == want[rid].cap
        for f in ("row", "col", "val"):
            assert torch.equal(getattr(got[rid], f)[:n].cpu(),
                               getattr(want[rid], f)[:n]), (rid, f)
    for key in ("spgemm_requests", "spgemm_waves", "spgemm_batched_waves",
                "spgemm_occupancy_sum"):
        assert eng.stats[key] == ceng.stats[key], key
    for key in ("hits", "misses"):
        assert eng.cache_stats()[key] == ceng.cache_stats()[key], key
    assert counts["sccp_multiply"] > 0
    x, k = reqs[0]
    a, b = (rt.ell_rows_from_dense(x, k, device=cuda),
            rt.ell_cols_from_dense(x.T.copy(), k, device=cuda))
    backend = eng.structure_cache.get(a, b).plan.backend
    assert backend == flush_kw.get("backend", backend)
    stream_single = n_req == 1 and backend == "stream"
    assert (counts["align_keys"] > 0) == stream_single
    assert (counts["align_product_keys"] > 0) != stream_single
    one = eng.spgemm(a, b)
    n = int(one.ngroups)
    for f in ("row", "col", "val"):
        assert torch.equal(getattr(one, f)[:n], getattr(got[rids[0]], f)[:n])


def _dist_operands(n_dev):
    rng = np.random.default_rng(40 + n_dev)
    a = ((rng.random((90, 70)) < 0.12)
         * rng.integers(-4, 5, (90, 70))).astype(np.float32)
    b = ((rng.random((70, 80)) < 0.15)
         * rng.integers(-4, 5, (70, 80))).astype(np.float32)
    ka = max(1, int((a != 0).sum(0).max()))
    kb = max(1, int((b != 0).sum(1).max()))
    return [(rt.ell_rows_from_dense(a, ka, device=dev),
             rt.ell_cols_from_dense(b, kb, device=dev))
            for dev in ("cuda", "cpu")]


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("schedule", ["ring", "cstat", "summa"])
def test_sharded_schedules_on_card(cuda, schedule, n_dev):
    """Each schedule on a mesh of ``n_dev`` shards of ``cuda:0``, cold with
    the card's plan (overlap on and off) and warm on a structure, equals
    the same call on a CPU mesh bit for bit; K1 runs once a (step,
    shard)."""
    from repro_torch.parallel import make_mesh
    (ca, cb), (ha, hb) = _dist_operands(n_dev)
    on_card = make_mesh((n_dev,), ("x",), devices=[cuda] * n_dev)
    on_cpu = make_mesh((n_dev,), ("x",), devices=["cpu"] * n_dev)
    dp = rt.make_dist_plan(ca, cb, n_dev=n_dev, schedule=schedule)
    steps = dp.pr if schedule == "summa" else n_dev
    for overlap in (True, False):
        kernels.reset_launch_counts()
        got = rt.spgemm(ca, cb, mesh=on_card, axis="x", dist_plan=dp,
                        overlap=overlap, check=True)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["sccp_multiply"] == steps * n_dev
        want = rt.spgemm(ha, hb, mesh=on_cpu, axis="x", dist_plan=dp,
                         overlap=overlap, check=True)
        for f in ("row", "col", "val", "ngroups"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
        single = rt.spgemm(ha, hb, check=True)
        for f in ("row", "col", "val", "ngroups"):
            assert torch.equal(getattr(want, f), getattr(single, f)), f
    st = rt.make_structure(ca, cb, n_dev=n_dev)
    if schedule == "cstat":
        with pytest.raises(ValueError, match="cstat"):
            rt.spgemm(ca, cb, mesh=on_card, axis="x", structure=st,
                      schedule=schedule)
        return
    kernels.reset_launch_counts()
    got = rt.spgemm(ca, cb, mesh=on_card, axis="x", structure=st,
                    schedule=schedule, check=True)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["sccp_multiply"] == steps * n_dev
    assert counts["align_product_keys"] > 0
    want = rt.spgemm(ha, hb, mesh=on_cpu, axis="x",
                     structure=rt.make_structure(ha, hb), schedule=schedule,
                     check=True)
    for f in ("row", "col", "val", "ngroups"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


def test_rotated_panels_never_share_storage(cuda):
    """A rotation between shards of one card writes fresh buffers, on the
    current stream and on the side streams alike."""
    from repro_torch.parallel import mesh as tmesh
    shards = [torch.arange(4096, dtype=torch.float32, device=cuda) + d
              for d in range(4)]
    perm = tmesh.ring_perm(4)
    for got in (tmesh.ppermute(shards, perm),
                tmesh.ppermute_start(shards, perm).wait()):
        src = {s.untyped_storage().data_ptr() for s in shards}
        dst = {g.untyped_storage().data_ptr() for g in got}
        assert not src & dst and len(dst) == 4
        for d in range(4):
            assert torch.equal(got[d], shards[(d - 1) % 4])
        got[0].zero_()
        assert torch.equal(shards[3], torch.arange(4096, dtype=torch.float32,
                                                   device=cuda) + 3)


# ---------------------------------------------------------------------------
# The LM stack on the card
# ---------------------------------------------------------------------------

def _full_width_moe_block(cuda, dtype, dispatch="sort"):
    """deepseek-v2-lite's MoE block (MLA + 64 experts top-6 + 2 shared) at
    its published widths, weights drawn on the card from a seeded
    generator."""
    import dataclasses
    from repro_torch.configs import deepseek_v2_lite
    from repro_torch.models import params as tparams
    from repro_torch.models import transformer as ttr
    base = deepseek_v2_lite.CONFIG
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, dispatch=dispatch))
    g = torch.Generator(device=cuda).manual_seed(11)
    p = tparams.init_params(ttr.block_specs(cfg, "mla_moe"), g, dtype)
    return cfg, p


def test_lm_full_width_block_card_vs_cpu(cuda):
    """One full-width mla_moe block ('sort' dispatch) in float32 with TF32
    off: on the card against the same weights and tokens on the CPU,
    expert ids equal and the output within 1e-3·max|y|."""
    from repro_torch.models import ffn
    from repro_torch.models import transformer as ttr
    from repro_torch.models.params import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, p = _full_width_moe_block(cuda, torch.float32)
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn((1, 64, cfg.d_model), generator=g, device=cuda) * 0.1
    with torch.inference_mode():
        y, aux, _ = ttr.block_apply_full(p, x, cfg, "mla_moe", torch.float32,
                                         False)
        p_cpu = tree_map(lambda t: t.cpu(), p)
        y_c, aux_c, _ = ttr.block_apply_full(p_cpu, x.cpu(), cfg, "mla_moe",
                                             torch.float32, False)
    assert y.is_cuda and bool(torch.isfinite(y).all())
    assert float((y.cpu() - y_c).abs().max()) \
        <= 1e-3 * float(y_c.abs().max())
    assert abs(float(aux) - float(aux_c)) <= 1e-4 * abs(float(aux_c))
    h = torch.randn((1, 64, cfg.d_model), generator=g, device=cuda)
    ids = ffn._topk_routing(h @ p["ffn"]["router"], cfg.moe.top_k)[1]
    ids_c = ffn._topk_routing(h.cpu() @ p_cpu["ffn"]["router"],
                              cfg.moe.top_k)[1]
    assert torch.equal(ids.cpu(), ids_c)


def test_lm_moe_dispatches_agree_full_width(cuda, monkeypatch):
    """The 'spmm' (K9's bfloat16 entry), 'sort' and 'ellpack' MoE layers
    agree on one full-width layer in bfloat16, on 8 × 64 tokens
    (capacity 60) and on the decode's 8 × 1 (capacity 1, most pairs
    dropped), within 2e-2·max|y| (each rounds its expert and combine
    products to bfloat16 at other points). y is the routed experts' sum:
    the shared experts, one code path in all three, outweigh it many-fold
    at this init and would hide a dispatch fault. 'spmm' with its first
    kept pair dropped must fall outside the limit."""
    import dataclasses
    from repro_torch.models import ffn
    cfg, p = _full_width_moe_block(cuda, torch.bfloat16, "sort")
    p = {k: v for k, v in p["ffn"].items() if k != "shared"}
    g = torch.Generator(device=cuda).manual_seed(13)

    def apply(x, dispatch):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch, n_shared=0))
        kernels.reset_launch_counts()
        y = ffn.moe_apply(p, x, c, torch.bfloat16)[0]
        torch.cuda.synchronize()
        assert (kernels.launch_counts()["ell_spmm"] > 0) == \
            (dispatch == "spmm")
        assert y.dtype == torch.bfloat16
        return y.float()

    route = ffn._spmm_route

    def drop_first(logits, c):
        w, ids, onehot, kept, slot = route(logits, c)
        kept = kept.clone()
        kept.view(-1)[int(kept.reshape(-1).nonzero()[0])] = False
        return w, ids, onehot, kept, slot

    for t, cap in ((64, 60), (1, 1)):
        assert ffn.moe_capacity(8 * t, cfg) == cap
        x = torch.randn((8, t, cfg.d_model), generator=g, device=cuda) \
            .to(torch.bfloat16)
        with torch.inference_mode():
            ys = {d: apply(x, d) for d in ("sort", "spmm", "ellpack")}
            with monkeypatch.context() as m:
                m.setattr(ffn, "_spmm_route", drop_first)
                dropped = apply(x, "spmm")
        scale = float(ys["sort"].abs().max())
        for dispatch in ("spmm", "ellpack"):
            err = float((ys[dispatch] - ys["sort"]).abs().max())
            assert err <= 2e-2 * scale, (t, dispatch, err, scale)
        err = float((dropped - ys["sort"]).abs().max())
        assert err > 2e-2 * scale, (t, "a dropped pair", err, scale)


# ---------------------------------------------------------------------------
# Training: K9 under autograd, K10 in bfloat16, one train step, and a mesh
# of more than one axis
# ---------------------------------------------------------------------------

BF16_ROUND = 2.0 ** -8     # one rounding to bfloat16, relative


@pytest.mark.parametrize("k,n,n_rows,d", [(6, 4096, 480, 128),
                                          (8, 777, 100, 64),
                                          (1, 4000, 1024, 96)])
def test_ell_spmm_backward_on_card(cuda, k, n, n_rows, d):
    """``ops.ell_spmm`` on CUDA tensors that require grad: the forward is
    K9 (its grids counted), and dX and dval equal the plain twin's own
    autograd gradients on the card bit for bit on integer operands with
    dead lanes. In bfloat16 they come back bfloat16, each within one
    bfloat16 rounding (BF16_ROUND·|g|) of the float32 gradients of the
    widened operands."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(k * n + d)
    idx = rng.integers(0, n_rows, (k, n)).astype(np.int32)
    idx[rng.random((k, n)) < 0.3] = -1
    ti = torch.from_numpy(idx).to(cuda)
    val = torch.from_numpy(_ints(rng, (k, n))).to(cuda)
    x = torch.from_numpy(_ints(rng, (n, d))).to(cuda)
    dy = torch.from_numpy(_ints(rng, (n_rows, d))).to(cuda)
    grads = {}
    for route in ("kernel", "plain"):
        v = val.clone().requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        before = tes.ell_spmm.launches
        y = ops.ell_spmm(v, ti, xx, n_rows) if route == "kernel" \
            else tes.ell_spmm_plain(v, ti, xx, n_rows)
        torch.cuda.synchronize()
        assert (tes.ell_spmm.launches > before) == (route == "kernel")
        grads[route] = torch.autograd.grad(y, (v, xx), dy)
    for g, w in zip(grads["kernel"], grads["plain"]):
        assert torch.equal(g, w)
    fv = (val * torch.rand(val.shape, device=cuda)).bfloat16()
    fx = (x * torch.rand(x.shape, device=cuda)).bfloat16()
    bdy = (dy * torch.rand(dy.shape, device=cuda)).bfloat16()
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        v = fv.to(dt).requires_grad_(True)
        xx = fx.to(dt).requires_grad_(True)
        out[dt] = torch.autograd.grad(ops.ell_spmm(v, ti, xx, n_rows),
                                      (v, xx), bdy.to(dt))
    for g, w in zip(out[torch.bfloat16], out[torch.float32]):
        assert g.dtype == torch.bfloat16
        assert bool(((g.float() - w).abs() <= BF16_ROUND * w.abs()).all())


@pytest.mark.parametrize("t,d_in,d_out,nm", [(130, 64, 131, (2, 4)),
                                             (200, 256, 257, (4, 8)),
                                             (512, 2048, 1024, (2, 4))])
def test_nm_spmm_kernel_bf16(cuda, t, d_in, d_out, nm):
    """K10's bfloat16 entry: one launch, bfloat16 out, within one bfloat16
    rounding of K10's float32 result on the widened operands
    (max|y − y32| ≤ BF16_ROUND·max|y32|), and equal to the plain twin on
    small-integer operands (exact sums below 256); mixed dtypes raise."""
    n, m = nm
    g = torch.Generator(device=cuda).manual_seed(t + d_in)
    x = torch.randn((t, d_in), generator=g, device=cuda).bfloat16()
    w = torch.randn((d_in, d_out), generator=g, device=cuda)
    w_nm = rt.nm_from_dense(rt.magnitude_prune_nm(w, n, m), n, m)
    val = w_nm.val.bfloat16()
    before = tnm.nm_spmm.launches
    y = tnm.nm_spmm(x, val, w_nm.off, n=n, m=m)
    torch.cuda.synchronize()
    assert tnm.nm_spmm.launches == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (t, d_out)
    y32 = tnm.nm_spmm(x.float(), val.float(), w_nm.off, n=n, m=m)
    assert float((y.float() - y32).abs().max()) \
        <= BF16_ROUND * float(y32.abs().max())
    rng = np.random.default_rng(t)
    xi = torch.from_numpy(rng.integers(-1, 2, (t, d_in)).astype(np.float32)
                          ).to(cuda).bfloat16()
    vi = torch.from_numpy(rng.integers(-1, 2, tuple(val.shape))
                          .astype(np.float32)).to(cuda).bfloat16()
    assert torch.equal(tnm.nm_spmm(xi, vi, w_nm.off, n=n, m=m),
                       tnm.nm_spmm_plain(xi, vi, w_nm.off, n=n, m=m))
    with pytest.raises(TypeError):
        tnm.nm_spmm(x, val.float(), w_nm.off, n=n, m=m)
    with pytest.raises(TypeError):
        tnm.nm_spmm(x.half(), val.half(), w_nm.off, n=n, m=m)


@pytest.mark.parametrize("dispatch", ["sort", "spmm"])
def test_train_step_card_vs_cpu(cuda, dispatch):
    """granite-moe-3b cut to one layer at its published widths, float32
    with TF32 off, on 2 x 32 tokens, from the same weights on the card and
    on the CPU: the loss within 1e-5 relative and every leaf's grad within
    1e-3·max|g_cpu|; then one train step on each, whose loss and grad norm
    agree the same way and whose parameters stay finite; 'spmm' launches
    K9 (forward), 'sort' does not."""
    import dataclasses
    from repro_torch.configs import granite_moe_3b
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, adamw_init
    torch.backends.cuda.matmul.allow_tf32 = False
    base = granite_moe_3b.CONFIG
    cfg = dataclasses.replace(base, n_layers=1, param_dtype="float32",
                              compute_dtype="float32",
                              moe=dataclasses.replace(base.moe,
                                                      dispatch=dispatch))
    model = rt.build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(3))
    p_cpu = tree_map(lambda a: a.cpu(), params)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32))
    res = {}
    for where, p, t in (("card", params, toks.to(cuda)),
                        ("cpu", p_cpu, toks)):
        leaves = tree_leaves(p)
        for a in leaves:
            a.requires_grad_(True)
        kernels.reset_launch_counts()
        loss = model.loss(p, {"tokens": t})
        grads = torch.autograd.grad(loss, leaves)
        if where == "card":
            torch.cuda.synchronize()
            assert (kernels.launch_counts()["ell_spmm"] > 0) == \
                (dispatch == "spmm")
        res[where] = (float(loss), [g.cpu() for g in grads])
    assert abs(res["card"][0] - res["cpu"][0]) <= 1e-5 * abs(res["cpu"][0])
    for got, want in zip(res["card"][1], res["cpu"][1]):
        assert float((got - want).abs().max()) \
            <= 1e-3 * float(want.abs().max())
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1))
    m_card = step(params, adamw_init(params), {"tokens": toks.to(cuda)})[2]
    m_cpu = step(p_cpu, adamw_init(p_cpu), {"tokens": toks})[2]
    for k, tol in (("loss", 1e-5), ("grad_norm", 1e-4)):
        assert abs(float(m_card[k]) - float(m_cpu[k])) \
            <= tol * abs(float(m_cpu[k]))
    assert all(bool(torch.isfinite(a).all()) for a in tree_leaves(params))


@pytest.mark.parametrize("axis", ["x", "y"])
def test_two_axis_mesh_on_card(cuda, axis):
    """The sharded SpGEMM on a (2, 2) mesh of repeated ``cuda:0`` over
    either axis equals the single-device call bit for bit, for each
    schedule."""
    from repro_torch.parallel import make_mesh
    (ca, cb), (ha, hb) = _dist_operands(2)
    mesh = make_mesh((2, 2), ("x", "y"), devices=[cuda] * 4)
    assert mesh.axis_devices(axis) == [torch.device(cuda)] * 2
    single = rt.spgemm(ha, hb, check=True)
    for schedule in ("ring", "cstat", "summa"):
        got = rt.spgemm(ca, cb, mesh=mesh, axis=axis, schedule=schedule,
                        check=True)
        for f in ("row", "col", "val", "ngroups"):
            assert torch.equal(getattr(got, f).cpu(), getattr(single, f)), f


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b",
                                  "whisper-medium"])
def test_lm_family_card_vs_cpu(cuda, arch):
    """The reduced config of each recurrent or encoder-decoder family, in
    float32 with TF32 off, from the same weights on the card and on the
    CPU: the loss on 2 x 64 tokens within 1e-5 relative, and a prefill of
    32 tokens (two SSM chunks, past the local window) then four decode
    steps, each step's logits and the final cache within 1e-4·max|·|."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import tree_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    model = rt.build_model(get_config(arch + "-smoke"))
    cfg = model.cfg
    params = model.init(torch.Generator(device=cuda).manual_seed(5), cuda)
    p_cpu = tree_map(lambda a: a.cpu(), params)
    rng = np.random.default_rng(6)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    res = {}
    for where, p in (("card", params), ("cpu", p_cpu)):
        dev = cuda if where == "card" else torch.device("cpu")
        b = {k: v.to(dev) for k, v in batch.items()}
        with torch.inference_mode():
            loss = float(model.loss(p, b))
            pre = dict(b, tokens=b["tokens"][:, :32])
            logits, cache = model.prefill(p, pre, 40)
            steps = [logits.cpu()]
            for t in range(32, 36):
                logits, cache = model.decode_step(p, cache,
                                                  b["tokens"][:, t:t + 1])
                steps.append(logits.cpu())
        res[where] = (loss, steps, [c.cpu() for c in
                                    tree_leaves(cache["layers"])])
    (lc, sc, cc), (lh, sh, ch) = res["card"], res["cpu"]
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    for got, want in zip(sc + cc, sh + ch):
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        assert float((got.float() - want.float()).abs().max()) \
            <= 1e-4 * float(want.float().abs().max())
