"""The kernels' plain torch versions against the JAX reference on the CPU:
SCCP multiply against ``repro.core.sccp`` and the Pallas kernel in
interpret mode, the in-situ-search primitives (emission, alignment, minima
scan) against ``repro.kernels.insitu_search``, and the bitonic row sort,
merge-tree level and bucket rank against ``repro.kernels.bitonic_merge`` /
``radix_bucket`` (Pallas in interpret mode and the XLA realizations), bit
for bit, truncation and KEY_INVALID lanes included. The CUDA kernels themselves are
held against these plain versions by ``test_torch_cuda.py`` on a GPU; the
host arithmetic of their radix sort (geometry, digit shifts, pass order, and
the offsets its grids compute, emulated in torch) is tested here."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import ell_cols_from_dense, ell_rows_from_dense
from repro.core.formats import EllCols, EllRows
from repro.core.sccp import sccp_multiply as ref_sccp
from repro.kernels import bitonic_merge as ref_bm
from repro.kernels import insitu_search as ref_is
from repro.kernels import radix_bucket as ref_rb
from repro.kernels.ops import sccp_multiply as ref_sccp_tiled
from repro.kernels.sccp_multiply import sccp_multiply_pallas
from repro_torch.kernels import bitonic_merge as tbm
from repro_torch.kernels import insitu_search as tis
from repro_torch.kernels import radix_bucket as trb
from repro_torch.kernels import radix_sort as trs
from repro_torch.kernels import sccp_multiply as tsm

KI = tis.KEY_INVALID
assert KI == int(ref_is.KEY_INVALID)


def _eq(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, np.asarray(want))


def _planes(seed, m, n, p, density):
    rng = np.random.default_rng(seed)
    a = ((rng.random((m, n)) < density)
         * rng.standard_normal((m, n))).astype(np.float32)
    b = ((rng.random((n, p)) < density)
         * rng.standard_normal((n, p))).astype(np.float32)
    ka = max(1, int((a != 0).sum(0).max()))
    kb = max(1, int((b != 0).sum(1).max()))
    ea = ell_rows_from_dense(jnp.array(a), ka)
    eb = ell_cols_from_dense(jnp.array(b), kb)
    return [np.asarray(x) for x in (ea.val, ea.idx, eb.val, eb.idx)]


@pytest.mark.parametrize("m,n,p,density", [(24, 40, 56, 0.2),
                                           (16, 57, 9, 0.5),
                                           (40, 128, 32, 0.1),
                                           (8, 256, 8, 0.3)])
def test_sccp_multiply_plain_matches_reference(m, n, p, density):
    planes = _planes(m * n, m, n, p, density)
    got = tsm.sccp_multiply(*(torch.from_numpy(x) for x in planes))
    a_val, a_idx, b_val, b_idx = planes
    ea = EllRows(val=jnp.asarray(a_val), idx=jnp.asarray(a_idx), n_rows=m)
    eb = EllCols(val=jnp.asarray(b_val), idx=jnp.asarray(b_idx), n_cols=p)
    for g, w in zip(got, ref_sccp(ea, eb)):
        _eq(g, w)
    # the Pallas kernel itself, interpreted (ragged n padded by ops)
    tiled = (sccp_multiply_pallas(*map(jnp.asarray, planes), block_n=128,
                                  interpret=True) if n % 128 == 0 else
             ref_sccp_tiled(*map(jnp.asarray, planes)))
    for g, w in zip(got, tiled):
        _eq(g, w)
    assert tsm.sccp_multiply.launches == 0          # plain twin on the CPU


def _stream(seed, n, hi, n_valid):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, hi, n).astype(np.int32)
    key[n_valid:] = KI                              # stream padding lanes
    return key


STREAMS = [(256, 96, 200, 128), (256, 96, 200, 40),   # untruncated, truncated
           (1024, 1 << 20, 1000, 256), (512, 4096, 512, 64),
           (64, 8, 0, 16),                            # all lanes dead
           (128, 8, 100, 512),        # cap far above the unique count
           (256, 1, 200, 8),          # every valid key the same
           (1, 1 << 20, 1, 4)]        # one key


@pytest.mark.parametrize("n,hi,n_valid,cap", STREAMS)
@pytest.mark.parametrize("faithful", [False, True])
def test_emit_sorted_unique_matches_reference(n, hi, n_valid, cap, faithful):
    key = _stream(n + hi, n, hi, n_valid)
    uk, nnz = tis.emit_sorted_unique(torch.from_numpy(key), cap,
                                     faithful=faithful)
    ruk, rnnz = ref_is.emit_sorted_unique(jnp.asarray(key), cap,
                                          interpret=True, faithful=faithful)
    _eq(uk, ruk)
    assert uk.dtype == torch.int32 and int(nnz) == int(rnnz)
    n_uniq = len(np.unique(key[:n_valid]))
    assert int(nnz) == (n_uniq if not faithful or n_uniq <= cap
                        else cap + 1)


@pytest.mark.parametrize("n,tile", [(1024, 256), (4096, 4096)])
def test_emit_sort_plain_matches_pallas_network(n, tile):
    key = _stream(tile, n, 1 << 30, n - 100)
    got = tis.emit_sort_keys(torch.from_numpy(key))
    _eq(got, ref_is._emit_sort_keys_pallas(jnp.asarray(key), tile=tile,
                                           interpret=True))
    uk, nnz = tis._unique_heads(got, 512)
    ruk, rnnz = ref_is._unique_heads(jnp.sort(jnp.asarray(key)), 512)
    _eq(uk, ruk)
    assert int(nnz) == int(rnnz)


@pytest.mark.parametrize("u,pad", [(512, 100), (512, 0), (300, 0), (1, 1)])
def test_align_keys_matches_reference(u, pad):
    """slot = #{uk < pk}, hit = pk ∈ uk — dead KEY_INVALID lanes included:
    they hit exactly when uk has padding."""
    rng = np.random.default_rng(u + pad)
    uk = np.sort(rng.choice(1 << 20, u - pad, replace=False)).astype(np.int32)
    uk = np.concatenate([uk, np.full(pad, KI, np.int32)])
    pk = np.concatenate([rng.integers(0, 1 << 20, 700).astype(np.int32),
                         rng.choice(uk[: u - pad], 300) if u > pad else
                         np.zeros(0, np.int32),
                         np.full(24, KI, np.int32)]).astype(np.int32)
    slot, hit = tis.align_keys(torch.from_numpy(pk), torch.from_numpy(uk))
    rslot, rhit = ref_is.align_keys_xla(jnp.asarray(pk), jnp.asarray(uk))
    _eq(slot, rslot)
    _eq(hit, rhit)
    assert slot.dtype == torch.int32 and hit.dtype == torch.bool
    assert bool(hit[-1]) == (pad > 0)
    if u % 512 == 0 or pad:          # the Pallas kernel pads uk otherwise
        islot, ihit = ref_is.align_keys(jnp.asarray(pk), jnp.asarray(uk),
                                        interpret=True)
        _eq(slot, islot)
        _eq(hit, ihit)


# The grouped design of K3 (csrc/insitu_search.cu align_product_keys),
# emulated on the CPU lane by lane: the groups sorted stably by row (the CSR
# transpose), the row bounds of uk, the row blocks (each row's first
# ``row_lanes`` lanes, then the lanes past them in runs of ``row_lanes`` of
# all the rows' lanes) reading their row's segment of uk into a bitmap of
# its columns with popcount prefixes (or, for wide rows and equal keys,
# searching it in place), and the loose lanes (keys outside their block's
# row, groups outside [0, n_rows), the padding) searching their own key's
# segment. Every read of uk goes through a guard that fails outside the
# segment the design allows, and every lane must be written exactly once.
# The kernels themselves run only on the card (tests/test_torch_cuda.py).

class _Segment:
    """uk[lo, hi); reading any other lane is a fault of the design."""

    def __init__(self, uk, lo, hi):
        self.uk, self.lo, self.hi = uk, lo, hi

    def __getitem__(self, p):
        assert 0 <= p < self.hi - self.lo, (p, self.lo, self.hi)
        return int(self.uk[self.lo + p])


def _lower_bound(seg, n, x):
    lo, hi = 0, n
    while lo < hi:
        mid = (lo + hi) // 2
        if seg[mid] < x:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _row_bitmap(seg, n, key_lo, n_cols):
    """A row block's bitmap of its segment's columns and each word's
    exclusive popcount prefix; None where two keys are equal (they would
    share a bit)."""
    bits = np.zeros(-(-n_cols // 32), np.uint64)
    for i in range(n):
        c = seg[i] - key_lo
        assert 0 <= c < n_cols, c
        if i > 0 and seg[i - 1] >= seg[i]:
            return None
        bits[c >> 5] |= np.uint64(1 << (c & 31))
    pops = np.array([bin(int(w)).count("1") for w in bits], np.int64)
    return bits, np.concatenate([[0], np.cumsum(pops)[:-1]])


def _row_runs(rowptr, n_rows, k_b, groups, row_lanes):
    """The row kernel's blocks as (row, j_lo, j_hi) runs, block by block:
    block r < n_rows takes row r's lanes [0, row_lanes); block n_rows + e
    the lanes at or past ``row_lanes`` of the rows at the two ends of the e-th
    ``row_lanes`` of the rows' lanes in sorted order (the kernel's
    ``row_of``, a binary search of ``rowptr``)."""
    def row_of(g):
        lo, hi = 0, n_rows
        while lo < hi:
            mid = (lo + hi) // 2
            if rowptr[mid + 1] <= g:
                lo = mid + 1
            else:
                hi = mid
        return lo

    blocks = [[(r, 0, min((rowptr[r + 1] - rowptr[r]) * k_b, row_lanes))]
              for r in range(n_rows)]
    end = rowptr[n_rows] * k_b
    for e in range(-(-groups * k_b // row_lanes)):
        p0, runs = e * row_lanes, []
        if p0 < end:
            p1 = min(p0 + row_lanes, end)
            for r in sorted({row_of(p0 // k_b), row_of((p1 - 1) // k_b)}):
                base, lanes = rowptr[r] * k_b, (rowptr[r + 1] - rowptr[r]) * k_b
                runs.append((r, max(p0 - base, row_lanes), min(p1 - base,
                                                                lanes)))
        blocks.append(runs)
    return [[run for run in b if run[1] < run[2]] for b in blocks]


def _emulate_align_grouped(pk, uk, group_row, k_b, n_rows, n_cols,
                           bitmap_cols, row_lanes):
    """(slot, hit) as the grouped design computes them: a row's segment as
    a bitmap where ``n_cols <= bitmap_cols``, else (or with equal keys)
    searched in place; the row blocks of ``_row_runs``, each taking at most
    ``row_lanes`` lanes and reading its row's segment again."""
    n, u, groups = pk.size, uk.size, group_row.size
    if k_b == 0:
        groups = 0
    row_key = np.where((group_row >= 0) & (group_row < n_rows), group_row,
                       n_rows)[:groups]
    ids = np.argsort(row_key, kind="stable")
    rowptr = [int(x) for x in
              np.searchsorted(row_key[ids], np.arange(n_rows + 1))]
    whole = _Segment(uk, 0, u)
    bnd = [_lower_bound(whole, u, r * n_cols) for r in range(n_rows + 1)]
    slot, hit = np.full(n, -1, np.int64), np.full(n, -1, np.int8)

    def put(lane, lo, p, seg, ln, x):
        assert slot[lane] == -1, lane                 # written once
        slot[lane] = lo + p
        hit[lane] = p < ln and seg[p] == x

    def loose(lane):
        x = int(pk[lane])
        if x < 0:
            lo, hi = 0, bnd[0]
        elif x >= n_rows * n_cols:
            lo, hi = bnd[n_rows], u
        else:
            lo, hi = bnd[x // n_cols], bnd[x // n_cols + 1]
        seg = _Segment(uk, lo, hi)
        put(lane, lo, _lower_bound(seg, hi - lo, x), seg, hi - lo, x)

    blocks = _row_runs(rowptr, n_rows, k_b, groups, row_lanes) \
        if n_rows else []
    for runs in blocks:
        assert sum(j_hi - j_lo for _, j_lo, j_hi in runs) <= row_lanes
        for r, j_lo, j_hi in runs:
            g0 = rowptr[r]
            lo, hi = bnd[r], bnd[r + 1]
            seg = _Segment(uk, lo, hi)
            bitmap = _row_bitmap(seg, hi - lo, r * n_cols, n_cols) \
                if n_cols <= bitmap_cols else None
            for j in range(j_lo, j_hi):
                lane = int(ids[g0 + j // k_b]) * k_b + j % k_b
                x = int(pk[lane])
                if not r * n_cols <= x < (r + 1) * n_cols:
                    loose(lane)
                elif bitmap is not None:
                    c = x - r * n_cols
                    w = int(bitmap[0][c >> 5])
                    assert slot[lane] == -1, lane
                    slot[lane] = lo + bitmap[1][c >> 5] + bin(
                        w & ((1 << (c & 31)) - 1)).count("1")
                    hit[lane] = (w >> (c & 31)) & 1
                else:
                    put(lane, lo, _lower_bound(seg, hi - lo, x), seg,
                        hi - lo, x)
    for pos in range(rowptr[n_rows] if n_rows else 0, groups):
        for t in range(k_b):
            loose(int(ids[pos]) * k_b + t)
    for lane in range(groups * k_b, n):
        loose(lane)
    assert (slot >= 0).all() and (hit >= 0).all()      # every lane written
    return slot.astype(np.int32), hit.astype(bool)


def _product_stream(rng, k_a, n, k_b, n_rows, n_cols, *, dead_as=KI,
                    pad=True, dead=0.3, heavy=0.0):
    """K3's operands as the main path forms them: packed keys of SCCP's
    (k_a, n, k_b) lanes, dead lanes (in A and in B, B's valid slots first)
    packed as ``dead_as`` (KEY_INVALID cold, 0 warm), padded with
    KEY_INVALID to a power of two where ``pad``; each group's row as
    ``ops.align_products`` takes it (−1 where its first B slot is dead).
    A share ``heavy`` of A's slots fall in rows 0 and 1 (skewed rows)."""
    a_idx = np.where(rng.random((k_a, n)) < 1 - dead,
                     rng.integers(0, max(n_rows, 1), (k_a, n)), -1)
    a_idx = np.where((a_idx >= 0) & (rng.random((k_a, n)) < heavy),
                     a_idx % 2, a_idx)
    nb = rng.binomial(k_b, 1 - dead, n)
    b_idx = np.where(np.arange(k_b)[None, :] < nb[:, None],
                     rng.integers(0, max(n_cols, 1), (n, k_b)), -1)
    row = np.broadcast_to(a_idx[:, :, None], (k_a, n, k_b))
    col = np.broadcast_to(b_idx[None, :, :], (k_a, n, k_b))
    ok = (row >= 0) & (col >= 0)
    pk = np.where(ok, row * n_cols + col, dead_as).reshape(-1)
    if pad:
        pot = 1 << max(0, pk.size - 1).bit_length()
        pk = np.concatenate([pk, np.full(pot - pk.size, KI)])
    group_row = np.where(b_idx[None, :, 0] >= 0, a_idx, -1)
    return pk.astype(np.int32), group_row.astype(np.int32)


ALIGN_CASES = {
    # name: (k_a, n, k_b, n_rows, n_cols, bitmap_cols, row_lanes, stream
    #        kwargs, uk kind)
    "search": (4, 60, 6, 50, 70, 1 << 17, 1 << 16, {}, "exact"),
    "numeric": (4, 60, 6, 50, 70, 1 << 17, 1 << 16, dict(dead_as=0, pad=False),
                "padded"),
    "empty_rows": (2, 20, 5, 300, 300, 1 << 17, 1 << 16, {}, "exact"),
    "searched_rows": (4, 60, 6, 50, 70, 0, 1 << 16, dict(dead_as=0, pad=False),
                      "padded"),
    "long_rows": (6, 80, 6, 3, 400, 0, 64, {}, "padded"),
    "equal_keys": (4, 60, 6, 20, 70, 1 << 17, 1 << 16, {}, "equal"),
    "stale": (5, 50, 7, 40, 45, 1 << 17, 1 << 16, dict(dead_as=0, pad=False),
              "stale"),
    "no_unique": (3, 16, 4, 8, 8, 1 << 17, 1 << 16, dict(dead=1.0), "padded"),
    "empty_uk": (3, 16, 4, 8, 8, 1 << 17, 1 << 16, dict(dead_as=0, pad=False),
                 "empty"),
    "wrong_rows": (4, 60, 6, 50, 70, 1 << 17, 1 << 16, {}, "wrong"),
    "no_groups": (0, 0, 4, 8, 8, 1 << 17, 1 << 16, dict(pad=False), "padded"),
    "few_rows": (6, 80, 6, 3, 90, 1 << 17, 16, dict(dead_as=0, pad=False),
                 "padded"),
    "skewed_rows": (6, 80, 6, 40, 90, 1 << 17, 24,
                    dict(dead_as=0, pad=False, heavy=0.5), "padded"),
}


@pytest.mark.parametrize("case", sorted(ALIGN_CASES))
def test_align_grouped_design_matches_reference(case):
    """Emulated, the grouped K3 design gives the flat answer bit for bit:
    ``align_keys_plain`` and ``align_product_keys``'s CPU route, the
    reference's XLA ``align_keys_xla`` and, where it pads ``uk`` alike, its
    Pallas ``align_keys`` in interpret mode. Cases: dead lanes in A and in
    B packed as KEY_INVALID or 0, the power-of-two padding, empty rows of
    C, rows searched in place rather than ranked in a bitmap (short rows,
    and long rows cut into several blocks), equal keys in ``uk`` (which a
    bitmap cannot rank, so the row is searched), rows cut into several
    blocks' runs (few rows; and two heavy rows among light ones, each block
    at most ``row_lanes`` lanes), a stale ``uk`` that misses keys
    and holds keys no product has, no unique key (``uk`` all padding),
    group rows drawn at random (wrong and out of range) and no groups at
    all; and ``u = 0``, which the reference's realizations do not take
    (they index ``uk``), against the plain twin alone."""
    k_a, n, k_b, n_rows, n_cols, bitmap_cols, row_lanes, skw, kind = \
        ALIGN_CASES[case]
    rng = np.random.default_rng(len(case) + k_a * n)
    pk, group_row = _product_stream(rng, k_a, n, k_b, n_rows, n_cols, **skw)
    if pk.size == 0:
        pk = np.full(8, KI, np.int32)                # padding lanes only
    uk = np.unique(pk[(pk != KI) & (pk != 0)]) if kind != "empty" \
        else np.zeros(0, np.int32)
    if kind == "stale":
        uk = np.unique(np.concatenate([uk[rng.random(uk.size) > 0.2],
                                       rng.integers(0, n_rows * n_cols, 9)]))
    if kind == "equal":
        uk = np.sort(np.concatenate([uk, uk[::7]]))
    if kind in ("padded", "stale"):
        uk = np.concatenate([uk, np.full(5, KI)])
    if kind == "wrong":
        group_row = rng.integers(-3, n_rows + 3, group_row.shape)
    uk, group_row = uk.astype(np.int32), group_row.astype(np.int32)
    got = _emulate_align_grouped(pk, uk, group_row.reshape(-1), k_b, n_rows,
                                 n_cols, bitmap_cols, row_lanes)
    if case in ("long_rows", "few_rows", "skewed_rows"):   # rows are cut
        lanes = np.bincount(group_row[group_row >= 0], minlength=n_rows) * k_b
        assert lanes.max() > 2 * row_lanes
    tpk, tuk = torch.from_numpy(pk), torch.from_numpy(uk)
    wants = [tis.align_keys_plain(tpk, tuk),
             tis.align_product_keys(tpk, tuk, torch.from_numpy(group_row),
                                    k_b=k_b, n_rows=n_rows, n_cols=n_cols)]
    if uk.size:
        wants.append(ref_is.align_keys_xla(jnp.asarray(pk), jnp.asarray(uk)))
    for want in wants:
        _eq(got[0], want[0])
        _eq(got[1], want[1])
    if uk.size and (uk.size % 512 == 0 or uk[-1] == KI):
        want = ref_is.align_keys(jnp.asarray(pk), jnp.asarray(uk),
                                 interpret=True)
        _eq(got[0], want[0])
        _eq(got[1], want[1])
    assert tis.align_product_keys.launches == 0      # plain twin on the CPU


@pytest.mark.parametrize("rows,k_b,row_lanes", [
    ([5, 0, 3, 200, 1, 0, 90], 3, 16), ([0, 0], 4, 8), ([1000], 1, 64),
    ([7] * 40, 2, 16), ([3, 500, 3, 500, 3], 5, 100)])
def test_align_row_runs_follow_each_rows_lanes(rows, k_b, row_lanes):
    """The row kernel's blocks take every lane of every row exactly once,
    at most ``row_lanes`` a block, and a row's blocks follow its own lane
    count: at least ceil(lanes / row_lanes) and at most two more, whatever
    the other rows hold."""
    rowptr = np.concatenate([[0], np.cumsum(rows)]).tolist()
    blocks = _row_runs(rowptr, len(rows), k_b, rowptr[-1], row_lanes)
    taken = [np.zeros(g * k_b, int) for g in rows]
    per_row = np.zeros(len(rows), int)
    for runs in blocks:
        assert sum(hi - lo for _, lo, hi in runs) <= row_lanes
        for r, lo, hi in runs:
            taken[r][lo:hi] += 1
            per_row[r] += 1
    assert all((t == 1).all() for t in taken)
    for r, g in enumerate(rows):
        need = -(-g * k_b // row_lanes)
        assert need <= per_row[r] <= need + 2, (r, per_row[r], need)


def test_align_products_routes_long_streams_to_flat(monkeypatch):
    """``ops.align_products`` sends a product stream to the grouped entry
    while its keys and unique keys number under 2³¹ and its row grid (a
    block a row of C, one for each 65,536 keys) under 2³¹ blocks, and to the
    flat ``align_keys`` past either (the grouped kernel's lanes are 32-bit),
    as it does a stream without SCCP's row plane. Meta tensors: no memory."""
    from repro_torch.kernels import ops
    calls = []
    for name in ("align_keys", "align_product_keys"):
        monkeypatch.setattr(tis, name, lambda *a, _n=name, **kw: (
            calls.append(_n), None)[1])
    row = torch.empty((1, 4, 8), dtype=torch.int64, device="meta")
    for n, u, n_rows, want in (
            (2 ** 31 - 1, 5, 8, "align_product_keys"),
            (2 ** 31, 5, 8, "align_keys"),
            (64, 2 ** 31, 8, "align_keys"),
            (64, 2 ** 31 - 1, 8, "align_product_keys"),
            (2 ** 17, 5, 2 ** 31 - 2, "align_keys"),    # 2 ** 31 blocks
            (64, 5, 2 ** 31 - 2 ** 20, "align_product_keys")):
        calls.clear()
        key = torch.empty(n, dtype=torch.int32, device="meta")
        uk = torch.empty(u, dtype=torch.int32, device="meta")
        ops.align_products(key, uk, row, n_rows, 1)
        assert calls == [want], (n, u, n_rows, calls)
    assert tis.grouped_fits(2 ** 31 - 1, 2 ** 31 - 1, 2 ** 31 - 2 ** 15 - 1)
    assert not tis.grouped_fits(2 ** 31 - 1, 5, 2 ** 31 - 2 ** 15)
    calls.clear()
    ops.align_products(key, uk, row.reshape(-1), 8, 8)
    assert calls == ["align_keys"]


@pytest.mark.parametrize("n,groups,k_b,n_rows,grids", [
    (0, 10, 4, 8, 0), (64, 0, 4, 8, 4), (64, 16, 0, 8, 4),
    (64, 16, 4, 8, 5), (1 << 20, 4096, 72, 300, 5),
    (1 << 28, 72 * 45000, 72, 45000, 6 + 4),
    (3240000, 45000, 72, 45000, 6 + 4), (1 << 12, 5000, 8, 100, 3 + 4),
    (64, 16, 4, 0, 4)])
def test_align_grouped_grids_and_scratch(n, groups, k_b, n_rows, grids):
    """The grids a grouped K3 call launches (the transpose's sort, none
    without groups, one grid up to a tile and three a digit above; its row
    bounds; uk's row bounds; the row blocks, none without rows; the loose
    lanes) and its scratch (the transpose's, then n_rows + 1 bounds)."""
    assert tis.align_grids(n, groups, k_b, n_rows) == grids
    s = groups if groups <= 4096 else -(-groups // 4096) * 4096
    assert tis.align_scratch_ints(groups, n_rows) == \
        4 * s + (s // 4096 + 1) * 256 + 2 * (n_rows + 1)


@pytest.mark.parametrize("case", ["square", "skewed"])
def test_grouped_align_front_door_matches_reference(case, monkeypatch):
    """The cold 'search' call and the warm call on a 'sort' structure go
    through ``align_product_keys`` (its CPU route) and give the
    reference's ``Coo`` bit for bit on integer operands; the warm
    'stream' structure's one-slab loop keeps the flat ``align_keys``."""
    import repro_torch as rt
    from repro.core import spgemm_coo
    from repro.core.spgemm import spgemm_coo_numeric as ref_numeric
    from repro.plan import make_structure as ref_make_structure
    from repro.plan import symbolic as ref_sym
    from repro_torch.core import spgemm as tsp
    from test_torch_spgemm import ZOO, _pair, _same_coo
    a, b, k = ZOO[case]
    (ea, eb), (ta, tb) = _pair(a, b, k)
    calls = []
    for mod, name in ((tis, "align_product_keys"), (tis, "align_keys"),
                      (tsp, "align_keys")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *x, _f=fn, _n=name, **kw: (
            calls.append(_n), _f(*x, **kw))[1])
    cap = ref_sym.out_cap_auto(ea, eb, exact=True)
    _same_coo(rt.spgemm(ta, tb, accumulator="search", check=True),
              spgemm_coo(ea, eb, out_cap=cap, accumulator="search"))
    assert calls == ["align_product_keys"]
    for backend, want in (("sort", "align_product_keys"),
                          ("stream", "align_keys")):
        calls.clear()
        st = rt.make_structure(ta, tb, backend=backend)
        warm = rt.spgemm(ta, tb, structure=st, check=True)
        _same_coo(warm, ref_numeric(ea, eb, ref_make_structure(
            ea, eb, backend=backend)))
        assert calls and set(calls) == {want}, calls


@pytest.mark.parametrize("case", ["random", "ties", "dead_lanes", "all_dead"])
def test_minima_mask_matches_bit_serial_reference(case):
    rng = np.random.default_rng(7)
    v = rng.integers(0, 1 << 30, 512).astype(np.int32)
    if case == "ties":
        v = rng.integers(0, 4, 512).astype(np.int32)
    if case == "dead_lanes":
        v[:400] = KI
    if case == "all_dead":
        v[:] = KI
    got = tis.minima_mask(torch.from_numpy(v))
    _eq(got, ref_is.minima_mask_pallas(jnp.asarray(v), interpret=True))
    _eq(got, ref_is.minima_mask_xla(jnp.asarray(v)))
    assert tis.minima_mask.launches == 0


def test_search_emit_sorted_matches_reference():
    v = np.random.default_rng(8).integers(0, 40, 128).astype(np.int32)
    v[100:] = KI
    vals, counts = tis.search_emit_sorted(torch.from_numpy(v), 48)
    rvals, rcounts = ref_is.search_emit_sorted(jnp.asarray(v), 48,
                                               interpret=True)
    _eq(vals, rvals)
    _eq(counts, rcounts)


@pytest.mark.parametrize("n,hi,n_valid,cap", STREAMS)
def test_faithful_emission_edges_match_reference(n, hi, n_valid, cap):
    """``search_emit_sorted`` and ``faithful_emit_plain`` (the emission
    entry's plain version) against the reference's iterated Alg. 1 in
    interpret mode: values, counts (0 in padding) and nnz, on streams where
    the cap is far above the unique count, every lane is dead, the stream
    is truncated, the keys all tie, or there is one key."""
    key = _stream(n + hi, n, hi, n_valid)
    vals, counts = tis.search_emit_sorted(torch.from_numpy(key), cap)
    rvals, rcounts = ref_is.search_emit_sorted(jnp.asarray(key), cap,
                                               interpret=True)
    _eq(vals, rvals)
    _eq(counts, rcounts)
    pv, pc, pnnz = tis.faithful_emit_plain(torch.from_numpy(key), cap)
    _eq(pv, rvals)
    _eq(pc, rcounts)
    _, rnnz = ref_is.emit_sorted_unique(jnp.asarray(key), cap,
                                        interpret=True, faithful=True)
    assert int(pnnz) == int(rnnz)
    assert tis.minima_mask.launches == 0


def _emulate_minima(v, warps_per_block, keys=16):
    """The mask entry's design on a numpy stream: blocks of
    ``warps_per_block`` warps holding ``keys`` keys a thread (lanes
    base + j*threads + t), each thread folding its keys, each warp and then
    the block reducing to the survivors' value, and the mask from the
    blocks' values folded again (the two-grid form when there are
    several)."""
    threads = 32 * warps_per_block
    chunk = threads * keys
    n = v.size
    blocks = max(1, -(-n // chunk))
    part = []
    for b in range(blocks):
        lanes = b * chunk + np.arange(keys)[:, None] * threads \
            + np.arange(threads)[None, :]
        k = np.where(lanes < n, v[np.minimum(lanes, max(n - 1, 0))], KI) \
            if n else np.full(lanes.shape, KI)
        thread = k.min(0)
        warp = thread.reshape(warps_per_block, 32).min(1)
        part.append(warp.min())
    m = min(part)
    return (v == m) & (m != KI)


@pytest.mark.parametrize("n,hi,dead,warps", [
    (1, 8, 0.0, 1), (700, 4, 0.3, 2), (2048, 1 << 30, 0.1, 4),
    (2049, 100, 0.5, 4), (5000, 1 << 20, 1.0, 2)])
def test_minima_mask_design(n, hi, dead, warps):
    """The register-tiled split (thread, warp, block, blocks) selects the
    rows of the bit-serial reference, ties and dead lanes included."""
    rng = np.random.default_rng(n)
    v = rng.integers(0, hi, n).astype(np.int32)
    v[rng.random(n) < dead] = KI
    _eq(_emulate_minima(v, warps),
        ref_is.minima_mask_pallas(jnp.asarray(v), interpret=True))


def _emulate_emit(v, out_cap, warps, keys=16):
    """The emission entry's design on a numpy stream: each warp's least
    active key (``wv``), an emission's minimum over the warps' values, only
    the warps that held it consuming its rows and rescanning, the loop
    stopping at the first KEY_INVALID; counts and nnz as the kernel writes
    them."""
    threads = 32 * warps
    lanes = np.arange(keys)[:, None] * threads + np.arange(threads)[None, :]
    k = np.where(lanes < v.size, v[np.minimum(lanes, v.size - 1)], KI)
    by_warp = [k[:, w * 32:(w + 1) * 32].copy() for w in range(warps)]
    wv = [blk.min() for blk in by_warp]
    vals = np.full(out_cap, KI, np.int32)
    counts = np.zeros(out_cap, np.int32)
    e = 0
    while e < out_cap:
        m = min(wv)
        if m == KI:
            break
        vals[e] = m
        for w, blk in enumerate(by_warp):
            if wv[w] == m:
                counts[e] += int((blk == m).sum())
                blk[blk == m] = KI
                wv[w] = blk.min()
        e += 1
    return vals, counts, e + int(min(wv) != KI)


@pytest.mark.parametrize("n,hi,n_valid,cap", STREAMS)
@pytest.mark.parametrize("warps", [1, 3])
def test_faithful_emit_design(n, hi, n_valid, cap, warps):
    """The one-launch emission's loop (warp values, rescans by the warps
    that held the minimum, the early stop, counts and nnz) gives the
    reference's iterated Alg. 1, on streams of one or several warps."""
    key = _stream(n + hi, n, hi, n_valid)
    vals, counts, nnz = _emulate_emit(key, cap, max(warps, -(-n // 512)))
    rvals, rcounts = ref_is.search_emit_sorted(jnp.asarray(key), cap,
                                               interpret=True)
    _eq(vals, rvals)
    _eq(counts, rcounts)
    _, rnnz = ref_is.emit_sorted_unique(jnp.asarray(key), cap,
                                        interpret=True, faithful=True)
    assert nnz == int(rnnz)


# ---------------------------------------------------------------------------
# K5 / K6 / K7: the bitonic row sort, the merge-tree level, the bucket rank
# ---------------------------------------------------------------------------

def _pairs(seed, n, hi, dead=0.1):
    """Packed keys drawn from a small range (duplicates straddle every tile
    edge), integer values, KEY_INVALID dead lanes carrying 0."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, hi, n).astype(np.int32)
    val = rng.integers(-4, 5, n).astype(np.float32)
    dead = rng.random(n) < dead
    key[dead], val[dead] = KI, 0
    return key, val


@pytest.mark.parametrize("n,tile,hi", [(256, 64, 40), (512, 512, 1 << 20),
                                       (1024, 128, 8)])
def test_sort_tiles_plain_matches_pallas_and_xla(n, tile, hi):
    key, val = _pairs(n + tile, n, hi)
    got = tbm.sort_tiles(torch.from_numpy(key), torch.from_numpy(val),
                         tile=tile)
    for want in (ref_bm.sort_tiles_pallas(jnp.asarray(key), jnp.asarray(val),
                                          tile=tile, interpret=True),
                 ref_bm.sort_tiles_xla(jnp.asarray(key), jnp.asarray(val),
                                       tile=tile)):
        _eq(got[0], want[0])
        _eq(got[1], want[1])
    assert tbm.sort_tiles.launches == 0              # plain twin on the CPU


def test_segmented_total_tails_are_row_local():
    """A key that ends one row and starts the next has a tail in each row."""
    key = torch.tensor([1, 2, 5, 5, 5, 5, 7, KI], dtype=torch.int32)
    val = torch.arange(1, 9, dtype=torch.float32)
    _, tot = tbm.sort_tiles(key, val, tile=4)
    _eq(tot, np.asarray([1, 2, 0, 7, 0, 11, 7, 0], np.float32))
    _eq(tot, ref_bm.sort_tiles_xla(jnp.asarray(key.numpy()),
                                   jnp.asarray(val.numpy()), tile=4)[1])


@pytest.mark.parametrize("run", [16, 128])
def test_merge_runs_plain_matches_pallas(run):
    key, val = _pairs(run, 512, 60)
    k, v = ref_bm.sort_tiles_xla(jnp.asarray(key), jnp.asarray(val), tile=run)
    got = tbm.merge_runs(torch.from_numpy(np.array(k)),
                         torch.from_numpy(np.array(v)), run=run)
    want = ref_bm.merge_runs_pallas(k, v, run=run, interpret=True)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def test_sort_merge_tree_matches_reference():
    key, val = _pairs(3, 2048, 300)
    got = tbm.sort_merge_tree(torch.from_numpy(key), torch.from_numpy(val),
                              tile=256)
    want = ref_bm.sort_merge_tree_pallas(jnp.asarray(key), jnp.asarray(val),
                                         tile=256, interpret=True)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    with pytest.raises(ValueError, match="power"):
        tbm.sort_tiles(torch.from_numpy(key), torch.from_numpy(val), tile=96)


# The merge-path design of K6 and of the stream's merge-and-compact step
# (csrc/bitonic_merge.cu), emulated on the CPU lane by lane: co-ranks found
# by binary search, each window's spans read only within their one-lane
# halo, a thread's lanes merged from its own co-rank, the totals fused. It
# checks the design at small windows (every edge case in a few hundred
# lanes), not the kernels, whose grids run only on the card
# (tests/test_torch_cuda.py).

class _Span:
    """A list's lanes [lo, hi] staged for one window; reading any other
    lane is a fault of the design."""

    def __init__(self, key, val, lo, hi):
        self.key, self.val = key, val
        self.lo, self.hi = max(lo, 0), min(hi, len(key) - 1)

    def k(self, g):
        assert self.lo <= g <= self.hi, (g, self.lo, self.hi)
        return int(self.key[g])

    def v(self, g):
        assert self.lo <= g <= self.hi, (g, self.lo, self.hi)
        return self.val[g]


def _co_rank(ka, la, kb, lb, d):
    lo, hi = max(0, d - lb), min(d, la)
    while lo < hi:
        mid = (lo + hi) // 2
        if ka(mid) <= kb(d - mid - 1):
            lo = mid + 1
        else:
            hi = mid
    return lo


def _merge_lanes(a, na, a0, a1, b, nb, b0, b1, d, cnt):
    """merge_lanes of csrc/bitonic_merge.cu over the window's spans: A's
    lanes [a0, a1) of a list of na, B's [b0, b1) of nb; (key, total, tail)
    of the window's merged lanes [d, d + cnt)."""
    la, lb = a1 - a0, b1 - b0
    i = _co_rank(lambda t: a.k(a0 + t), la, lambda t: b.k(b0 + t), lb, d)
    j = d - i
    out = []
    zero = np.float32(0)
    for _ in range(cnt):
        if j >= lb or (i < la and a.k(a0 + i) <= b.k(b0 + j)):
            k = a.k(a0 + i)
            tail = (k != KI and (a0 + i + 1 >= na or a.k(a0 + i + 1) != k)
                    and not (b0 + j < nb and b.k(b0 + j) == k))
            v = a.v(a0 + i) + zero if tail else zero
            i += 1
        else:
            k = b.k(b0 + j)
            tail = k != KI and (b0 + j + 1 >= nb or b.k(b0 + j + 1) != k)
            v = zero
            if tail:
                in_a = a0 + i > 0 and a.k(a0 + i - 1) == k
                v = (b.v(b0 + j) + (a.v(a0 + i - 1) if in_a else zero)) + zero
            j += 1
        out.append((k, v, tail))
    return out


def _window(ka, va, na, kb, vb, nb, d0, d1, a0, a1, items):
    """One block: both spans staged with their halo, each thread's ``items``
    lanes merged from its own co-rank."""
    a = _Span(ka, va, a0 - 1, a1)
    b = _Span(kb, vb, d0 - a0 - 1, d1 - a1)
    lanes = []
    for first in range(0, d1 - d0, items):
        lanes += _merge_lanes(a, na, a0, a1, b, nb, d0 - a0, d1 - a1, first,
                              min(items, d1 - d0 - first))
    return lanes


def _emulate_merge_runs(key, val, run, window, items):
    """K6's level: rows of at most a window merged whole (no halo bound:
    the row is staged), longer rows cut into windows by their co-ranks."""
    row = 2 * run
    out_k, out_v = [], []
    for r0 in range(0, len(key), row):
        ka, va = key[r0:r0 + run], val[r0:r0 + run]
        kb, vb = key[r0 + run:r0 + row], val[r0 + run:r0 + row]
        win = row if row <= window else window
        part = [_co_rank(lambda t: int(ka[t]), run, lambda t: int(kb[t]),
                         run, d) for d in range(0, row + 1, win)]
        for w in range(row // win):
            lanes = _window(ka, va, run, kb, vb, run, w * win, (w + 1) * win,
                            part[w], part[w + 1], items)
            out_k += [k for k, _, _ in lanes]
            out_v += [v for _, v, _ in lanes]
    return np.asarray(out_k, np.int32), np.asarray(out_v, np.float32)


def _emulate_merge_compact(ka, va, na, kb, vb, nb, cap, window, items):
    """The stream's step: windows over the na + nb valid merged lanes, each
    window's uniques counted, the counts scanned into offsets, each unique
    written at its offset below cap, then the fill."""
    live = na + nb
    n_win = -(-live // window)
    part = [_co_rank(lambda t: int(ka[t]), na, lambda t: int(kb[t]), nb,
                     min(w * window, live)) for w in range(n_win + 1)]
    key = np.full(cap, KI, np.int32)
    tot = np.zeros(cap, np.float32)
    off = 0
    for w in range(n_win):
        d0, d1 = w * window, min((w + 1) * window, live)
        for k, v, tail in _window(ka[:na], va[:na], na, kb[:nb], vb[:nb],
                                  nb, d0, d1, part[w], part[w + 1], items):
            if tail:
                if off < cap:
                    key[off], tot[off] = k, v
                off += 1
    return key, tot, min(off, cap), max(off - cap, 0)


@pytest.mark.parametrize("n,run,window,items", [
    (512, 1, 64, 4), (512, 4, 64, 16), (1024, 32, 64, 4),
    (1024, 64, 32, 4), (2048, 256, 64, 8), (1024, 512, 1024, 16)])
def test_merge_path_design_merges_like_the_reference(n, run, window, items):
    """Emulated, the merge-path level equals the plain twin and the
    reference's interpret-mode Pallas level bit for bit on coalesced runs
    (duplicates inside a run and across the pair, KEY_INVALID tails), at
    rows inside a window and rows cut into many windows."""
    key, val = _pairs(n + run, n, max(4, n // 8))
    k, v = (np.array(x) for x in ref_bm.sort_tiles_xla(
        jnp.asarray(key), jnp.asarray(val), tile=run))
    got = _emulate_merge_runs(k, v, run, window, items)
    want = tbm.merge_runs_plain(torch.from_numpy(k), torch.from_numpy(v),
                                run=run)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    ref = ref_bm.merge_runs_pallas(jnp.asarray(k), jnp.asarray(v), run=run,
                                   interpret=True)
    _eq(got[1], ref[1])


def _unique_list(rng, length, n_valid, hi):
    key = np.full(length, KI, np.int32)
    key[:n_valid] = np.sort(rng.choice(hi, n_valid, replace=False))
    val = np.zeros(length, np.float32)
    val[:n_valid] = rng.integers(-4, 5, n_valid)
    return key, val


@pytest.mark.parametrize("length,na,nb,cap,hi,window", [
    (128, 64, 40, 128, 300, 16),      # unequal valid lengths, shared keys
    (128, 0, 0, 128, 10, 16),         # both lists empty: all fill
    (128, 0, 77, 128, 400, 32),       # an empty buffer
    (256, 200, 180, 128, 260, 16),    # uniques beyond cap: drops
    (256, 256, 256, 256, 256, 64),    # every key in both lists
    (512, 300, 301, 512, 4000, 8),    # windows much smaller than the lists
])
def test_merge_compact_design_matches_plain(length, na, nb, cap, hi,
                                            window):
    """Emulated, the stream's merge-and-compact grids give the plain twin's
    buffer, count and dropped, reading no lane past either valid count."""
    rng = np.random.default_rng(length + na + nb + cap)
    ka, va = _unique_list(rng, length, na, hi)
    kb, vb = _unique_list(rng, length, nb, hi)
    got = _emulate_merge_compact(ka, va, na, kb, vb, nb, cap, window, 4)
    want = tbm.merge_compact_pair_plain(*map(torch.from_numpy,
                                             (ka, va, kb, vb)), cap=cap)
    for g, w in zip(got, want):
        _eq(np.asarray(g), w)


def test_merge_scratch_sizes():
    """The partition's int64 entries: none for rows of at most a window,
    a co-rank for every window's first lane and each row's end above."""
    assert tbm.WINDOW == 4096
    assert tbm.merge_scratch(1 << 13, 2048) == 0
    assert tbm.merge_scratch(1 << 14, 4096) == 2 * 3
    assert tbm.merge_scratch(1 << 28, 1 << 27) == (1 << 16) + 1
    assert tbm.compact_scratch(128) == 3 * 2 + 1
    assert tbm.compact_scratch(1 << 27) == 3 * ((1 << 16) + 1) + 1


@pytest.mark.parametrize("n,n_buckets", [(2048, 8), (1024, 64), (4096, 1)])
def test_bin_ranks_plain_matches_reference(n, n_buckets):
    rng = np.random.default_rng(n + n_buckets)
    bid = np.repeat(rng.integers(0, n_buckets, n // 8), 8).astype(np.int32)
    bid[rng.random(n) < 0.2] = -1                   # dead lanes rank -1
    got = trb.bin_ranks(torch.from_numpy(bid), n_buckets=n_buckets)
    _eq(got, ref_rb.bin_ranks_xla(jnp.asarray(bid), n_buckets=n_buckets))
    _eq(got, ref_rb.bin_ranks_pallas(jnp.asarray(bid), n_buckets=n_buckets,
                                     interpret=True))
    assert got.dtype == torch.int32 and trb.bin_ranks.launches == 0


def test_bin_ranks_out_of_range_ids_rank_like_the_pallas_kernel():
    bid = np.asarray(([0, 3, 1, 3, 2, 5] * 200)[:1024], np.int32)
    got = trb.bin_ranks(torch.from_numpy(bid), n_buckets=3)
    _eq(got, ref_rb.bin_ranks_pallas(jnp.asarray(bid), n_buckets=3,
                                     interpret=True))
    assert (got.numpy()[bid >= 3] == -1).all()


def _bin_operands(seed, n, n_buckets, kpb, dead, negative=0.0):
    """A packed-key stream for the binning: runs of one key range (as
    neighbouring products share a row), keys past the last bucket's span
    (the ceil split's slack), dead lanes, optionally keys below 0, and
    float values that are not integers."""
    rng = np.random.default_rng(seed)
    hi = (n_buckets + 1) * kpb
    key = np.repeat(rng.integers(0, hi, -(-n // 7)), 7)[:n]
    key = (key + rng.integers(0, 3, n)).astype(np.int32)
    key[rng.random(n) < dead] = KI
    key[rng.random(n) < negative] = -5
    val = rng.standard_normal(n).astype(np.float32)
    return key, val


# (n, n_buckets, bucket_cap, keys_per_bucket, dead, negative): drops, empty
# tails, dead lanes, ids past the last bucket, one bucket, keys below 0
BIN_CASES = [(1000, 4, 256, 300, 0.2, 0.0), (4096, 8, 64, 97, 0.3, 0.0),
             (3000, 1, 4096, 1 << 20, 0.1, 0.0), (777, 3, 128, 50, 0.0, 0.05),
             (5000, 64, 32, 13, 0.5, 0.0), (600, 5, 512, 1, 1.0, 0.0)]


@pytest.mark.parametrize("n,n_buckets,cap,kpb,dead,negative", BIN_CASES)
def test_bin_stream_plain_matches_reference(n, n_buckets, cap, kpb, dead,
                                            negative):
    """The plain binning equals, slot for slot, the layout the reference's
    own ranks (``bin_ranks_xla``) and placement rule give, and ``dropped``
    equals the reference ``bucket_merge``'s."""
    key, val = _bin_operands(n + n_buckets, n, n_buckets, kpb, dead, negative)
    bk, bv, dropped = trb.bin_stream(
        torch.from_numpy(key), torch.from_numpy(val), n_buckets=n_buckets,
        bucket_cap=cap, keys_per_bucket=kpb)
    assert trb.bin_ranks.launches == 0
    jk, jv = jnp.asarray(key), jnp.asarray(val)
    bid = jnp.minimum(jnp.where(jk != KI, jk // kpb, -1).astype(jnp.int32),
                      n_buckets - 1)
    rank = ref_rb.bin_ranks_xla(bid, n_buckets=n_buckets)
    in_cap = (rank >= 0) & (rank < cap)
    dump = n_buckets * cap
    dst = jnp.where(in_cap, bid * cap + rank, dump)
    _eq(bk, jnp.full((dump + 1,), KI, jnp.int32)
        .at[dst].set(jnp.where(in_cap, jk, KI))[:dump])
    _eq(bv, jnp.zeros((dump + 1,), jnp.float32)
        .at[dst].set(jnp.where(in_cap, jv, 0))[:dump])
    want = ref_rb.bucket_merge(jk, jv, n_buckets=n_buckets, bucket_cap=cap,
                               keys_per_bucket=kpb)[2]
    assert dropped.dtype == torch.int32 and int(dropped) == int(want)


def _emulate_bin_stream(key, val, n_buckets, cap, kpb, tile=4096, warps=8,
                        items=16):
    """``csrc/radix_bucket.cu``'s three grids lane by lane: the count grid's
    walk (warp w of a tile owns lanes w*512 .. w*512+511, item i of lane l
    is lane w*512 + i*32 + l, items in order, each warp's counters updated
    once per item by the lowest peer), the scan over tiles per column, the
    place grid's ranks and writes, and the fill blocks' tails and drop
    count. Slots no grid writes stay -7 / NaN."""
    n, nb, cols = key.size, n_buckets, n_buckets + 1
    n_tiles = max(1, -(-n // tile))
    # the bucket by a wide multiply and a shift, as KeyLanes
    shift = 31 + (kpb - 1).bit_length()
    magic = (1 << shift) // kpb + 1
    assert magic < 1 << 32

    def bucket(k):
        if k == KI:
            return -1
        if k < 0:
            return nb
        return min((magic * k) >> shift, nb - 1)

    def walk(t):
        wc = np.zeros((warps, cols), np.int64)
        out = []                                      # (lane, b, in-warp r)
        for w in range(warps):
            for i in range(items):
                lanes = t * tile + w * items * 32 + i * 32 + np.arange(32)
                b = [bucket(int(key[l])) if l < n else -1 for l in lanes]
                for j, l in enumerate(lanes):
                    if b[j] < 0:
                        continue
                    below = sum(b[m] == b[j] for m in range(j))
                    out.append((l, w, b[j], wc[w, b[j]] + below))
                for bb in set(b) - {-1}:              # the leaders' adds
                    wc[w, bb] += b.count(bb)
        return wc, out

    walks = [walk(t) for t in range(n_tiles)]
    counts = np.stack([wc.sum(0) for wc, _ in walks], axis=1)  # cols x tiles
    offs = np.cumsum(counts, axis=1) - counts
    totals = counts.sum(1)
    bk = np.full(nb * cap, -7, np.int32)
    bv = np.full(nb * cap, np.nan, np.float32)
    for t, (wc, out) in enumerate(walks):
        before = np.cumsum(wc, axis=0) - wc           # earlier warps
        for l, w, b, r in out:
            rank = offs[b, t] + before[w, b] + r
            if b < nb and rank < cap:
                assert bk[b * cap + rank] == -7      # each slot written once
                bk[b * cap + rank], bv[b * cap + rank] = key[l], val[l]
    for b in range(nb):
        tail = slice(b * cap + min(totals[b], cap), (b + 1) * cap)
        assert (bk[tail] == -7).all()
        bk[tail], bv[tail] = KI, 0.0
    dropped = sum(max(0, totals[b] - cap) for b in range(nb)) + totals[nb]
    return bk, bv, dropped


@pytest.mark.parametrize("n,n_buckets,cap,kpb,dead,negative", BIN_CASES[:4]
                         + [(9000, 2, 8192, 5000, 0.1, 0.0)])
def test_bin_stream_design_matches_plain(n, n_buckets, cap, kpb, dead,
                                         negative):
    """Emulated, the kernel's grids give the plain twin's layout and drop
    count, every slot written exactly once, with ragged last tiles and
    more than one tile."""
    key, val = _bin_operands(n + n_buckets, n, n_buckets, kpb, dead, negative)
    bk, bv, dropped = _emulate_bin_stream(key, val, n_buckets, cap, kpb)
    want = trb.bin_stream_plain(torch.from_numpy(key), torch.from_numpy(val),
                                n_buckets=n_buckets, bucket_cap=cap,
                                keys_per_bucket=kpb)
    _eq(want[0], bk)
    _eq(want[1], bv)
    assert int(want[2]) == dropped


def test_bin_stream_checks():
    key = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        trb.bin_stream(key, key.float(), n_buckets=2, bucket_cap=6,
                       keys_per_bucket=4)
    with pytest.raises(ValueError, match="int32 span"):
        trb.bin_stream(key, key.float(), n_buckets=2, bucket_cap=4,
                       keys_per_bucket=2 ** 31)
    with pytest.raises(ValueError, match="1-D shape"):
        trb.bin_stream(key, key[:4].float(), n_buckets=2, bucket_cap=4,
                       keys_per_bucket=4)
    with pytest.raises(ValueError, match="no kernel"):
        trb.bin_stream(key.to("meta"), key.float().to("meta"), n_buckets=2,
                       bucket_cap=4, keys_per_bucket=4)


# ---------------------------------------------------------------------------
# The radix sort's host arithmetic (kernels/radix_sort.py)
# ---------------------------------------------------------------------------

def test_radix_digits_and_pass_order():
    assert (trs.BITS, trs.BINS, trs.PASSES) == (8, 256, 4)
    assert trs.SHIFTS == (0, 8, 16, 24)
    order = trs.pass_buffers()
    assert order == [("in", "scratch"), ("scratch", "out"),
                     ("out", "scratch"), ("scratch", "out")]
    for passes in (2, 4, 6):
        order = trs.pass_buffers(passes)
        assert order[0][0] == "in" and order[-1][1] == "out"
        assert all(src != dst and dst != "in" for src, dst in order)
        assert all(a[1] == b[0] for a, b in zip(order, order[1:]))
    for passes in (1, 3):
        with pytest.raises(ValueError, match="even"):
            trs.pass_buffers(passes)


@pytest.mark.parametrize("n,row,tpb,bpr", [
    (1 << 28, 1 << 28, 64, 1024),     # K2 at bcsstk32's stream
    (1 << 28, 1 << 22, 64, 16),       # 'hash': 64 tables of 2^22
    (1 << 27, 1 << 21, 32, 16),       # 'bucket': 64 buckets of 2^21
    (1 << 15, 8192, 1, 2),            # rows of two tiles
    (1 << 18, 1 << 16, 1, 16),
    (3 << 24, 1 << 23, 16, 128),      # tiles a block rounded up to a power
])
def test_radix_geometry(n, row, tpb, bpr):
    g = trs.geometry(n, row)
    assert (g.tiles_per_block, g.blocks_per_row) == (tpb, bpr)
    assert g.blocks_per_row * g.tiles_per_block * trs.TILE == row
    assert g.rows == n // row
    assert g.rows * bpr <= max(trs.TARGET_BLOCKS, g.rows)
    assert g.counts == g.rows * trs.BINS * bpr      # int32 scratch entries


@pytest.mark.parametrize("n,row", [(1 << 12, 1 << 12), (1 << 14, 3 << 12),
                                   (1 << 14, 1 << 15), (1 << 12, 2048)])
def test_radix_geometry_rejects(n, row):
    with pytest.raises(ValueError, match="radix geometry"):
        trs.geometry(n, row)


@pytest.mark.parametrize("n,tpb,bpr,last", [
    (792 * 4096, 2, 396, 2),          # K8: one bcsstk32 slab x B, 3,240,000
    (1583 * 4096, 4, 396, 3),         # a group of 2 slabs, 6,480,000 lanes
    (2 * 4096, 1, 2, 1),
    (3001 * 4096, 6, 501, 1),
    (1 << 22, 2, 512, 2),
])
def test_radix_span_geometry(n, tpb, bpr, last):
    """One row of n lanes, a multiple of the tile: blocks of tpb tiles, the
    last owning the rest, and about TARGET_BLOCKS / 2 of them."""
    g = trs.span_geometry(n)
    assert (g.n, g.row, g.rows) == (n, n, 1)
    assert (g.tiles_per_block, g.blocks_per_row) == (tpb, bpr)
    tiles = n // trs.TILE
    assert tiles - (bpr - 1) * tpb == last
    assert 0 < last <= tpb and bpr <= trs.TARGET_BLOCKS // 2
    assert g.counts == trs.BINS * bpr


@pytest.mark.parametrize("n", [4096, 4096 * 3 + 1, 100, 0])
def test_radix_span_geometry_rejects(n):
    with pytest.raises(ValueError, match="radix span"):
        trs.span_geometry(n)


def _digit(key: torch.Tensor, shift: int) -> torch.Tensor:
    """The kernels' digit: bit 31 flipped, so signed keys order as int32."""
    return ((key.long() + 2 ** 31) >> shift) & (trs.BINS - 1)


def _emulate_radix(key: torch.Tensor, val: torch.Tensor, row: int):
    """The segmented design's index arithmetic: per pass the upsweep's count
    of each (row, block, bin), stored block-major as the kernels store it,
    the scan's exclusive offsets (bin-major, restarting at each row) and the
    downsweep's stable scatter through the pass order of ``pass_buffers``.
    It checks the design, not the kernels, whose grids run only on the card
    (``tests/test_torch_cuda.py``)."""
    n = key.numel()
    g = trs.geometry(n, row)
    lane = torch.arange(n)
    r = lane // row
    j = lane % row // (g.tiles_per_block * trs.TILE)
    bufs = {"in": (key, val)}
    for shift, (src, dst) in zip(trs.SHIFTS, trs.pass_buffers()):
        k, v = bufs[src]
        cell = (r * g.blocks_per_row + j) * trs.BINS + _digit(k, shift)
        counts = torch.bincount(cell, minlength=g.counts)
        bin_major = counts.view(g.rows, g.blocks_per_row, trs.BINS) \
            .transpose(1, 2).reshape(g.rows, -1)
        offs = (bin_major.cumsum(1) - bin_major).view(
            g.rows, trs.BINS, g.blocks_per_row).transpose(1, 2).reshape(-1)
        order = torch.sort(cell, stable=True).indices
        first = counts.cumsum(0) - counts
        rank = torch.empty(n, dtype=torch.long)
        rank[order] = torch.arange(n) - first[cell[order]]
        dest = r * row + offs[cell] + rank
        assert torch.equal(torch.sort(dest).values, lane)   # a permutation
        kd, vd = torch.empty_like(k), torch.empty_like(v)
        kd[dest], vd[dest] = k, v
        bufs[dst] = (kd, vd)
    return bufs["out"]


@pytest.mark.parametrize("n,row,hi", [(1 << 14, 8192, 300),
                                      (1 << 16, 1 << 15, 1 << 31),
                                      (1 << 15, 1 << 15, 8)])
def test_radix_design_sorts_rows_like_the_reference(n, row, hi):
    """Emulated on the CPU, the four passes' offsets and scatters leave
    every row sorted with ties in lane order: the reference's sort, values
    included. Keys span the whole int32 range at hi = 2^31."""
    rng = np.random.default_rng(n + row)
    key = rng.integers(-hi, hi, n, dtype=np.int64).astype(np.int32)
    key[rng.random(n) < 0.1] = KI
    val = np.arange(n, dtype=np.float32)            # tags each lane's order
    k, v = _emulate_radix(torch.from_numpy(key), torch.from_numpy(val), row)
    want = torch.sort(torch.from_numpy(key).view(-1, row), dim=1, stable=True)
    _eq(k, want.values.reshape(-1))
    _eq(v, (want.indices + torch.arange(0, n, row)[:, None]).reshape(-1)
        .to(torch.float32))
    if hi < 2 ** 31:                                 # packed-key range
        ks, _ = ref_bm.sort_tiles_xla(jnp.asarray(key), jnp.asarray(val),
                                      tile=row)
        _eq(k, ks)


@pytest.mark.parametrize("n,row,passes", [
    (1, 1, 4), (1024, 1024, 4),          # one row, its tile padded
    (4096, 4096, 4), (1 << 20, 4096, 4),  # one row a tile
    (1 << 14, 2048, 5), (3 * 256, 256, 5), (1 << 14, 16, 5),
    (1 << 14, 8, 6), (10, 2, 6), (1 << 13, 1, 6),
])
def test_radix_tile_passes(n, row, passes):
    assert trs.tile_passes(n, row) == passes


@pytest.mark.parametrize("n,row", [(1 << 13, 8192), (96, 3), (100, 8),
                                   (0, 0)])
def test_radix_tile_passes_rejects(n, row):
    with pytest.raises(ValueError, match="radix tile"):
        trs.tile_passes(n, row)


def _emulate_radix_tiles(key: torch.Tensor, val: torch.Tensor, row: int):
    """The one-grid design's passes, emulated: every tile of TILE lanes
    (the last padded with INT32_MAX) sorted stably by the four key digits,
    then by the tile-local row index over ``tile_passes`` passes, the lanes
    past the stream's end dropped. It checks the design, not the kernel,
    whose grid runs only on the card (``tests/test_torch_cuda.py``)."""
    n = key.numel()
    tiles = -(-n // trs.TILE)
    k = torch.full((tiles * trs.TILE,), 2 ** 31 - 1, dtype=torch.int32)
    k[:n] = key
    idx = torch.arange(trs.TILE).repeat(tiles)
    k, idx = k.view(tiles, -1), idx.view(tiles, -1)
    log_row = row.bit_length() - 1
    for p in range(trs.tile_passes(n, row)):
        d = (_digit(k, trs.SHIFTS[p]) if p < trs.PASSES else
             (idx >> (log_row + trs.BITS * (p - trs.PASSES))) & (trs.BINS - 1))
        order = torch.sort(d, dim=1, stable=True).indices
        k, idx = torch.gather(k, 1, order), torch.gather(idx, 1, order)
    lane = (idx + torch.arange(tiles)[:, None] * trs.TILE).reshape(-1)[:n]
    return k.reshape(-1)[:n], val[lane]


@pytest.mark.parametrize("n,row", [(1, 1), (300 * 4, 4), (3 * 128, 128),
                                   (1 << 14, 4096), (3 * 4096 + 256, 256),
                                   (5000, 8), (1 << 13, 1), (2048, 2048)])
def test_radix_tile_design_sorts_packed_rows(n, row):
    """Emulated on the CPU, the tile passes leave every row sorted on its
    own with ties in lane order, real KEY_INVALID lanes before the
    padding."""
    rng = np.random.default_rng(n + row)
    key = rng.integers(-8, 8, n).astype(np.int32)
    key[rng.random(n) < 0.3] = KI
    val = torch.arange(n, dtype=torch.float32)      # tags each lane's order
    k, v = _emulate_radix_tiles(torch.from_numpy(key), val, row)
    want = torch.sort(torch.from_numpy(key).view(-1, row), dim=1, stable=True)
    _eq(k, want.values.reshape(-1))
    _eq(v, (want.indices + torch.arange(0, n, row)[:, None]).reshape(-1)
        .to(torch.float32))
