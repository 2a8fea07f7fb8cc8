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
           (64, 8, 0, 16)]                            # all lanes dead


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
