"""The paper's in-situ search (Alg. 1 / Fig. 11) on Hopper: the emission
sort, the alignment search, and Alg. 1's minima selection with the faithful
emission built on it.

Three CUDA kernels (``csrc/insitu_search.cu``), each with a plain torch twin
in this module and a launch counter on its wrapper:

* ``emit_sort_keys`` replaces ``src/repro/kernels/insitu_search.py:
  _make_emit_sort_kernel`` + ``_make_emit_merge_kernel``: the ascending
  key-only sort of the packed product stream. Bound by bytes. The TPU's
  bitonic network made one pass over device memory for every stride at or
  above a shared tile (136 of 153 grids at 2²⁸ keys); the port is the LSD
  radix sort of ``csrc/radix_sort.cuh`` (``radix_sort.sort_rows``): four
  8-bit digit passes of three grids each (count, scan, stable scatter), or
  one grid in shared memory for a stream of at most 4,096 keys.
  Plain twin: ``torch.sort`` (the reference's own ``jnp.sort`` realization).
* ``align_keys`` and ``align_product_keys`` replace ``_make_align_kernel``:
  ``slot = #{uk < pk}``, ``hit = pk ∈ uk``, bound by bytes. The TPU
  kernel's O(S·u) broadcast compare becomes lower-bound binary searches,
  O(S log u). ``align_keys`` searches all of ``uk`` for each key (the
  streaming step's kernel). ``align_product_keys`` takes the keys in SCCP's
  (k_a, n, k_b) lane order with each (s, c) group's row of C: the groups
  are sorted by row (``ell_spmm``'s CSR transpose), and one block a row
  reads that row's segment of ``uk`` once into shared memory, as a bitmap
  of its columns with popcount prefixes (a binary search of the segment in
  place, in rows wider than 131,072 columns or with equal keys), and ranks
  every lane of the row's groups there, so each segment is read once a
  call, not once a slab; a row's lanes past the first ``ROW_LANES`` are cut
  into runs of ``ROW_LANES``, one more block each, so a heavy row gets as
  many blocks as its lanes need. Any lane outside its block's row searches
  its own key's segment in device memory, so the answer does not rest on
  the grouping. Its lanes are 32-bit: a stream it does not take
  (``grouped_fits``) takes ``align_keys`` (``ops.align_products`` routes
  it).
  Plain twin of both: ``torch.searchsorted`` (the reference's
  ``searchsorted``).
* ``minima_mask`` replaces ``_minima_kernel``: the mask of the active rows
  holding min(v), the rows Alg. 1's 31-step bit scan keeps, bound by bytes.
  A block holds ``minima_chunk()`` keys in registers, read once; each
  thread folds its keys to their least, each warp reduces its lanes with
  one ``__reduce_min_sync`` (the same rows as the scan for keys ≥ 0), and
  the warps' values meet behind one barrier. Above one chunk, a first grid
  writes each block's value and a second folds them and writes the mask.
  Plain twin: one min and a compare (``minima_mask_xla``). ``faithful_emit``
  (the C entry ``minima_emit``, counted on ``minima_mask``) is the whole
  faithful emission in one launch of one block for streams of at most
  ``minima_chunk()`` keys: the keys stay in registers, each warp keeps its
  least active key in shared memory, an emission is one reduction of the
  warps' values, a rescan by the warps that held the minimum and one
  barrier, and the loop stops at the last key. Longer streams take
  ``out_cap`` steps of ``minima_mask``. Plain twin: that loop over
  ``minima_mask_plain`` (``faithful_emit_plain``).

Each wrapper launches its kernel for CUDA tensors and runs the plain twin
only for tensors the caller put on the CPU. ``emit_sorted_unique``,
``search_emit_sorted`` and ``_unique_heads`` keep the reference contracts
(``uk`` ascending, KEY_INVALID-padded; ``nnz`` the TRUE unique count on the
batched path and a floor of ``out_cap + 1`` on the faithful path when
truncated).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ell_spmm, radix_sort

KEY_INVALID = 2 ** 31 - 1          # INT32_MAX: dead lane / consumed row
EMIT_TILE = 4096                   # the reference's tile (unused by the sort)
_LIB = "insitu_search"


def next_pot(x: int) -> int:
    """Smallest power of two ≥ ``x`` (≥ 1)."""
    return 1 << max(0, int(x) - 1).bit_length()


def _cuda_operands(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA int32 contiguous operands on one device, False for CPU
    ones (plain twin); raises on anything the kernel does not take."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices {devices}")
    (dev,) = devices
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{name} kernel takes contiguous 1-D int32 keys, "
                            f"got {t.dtype} of shape {tuple(t.shape)}")
    return True


_P, _L = ctypes.c_void_p, ctypes.c_longlong


def _fn(name: str, *argtypes):
    """The library and its C entry ``name``, bound once by ``_build.bind``
    (pointers and the stream as ``c_void_p``)."""
    lib, fns = _build.bind(_LIB, {name: argtypes})
    return lib, fns[name]


# ---------------------------------------------------------------------------
# K4: the Alg. 1 minima scan
# ---------------------------------------------------------------------------

MAX_LANES = 2 ** 31 - 1         # lanes are int32 on the kernels' outputs


def minima_mask_plain(v: torch.Tensor) -> torch.Tensor:
    """Mask of the active rows holding min(v): the 31-step bit scan selects
    exactly the argmin rows, so one min and a compare give the same mask."""
    active = v != KEY_INVALID
    vmin = torch.where(active, v, KEY_INVALID).min()
    return active & (v == vmin)


def minima_chunk() -> int:
    """Keys one block of the K4 kernels holds (the library's answer, so it
    needs the built library): ``faithful_emit`` launches once up to it."""
    return _fn("minima_chunk")[1]()


def minima_parts(n: int) -> int:
    """int32 scratch of a ``minima_mask`` call on ``n`` keys (the library's
    answer): one survivor value for each block of grid 1, none while one
    block holds the keys."""
    return _fn("minima_part_ints", _L)[1](n)


def _minima_operand(name: str, v: torch.Tensor) -> bool:
    """``_cuda_operands`` for one key stream, its lanes checked first."""
    if v.device.type == "cuda" and v.numel() > MAX_LANES:
        raise ValueError(f"{name}: {v.numel()} keys, the kernel takes at "
                         f"most {MAX_LANES} lanes")
    return _cuda_operands(name, v)


def minima_mask(v: torch.Tensor) -> torch.Tensor:
    """Boolean mask of the rows holding min(v). v: (n,) int32 ≥ 0;
    KEY_INVALID marks consumed/invalid rows (the flipped sign bit). One
    grid up to ``minima_chunk()`` keys, two above, none for ``n = 0``."""
    if not _minima_operand("minima_mask", v):
        return minima_mask_plain(v)
    n = v.numel()
    mask = torch.empty(v.shape, dtype=torch.bool, device=v.device)
    parts = minima_parts(n)
    part = torch.empty(parts, dtype=torch.int32, device=v.device) \
        if parts else None
    lib, fn = _fn("minima_mask", _P, _P, _P, _L, _L,
                   ctypes.POINTER(ctypes.c_int), _P)
    launched = ctypes.c_int(0)
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), mask.data_ptr(),
                 None if part is None else part.data_ptr(), parts, n,
                 ctypes.byref(launched),
                 torch.cuda.current_stream(v.device).cuda_stream)
    minima_mask.launches += launched.value
    _build.check(lib, _LIB, err)
    return mask


minima_mask.launches = 0


def _emit_loop(v: torch.Tensor, out_cap: int, mask_fn):
    """``out_cap`` Alg. 1 emissions, one ``mask_fn`` step each: each emits
    the minimum of ``v`` (KEY_INVALID once no valid row is left) and how
    many rows held it, and invalidates those rows. Returns (vals, counts,
    nnz), nnz the keys emitted plus 1 if a valid row is left."""
    vals, counts = [v.new_empty(0)], [v.new_empty(0)]
    for _ in range(out_cap):
        mask = mask_fn(v)
        vals.append(torch.where(mask, v, KEY_INVALID).min()[None])
        counts.append(mask.sum(dtype=torch.int32)[None])
        v = torch.where(mask, KEY_INVALID, v)       # flip consumed rows
    vals = torch.cat(vals)
    left = (v != KEY_INVALID).any()
    return (vals, torch.cat(counts),
            (vals != KEY_INVALID).sum(dtype=torch.int32) + left.to(torch.int32))


def faithful_emit_plain(v: torch.Tensor, out_cap: int):
    """The faithful emission's plain version: ``out_cap`` steps over
    ``minima_mask_plain``."""
    return _emit_loop(v, out_cap, minima_mask_plain)


def faithful_emit(v: torch.Tensor, out_cap: int, *, counts: bool = True):
    """Iterated Alg. 1 (Fig. 11) on the key stream ``v`` (never written):
    ``(vals, counts, nnz)``, ``vals`` (out_cap,) the sorted distinct valid
    keys padded with KEY_INVALID, ``counts`` (out_cap,) the rows holding
    each (0 in padding; None when ``counts=False``), ``nnz`` the keys
    emitted plus 1 if a valid row is left after ``out_cap`` emissions.
    A stream of at most ``minima_chunk()`` keys is one launch of
    ``minima_emit`` (counted on ``minima_mask``), which stops at the last
    key; a longer one takes ``out_cap`` steps of ``minima_mask``."""
    cuda = _minima_operand("faithful_emit", v)
    n = v.numel()
    if not cuda or n > minima_chunk():
        vals, cnt, nnz = _emit_loop(
            v, out_cap, minima_mask if cuda else minima_mask_plain)
        return vals, cnt if counts else None, nnz
    vals = torch.empty(out_cap, dtype=torch.int32, device=v.device)
    cnt = torch.empty(out_cap, dtype=torch.int32, device=v.device) \
        if counts else None
    nnz = torch.empty((), dtype=torch.int32, device=v.device)
    lib, fn = _fn("minima_emit", _P, _L, _P, _P, _P, _L, _P)
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), n, vals.data_ptr(),
                 None if cnt is None else cnt.data_ptr(), nnz.data_ptr(),
                 out_cap, torch.cuda.current_stream(v.device).cuda_stream)
    _build.check(lib, _LIB, err)
    minima_mask.launches += 1
    return vals, cnt, nnz


def search_emit_sorted(v: torch.Tensor, max_unique: int):
    """Iterated Alg. 1 (Fig. 11): repeatedly emit the minimal value and
    invalidate its rows — the sorted unique values in the hardware's
    emission order. Returns (values, counts), each (max_unique,); empty
    slots carry KEY_INVALID / 0."""
    vals, counts, _ = faithful_emit(v, max_unique)
    return vals, counts


# ---------------------------------------------------------------------------
# K2: batched emission, the sorted key stream in one network
# ---------------------------------------------------------------------------

def emit_sort_keys_plain(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key).values


def emit_sort_keys(key: torch.Tensor, *, tile: int = EMIT_TILE) -> torch.Tensor:
    """Ascending sort of a power-of-two int32 key stream (any int32, as
    ``torch.sort`` orders them). ``tile`` is the reference's bitonic tile,
    validated as a power of two for its signature; the radix design does
    not use it. ``key`` is never written: the passes alternate between the
    output and one scratch stream of ``n`` keys."""
    if not _cuda_operands("emit_sort_keys", key):
        return emit_sort_keys_plain(key)
    n = key.numel()
    if n & (n - 1) or tile < 1 or tile & (tile - 1):
        raise ValueError(f"emit_sort_keys: stream {n} and tile {tile} must be "
                         "powers of two")
    out = torch.empty_like(key)
    if n:
        radix_sort.sort_rows(emit_sort_keys, key, None, out, None, n)
    return out


emit_sort_keys.launches = 0


def _unique_heads(ks: torch.Tensor, out_cap: int):
    """Run-head compaction of a sorted key stream: the first lane of every
    equal-key run, packed densely — the emission order of the iterated
    Alg. 1 scan. Returns (uk (out_cap,) ascending KEY_INVALID-padded,
    nnz = TRUE unique count, > out_cap when truncated)."""
    prev = torch.cat([ks.new_full((1,), -1), ks[:-1]])
    head = (ks != prev) & (ks != KEY_INVALID)
    heads = ks[head]
    nnz = torch.tensor(heads.numel(), dtype=torch.int32, device=ks.device)
    uk = torch.full((out_cap,), KEY_INVALID, dtype=torch.int32,
                    device=ks.device)
    kept = min(out_cap, heads.numel())
    uk[:kept] = heads[:kept]
    return uk, nnz


def emit_sorted_unique(key: torch.Tensor, out_cap: int, *,
                       faithful: bool = False, tile: int = EMIT_TILE):
    """The ``'search'`` backend's emission phase: the sorted unique keys of
    a packed product stream (Fig. 11c).

    Returns ``(uk, nnz)``: ``uk`` (out_cap,) ascending with KEY_INVALID
    padding, ``nnz`` the true unique-key count (``nnz > out_cap`` flags
    truncation; the first ``out_cap`` unique keys are kept).
    ``faithful=True`` runs the literal iterated Alg. 1 scan
    (``faithful_emit``: one launch up to ``minima_chunk()`` keys) instead of
    the batched sort; the two are bit-identical, and the faithful ``nnz`` is
    ``out_cap + 1`` when truncated (a floor).
    """
    if faithful:
        uk, _, nnz = faithful_emit(key, out_cap, counts=False)
        return uk, nnz
    return _unique_heads(emit_sort_keys(key, tile=tile), out_cap)


# ---------------------------------------------------------------------------
# K3: alignment, every product key located in the sorted unique list
# ---------------------------------------------------------------------------

def align_keys_plain(pk: torch.Tensor, uk: torch.Tensor):
    u = uk.numel()
    slot = torch.searchsorted(uk, pk, side="left", out_int32=True)
    if u == 0:
        return slot, torch.zeros(pk.shape, dtype=torch.bool, device=pk.device)
    hit = uk[torch.clamp(slot, max=u - 1)] == pk
    return slot, hit


def align_keys(pk: torch.Tensor, uk: torch.Tensor):
    """Locate every product key in the ascending unique list ``uk``.

    Returns ``(slot, hit)``: ``slot[i] = #{j : uk[j] < pk[i]}`` and
    ``hit[i] = pk[i] ∈ uk``, dead lanes included (a KEY_INVALID product key
    gets slot = #{valid uk} and hits iff ``uk`` has padding; callers mask it).
    """
    if not _cuda_operands("align_keys", pk, uk):
        return align_keys_plain(pk, uk)
    slot = torch.empty(pk.shape, dtype=torch.int32, device=pk.device)
    hit = torch.empty(pk.shape, dtype=torch.bool, device=pk.device)
    lib, fn = _fn("align_keys", _P, _P, _P, _P, _L, _L, _P)
    with torch.cuda.device(pk.device):
        err = fn(pk.data_ptr(), uk.data_ptr(), slot.data_ptr(), hit.data_ptr(),
                 pk.numel(), uk.numel(),
                 torch.cuda.current_stream(pk.device).cuda_stream)
    _build.check(lib, _LIB, err)
    align_keys.launches += 1
    return slot, hit


align_keys.launches = 0


ROW_LANES = 65536               # lanes a row block takes at most (the .cu's)


def grouped_fits(n: int, u: int, n_rows: int) -> bool:
    """Whether ``align_product_keys`` takes ``n`` product keys against
    ``u`` unique keys in ``n_rows`` rows of C: its lanes are 32-bit, and its
    row grid (a block a row, and one for each ``ROW_LANES`` of the stream)
    holds fewer than 2³¹ blocks."""
    return max(n, u) < 2 ** 31 and n_rows + -(-n // ROW_LANES) < 2 ** 31


def align_scratch_ints(groups: int, n_rows: int) -> int:
    """int32 scratch of one ``align_product_keys`` call: the CSR transpose
    of the ``groups`` group rows, then ``n_rows + 1`` row bounds of uk."""
    return ell_spmm.scratch_ints(1, groups, n_rows) + n_rows + 1


def align_grids(n: int, groups: int, k_b: int, n_rows: int) -> int:
    """Grids one ``align_product_keys`` call launches on ``n`` product keys:
    the transpose of the groups (as ``ell_spmm.grids`` counts it, less the
    gather), the row bounds of uk, the row blocks (none without rows) and
    the loose lanes; none for an empty stream."""
    if n == 0:
        return 0
    groups = groups if k_b else 0
    sort = 0 if groups == 0 else 1 if groups <= ell_spmm.TILE \
        else 3 * ell_spmm.transpose_passes(n_rows)
    return sort + 1 + 1 + (1 if n_rows else 0) + 1


def align_product_keys(pk: torch.Tensor, uk: torch.Tensor,
                       group_row: torch.Tensor, *, k_b: int, n_rows: int,
                       n_cols: int):
    """``align_keys(pk, uk)``, lane for lane and bit for bit, on a product
    stream in SCCP's (k_a, n, k_b) lane order: ``group_row`` (k_a, n) (any
    shape of ``k_a·n`` lanes, contiguous) holds the row of C of each (s, c)
    group, whose ``k_b`` keys are ``pk[g·k_b : (g+1)·k_b]``; lanes past
    ``k_a·n·k_b`` are padding. Keys are packed ``row·n_cols + col`` with
    ``n_rows·n_cols < 2³¹ − 1``, and ``grouped_fits`` holds (CUDA operands
    raise otherwise).
    ``group_row`` only orders the work: a wrong or out-of-range row changes
    no answer."""
    flat = group_row.view(-1) if group_row.is_contiguous() else group_row
    if not _cuda_operands("align_product_keys", pk, uk, flat):
        return align_keys_plain(pk, uk)
    groups, n = flat.numel(), pk.numel()
    if k_b < 0 or groups * k_b > n or n_rows < 0 or n_cols < 0 \
            or n_rows * n_cols >= KEY_INVALID \
            or not grouped_fits(n, uk.numel(), n_rows):
        raise ValueError(f"align_product_keys: {groups} groups of {k_b} "
                         f"lanes over {n} keys in a {n_rows}x{n_cols} space")
    slot = torch.empty(pk.shape, dtype=torch.int32, device=pk.device)
    hit = torch.empty(pk.shape, dtype=torch.bool, device=pk.device)
    scratch = torch.empty(align_scratch_ints(groups, n_rows),
                          dtype=torch.int32, device=pk.device)
    lib, fn = _fn("align_product_keys", *[_P] * 6, *[_L] * 7,
                  ctypes.POINTER(ctypes.c_int), _P)
    launched = ctypes.c_int(0)
    with torch.cuda.device(pk.device):
        err = fn(pk.data_ptr(), uk.data_ptr(), flat.data_ptr(),
                 slot.data_ptr(), hit.data_ptr(), scratch.data_ptr(),
                 scratch.numel(), n, uk.numel(), groups, k_b, n_rows, n_cols,
                 ctypes.byref(launched),
                 torch.cuda.current_stream(pk.device).cuda_stream)
    align_product_keys.launches += launched.value
    _build.check(lib, _LIB, err)
    return slot, hit


align_product_keys.launches = 0
