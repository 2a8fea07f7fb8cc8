"""Launch geometry and pass order of the LSD radix sort in
``csrc/radix_sort.cuh`` (built as the library ``radix_sort``), shared by K2
(``insitu_search.emit_sort_keys``, keys alone), K5
(``bitonic_merge.sort_tiles``, (key, value) pairs) and K8
(``fused_sccp_stream.fused_slab_sort``, whose first digit forms its lanes
from its operands: ``sort_rows(first_digit=)``).

A sort of every power-of-two row of ``row`` lanes is four passes of one
8-bit digit each (``SHIFTS``), low digit first; each pass is stable, so the
fourth leaves every row ascending with ties in lane order. Rows of at most
one 4,096-lane tile take one grid (``radix_rows``): a block sorts a tile of
whole rows in shared memory, with ``tile_passes`` digit passes. A longer
row takes three grids a pass: ``radix_upsweep`` counts the digit over each
block's lanes, ``radix_scan`` turns each row's counts into offsets,
``radix_downsweep`` scatters stably. The passes
alternate between the output and one scratch buffer, and start from the
input, which is never written: with an even number of passes the first
writes the scratch and the last the output (``pass_buffers``).

Everything here is host arithmetic, tested on the CPU; the grids run only
on CUDA tensors.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build

BITS = 8                       # a digit
BINS = 1 << BITS
PASSES = 32 // BITS
SHIFTS = tuple(BITS * p for p in range(PASSES))
TILE = 4096                    # lanes a block ranks at once (256 threads x 16)
TARGET_BLOCKS = 1024           # blocks of a segmented grid, about 8 an SM
_LIB = "radix_sort"


@dataclass(frozen=True)
class Geometry:
    """How a segmented pass cuts ``n`` lanes in rows of ``row`` (> TILE):
    every row into ``blocks_per_row`` blocks of ``tiles_per_block``
    consecutive tiles, the last block owning the rest of the row; ``counts``
    int32 entries hold one count (then one offset) per (row, bin, block)."""
    n: int
    row: int
    tiles_per_block: int
    blocks_per_row: int

    @property
    def rows(self) -> int:
        return self.n // self.row

    @property
    def counts(self) -> int:
        return self.rows * BINS * self.blocks_per_row


def geometry(n: int, row: int) -> Geometry:
    """The segmented geometry of ``n`` lanes in power-of-two rows of ``row``
    > TILE lanes: about TARGET_BLOCKS blocks in all, each owning a
    power-of-two number of tiles inside one row."""
    if row <= TILE or row & (row - 1) or n % row:
        raise ValueError(f"radix geometry: rows of {row} must be a power of "
                         f"two above {TILE} dividing {n}")
    tiles_per_row = row // TILE
    want = -(-(n // TILE) // TARGET_BLOCKS)        # tiles a block, at least
    tpb = min(tiles_per_row, 1 << (want - 1).bit_length())
    return Geometry(n=n, row=row, tiles_per_block=tpb,
                    blocks_per_row=tiles_per_row // tpb)


def span_geometry(n: int) -> Geometry:
    """The segmented geometry of one row of ``n`` lanes, a multiple of TILE
    above it that need not be a power of two (K8's real lanes rounded up to
    a tile): about TARGET_BLOCKS / 2 blocks of the same number of tiles, the
    last one owning what is left. Half the target: the row's scan is one
    block that walks every block's counts, and K8's rows are short."""
    if n <= TILE or n % TILE:
        raise ValueError(f"radix span: {n} lanes must be a multiple of "
                         f"{TILE} above it")
    tiles = n // TILE
    tpb = -(-tiles // (TARGET_BLOCKS // 2))
    return Geometry(n=n, row=n, tiles_per_block=tpb,
                    blocks_per_row=-(-tiles // tpb))


def tile_passes(n: int, row: int) -> int:
    """Digit passes of the one-grid sort of ``n`` lanes in power-of-two rows
    of ``row`` <= TILE: the four key digits, then, where a tile holds
    several rows, the tile-local row index (lane // row, TILE // row values)
    in 8-bit digits as the most significant key, so every row comes back to
    its own lanes. A stream of one row (``n == row``) needs none: the
    padding that fills its tile sorts after every real key."""
    if row < 1 or row > TILE or row & (row - 1) or n % row:
        raise ValueError(f"radix tile: rows of {row} must be a power of two "
                         f"of at most {TILE} dividing {n}")
    if n == row or row == TILE:
        return PASSES
    row_bits = (TILE // row).bit_length() - 1
    return PASSES + -(-row_bits // BITS)


def pass_buffers(passes: int = PASSES) -> list[tuple[str, str]]:
    """(source, destination) of each pass among ``"in"``, ``"scratch"`` and
    ``"out"``: the first reads the input, the last writes the output, and no
    pass reads the buffer it writes. Needs an even number of passes."""
    if passes < 2 or passes % 2:
        raise ValueError(f"radix passes must be even, got {passes}")
    order = []
    src = "in"
    for p in range(passes):
        dst = "out" if (passes - 1 - p) % 2 == 0 else "scratch"
        order.append((src, dst))
        src = dst
    return order


_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGS = {"radix_rows": (_P, _P, _P, _P, _L, _L, _I, _P),
         "radix_upsweep": (_P, _P, _L, _L, _I, _I, _I, _P),
         "radix_scan": (_P, _L, _I, _P),
         "radix_downsweep": (_P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _P)}


def _entries() -> tuple[ctypes.CDLL, dict]:
    return _build.bind(_LIB, _ARGS)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def sort_rows(wrapper, kin, vin, kout: torch.Tensor, vout, row: int, *,
              v_scratch=None, first_digit=None) -> None:
    """Sort every ``row``-lane row of ``kin`` (with ``vin`` beside it, or
    keys alone when ``vin`` is None) into ``kout`` (``vout``) on the current
    stream, adding each grid to ``wrapper.launches``. A row above one tile
    needs a key scratch stream and the counts, allocated here, and a value
    scratch stream, the caller's ``v_scratch`` where given (any buffer it
    writes only later).

    ``first_digit`` forms the lanes of the first digit pass in place of
    reading ``kin``/``vin`` (both None then): its ``upsweep(counts, g,
    shift, stream)`` and ``downsweep(counts, kd, vd, g, shift, stream)``
    each launch that pass's grid over geometry ``g`` and raise on an error.
    The sort is then one row of ``kout``'s length, a multiple of TILE above
    it (``span_geometry``)."""
    n = kout.numel()
    lib, fns = _entries()
    dev = kout.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream

        def launch(name, *args):
            _build.check(lib, _LIB, fns[name](*args, stream))
            wrapper.launches += 1

        if first_digit is None and row <= TILE:
            launch("radix_rows", kin.data_ptr(), _ptr(vin), kout.data_ptr(),
                   _ptr(vout), n, row, tile_passes(n, row))
            return
        g = geometry(n, row) if first_digit is None else span_geometry(n)
        bufs = {"in": (kin, vin), "out": (kout, vout),
                "scratch": (torch.empty_like(kout),
                            v_scratch if v_scratch is not None or vout is None
                            else torch.empty_like(vout))}
        counts = torch.empty(g.counts, dtype=torch.int32, device=dev)
        for p, (shift, (src, dst)) in enumerate(zip(SHIFTS, pass_buffers())):
            (ks, vs), (kd, vd) = bufs[src], bufs[dst]
            formed = p == 0 and first_digit is not None
            if formed:
                first_digit.upsweep(counts, g, shift, stream)
                wrapper.launches += 1
            else:
                launch("radix_upsweep", ks.data_ptr(), counts.data_ptr(), n,
                       g.row, g.blocks_per_row, g.tiles_per_block, shift)
            launch("radix_scan", counts.data_ptr(), g.rows, g.blocks_per_row)
            if formed:
                first_digit.downsweep(counts, kd, vd, g, shift, stream)
                wrapper.launches += 1
            else:
                launch("radix_downsweep", ks.data_ptr(), _ptr(vs),
                       kd.data_ptr(), _ptr(vd), counts.data_ptr(), n, g.row,
                       g.blocks_per_row, g.tiles_per_block, shift)
