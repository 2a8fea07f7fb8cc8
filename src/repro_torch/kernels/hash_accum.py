"""Fixed-capacity open-addressing hash accumulation, mirroring
``src/repro/kernels/hash_accum.py``.

Every product finds its output coordinate's slot in a per-row-block table
(linear probing, multiplicative hashing); values then land in the slots with
one ``index_add_``, and only the tables (size ~ nnz(C), not ~ products) are
sorted, by ``bitonic_merge.sort_tiles`` (one row a block), to meet the
sorted-COO contract. Block key ranges are disjoint, so the sorted tables,
concatenated, are globally sorted.

The probe loop is plain XLA in the reference, not a Pallas kernel, so here it
is plain torch with the reference's round-synchronous rule, which fixes
which products a table too small drops: every round, each pending product
reads its probe slot's occupant; products that found it empty claim it
with a scatter-min (of distinct keys racing for one slot the smallest wins);
a product retires once the slot holds its key. Retired products are dropped
from the next round's work, which changes nothing (in the reference they
only ever attempt the no-op empty key).
"""
from __future__ import annotations

from typing import Optional

import torch

from .bitonic_merge import KEY_INVALID, sort_tiles

_EMPTY = KEY_INVALID                # sorts-last sentinel doubles as empty slot
_HASH_MULT = 2654435761             # Knuth multiplicative (2^32 / phi)
_MASK32 = 0xFFFFFFFF


def _hash(key: torch.Tensor, cap: int) -> torch.Tensor:
    """Multiplicative hash of a packed coordinate into [0, cap), in the
    reference's uint32 arithmetic. The 32x32-bit product is formed from two
    16-bit halves of the multiplier so it never leaves int64."""
    k = key.to(torch.int64) & _MASK32
    lo = k * (_HASH_MULT & 0xFFFF)
    hi = (k * (_HASH_MULT >> 16)) & 0xFFFF
    h = (lo + (hi << 16)) & _MASK32
    h = h ^ (h >> 16)
    return (h & (cap - 1)).to(torch.int32)


def hash_tables(key: torch.Tensor, val: torch.Tensor, *, n_blocks: int,
                block_cap: int, keys_per_block: int,
                max_probes: Optional[int] = None):
    """Probe every product into its block's table and total the values per
    slot. Returns ``(table_key, table_val, dropped)``: the
    ``(n_blocks · block_cap,)`` tables (_EMPTY / 0 in free slots) and the
    int32 count of products that found no slot."""
    if block_cap & (block_cap - 1):
        raise ValueError(f"block_cap must be a power of two, got {block_cap}")
    probes = block_cap if max_probes is None else min(max_probes, block_cap)
    tsize = n_blocks * block_cap
    dev = key.device
    block = torch.clamp(torch.div(key, keys_per_block, rounding_mode="floor"),
                        max=n_blocks - 1)
    pend = torch.nonzero(key != KEY_INVALID).squeeze(1)    # pending lanes
    pkey = key[pend]
    base = block[pend].long() * block_cap
    h0 = _hash(pkey, block_cap).long()
    table = torch.full((tsize,), _EMPTY, dtype=torch.int32, device=dev)
    slot_of = torch.full((key.numel(),), -1, dtype=torch.int64, device=dev)
    for p in range(probes):
        if pend.numel() == 0:
            break
        slot = base + ((h0 + p) & (block_cap - 1))
        empty = table[slot] == _EMPTY
        table.scatter_reduce_(0, slot[empty], pkey[empty], "amin")
        matched = table[slot] == pkey
        slot_of[pend[matched]] = slot[matched]
        keep = ~matched
        pend, pkey, base, h0 = pend[keep], pkey[keep], base[keep], h0[keep]
    seg = torch.where(slot_of >= 0, slot_of, tsize)
    table_val = torch.zeros(tsize + 1, dtype=val.dtype, device=dev)
    table_val.index_add_(0, seg, torch.where(slot_of >= 0, val, 0))
    return (table, table_val[:tsize],
            torch.tensor(pend.numel(), dtype=torch.int32, device=dev))


def hash_merge(key: torch.Tensor, val: torch.Tensor, *, n_blocks: int,
               block_cap: int, keys_per_block: int,
               max_probes: Optional[int] = None):
    """Hash-accumulate a packed-key product stream; emit the sorted tables.

    ``key`` (n,) int32 (KEY_INVALID on dead lanes), ``val`` (n,) float.
    Returns ``(key_sorted, totals, dropped)`` in the ``sort_merge`` contract
    (globally sorted unique keys, block-concatenated, empty slots parked at
    each block's tail, every valid lane carrying its group total) and the
    int32 count of products dropped by probe or table exhaustion.
    ``max_probes=None`` probes a full cycle, so only a full table drops.
    """
    table, table_val, dropped = hash_tables(
        key, val, n_blocks=n_blocks, block_cap=block_cap,
        keys_per_block=keys_per_block, max_probes=max_probes)
    key_s, tot = sort_tiles(table, table_val, tile=block_cap)
    return key_s, tot, dropped
