#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds every CUDA kernel from ``src/repro_torch/csrc`` and drives the port's
single-device SpGEMM, cold through all six ported accumulators ('sort',
'search', 'tiled', 'bucket', 'hash', 'stream') and warm through the numeric
phase on a 'sort' and a 'stream' structure, and its SpMM side (MoE with
``dispatch='spmm'``, ``SparseMLP``/``SparseLinear``), at a real size: C = A·Aᵀ
for the paper's Table-I
matrix bcsstk32 (dim 45,000, nnz 2.0M), regenerated from its published
statistics exactly as ``benchmarks/common.py`` does (same seeds, same draws;
this script keeps its own copy and imports nothing of the JAX package).
Values are integers in [-4, 4] \\ {0} drawn from ``--seed``, so every float32
sum is exact and every comparison below is bit for bit.

Phases (any failure exits non-zero before the last line):

1. The card, the torch/CUDA versions and the kernels' build time.
2. Each kernel against its plain torch version on the card, at the shapes
   the main path gives it, bit for bit, with its time, the plain version's
   time, one library call's time where one computes the same function, and
   the least time the card could take (``bound_ms``). The planner's sizes
   for the 'bucket' and 'hash' paths are printed first (``[plan]``). Then
   ``make_structure`` for a 'sort' and a 'stream' plan, timed, and K1 and
   K3 held again at the warm phase's own shapes on those structures.
3. The main path through the front door, with the launch counters zeroed
   just before each path and read just after: ``spgemm(a, b, check=True)``
   (``'sort'``), ``spgemm(a, b, accumulator=X, check=True)`` for the other
   five, the faithful Alg. 1 emission (``search_merge(faithful=True)``) on a
   one-column cut of A, and ``spgemm(a, b, structure=st, check=True)`` for
   both structures. The eight full outputs must be bit-identical, hold
   exactly nnz(C) groups, and equal scipy's A @ Aᵀ; a stale structure with
   ``validate=False`` must poison ``ngroups``; the 'stream' call's stages,
   replayed one by one, must give its result.
4. The end-to-end times with each path's per-call peak memory and the
   stage split.
5. The SpMM slice at deepseek-v2-lite's published widths (d_model 2048, 64
   routed experts top-6 with d_ff_expert 1408, 2 shared experts, capacity
   factor 1.25, dense FFN 10944) on a prefill batch of 4 x 1,024 tokens:
   K9 at the MoE dispatch and combine shapes and K10 at the 2:4
   ``SparseMLP``'s fc_in and fc_out shapes, each bit for bit against its
   plain version on integer-valued operands, with the same times and bound;
   beside K10, the time of its probe build with no gather (every lane reads
   its window's first column: ``_build.VARIANTS["nm_spmm_broadcast"]``).
6. The SpMM paths, counters zeroed around each, with per-call peak memory:
   ``moe_apply`` (two K9 launches; routing equal to, and y within 1e-4 of
   max|y| of, the same call on CPU tensors), ``SparseMLP(w_in, w_out, 0.5,
   nm=(2, 4))`` (two K10 launches; each layer bit-identical to ``x @ wp``
   with TF32 off), the ELLPACK twin on 8 tokens (bit-identical to the N:M
   route), ``SparseLinear(nm="auto")`` at a 90% global prune (routes to
   ELLPACK), and ``matmul_sparse(backend='sort')`` twice (a cache miss,
   then a hit); then three timed calls of the MoE layer and the MLP.
7. A ``kernels`` JSON line (all ten kernels), the card's name and power
   limit, and as the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# Table I row 3 of the paper, as in benchmarks/common.py:
# (id, name, dim, nnz, nnz_av, sigma)
BCSSTK32 = (3, "bcsstk32", 45_000, 2_000_000, 45.2, 15.48)

ACCUMULATORS = ("sort", "search", "tiled", "bucket", "hash", "stream")

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the CUDA-core fp32
# rate, the table's nearest entry for the int32 compares these kernels do.
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# The operand: benchmarks/common.py's generator for one Table-I row
# ---------------------------------------------------------------------------

def draw_row_counts(dim: int, nnz: int, sigma: float, rng) -> np.ndarray:
    counts = rng.normal(nnz / dim, sigma, size=dim)
    counts = np.clip(np.round(counts), 0, dim).astype(np.int64)
    diff = nnz - counts.sum()
    idx = rng.integers(0, dim, size=abs(int(diff)))
    np.add.at(counts, idx, 1 if diff > 0 else -1)
    return np.clip(counts, 0, dim)


def table1_matrix(row, seed: int):
    """scipy CSR of one Table-I matrix: the sparsity pattern of
    ``benchmarks.common.build_scipy(bench_matrices()[mid - 1])``, with
    integer values in [-4, 4] \\ {0} drawn from ``seed``."""
    import scipy.sparse as sp
    mid, _, dim, nnz, _, sigma = row
    counts = draw_row_counts(dim, nnz, sigma, np.random.default_rng(1000 + mid))
    rng = np.random.default_rng(2000 + mid)
    indptr = np.zeros(dim + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = np.empty(indptr[-1], np.int32)
    for r in range(dim):
        lo, hi = indptr[r], indptr[r + 1]
        k = hi - lo
        if k:
            indices[lo:hi] = rng.choice(dim, size=k, replace=False) \
                if k < dim // 4 else rng.permutation(dim)[:k]
    vals = np.random.default_rng(seed)
    data = (vals.integers(1, 5, indptr[-1])
            * vals.choice(np.array([-1, 1]), indptr[-1])).astype(np.float32)
    return sp.csr_matrix((data, indices, indptr), shape=(dim, dim))


# ---------------------------------------------------------------------------
# Measurement helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_ms(fn):
    """``fn()`` and its host-clock ms, synchronised before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the core rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same(name: str, got, want) -> float:
    """Require bit-identical tensors; returns max |got - want| (0.0)."""
    import torch
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{name}: {got.dtype}{tuple(got.shape)} vs "
            f"{want.dtype}{tuple(want.shape)}")
    require(torch.equal(got, want), f"{name}: kernel disagrees with plain")
    if got.dtype == torch.bool:
        return 0.0
    return float((got.double() - want.double()).abs().max()) if got.numel() \
        else 0.0


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def held_pair(name: str, kernel, plain, library, shape: str, n_bytes: float,
              n_ops: float) -> dict:
    """Hold ``kernel()`` against ``plain()`` bit for bit (every output of a
    tuple), then time the kernel, the plain version and ``library`` (None
    where no one library call computes the same function). Returns the
    shape's entry, also printed as a ``[kernel]`` line."""
    import torch
    got, want = kernel(), plain()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = max(same(f"{name}[{i}] {shape}", g, w)
              for i, (g, w) in enumerate(zip(got, want)))
    del got, want
    t, by = bound(n_bytes, n_ops)
    r = dict(shape=shape, max_abs_err=err, ms=cuda_ms(kernel, 3),
             plain_ms=cuda_ms(plain, 2),
             library_ms=None if library is None else cuda_ms(library, 3),
             bound_ms=t, bound_by=by)
    print(f"[kernel] {name} {shape}: bit-identical, {json.dumps(r)}",
          flush=True)
    return r


def kernel_row(name: str, source: str, replaces: str, shapes: list,
               **extra) -> dict:
    """A ``kernels`` line entry: the first shape's numbers, and all shapes."""
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                **shapes[0], shapes=shapes, **extra)


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

def align_shape(shape: str, pk, uk) -> dict:
    """K3 held against its plain version on product keys ``pk`` and the
    ascending unique keys ``uk``; ``torch.searchsorted`` is the library
    call. The bound reads each product key and writes its slot and hit;
    of ``uk`` it counts at most one key a product key, since fewer product
    keys than unique keys need not read all of them."""
    import torch
    from repro_torch.kernels import insitu_search as isr
    s, u = pk.numel(), uk.numel()
    return held_pair("align_keys", lambda: isr.align_keys(pk, uk),
                     lambda: isr.align_keys_plain(pk, uk),
                     lambda: torch.searchsorted(uk, pk, out_int32=True),
                     shape, 9 * s + 4 * min(u, s),
                     s * math.ceil(math.log2(u + 1)))


def check_kernels(a, b, a_cut, b_cut) -> list:
    import torch
    from repro_torch.kernels import insitu_search as isr
    from repro_torch.kernels import ops
    from repro_torch.kernels import sccp_multiply as k1
    rows = []

    # K1: SCCP multiply, (k_a, n) x (n, k_b)
    args = (a.val, a.idx, b.val, b.idx)
    k_a, n = a.val.shape
    k_b = b.val.shape[1]
    lanes = k_a * n * k_b
    rows.append(kernel_row(
        "sccp_multiply", "src/repro_torch/csrc/sccp_multiply.cu",
        "src/repro/kernels/sccp_multiply.py:29", [held_pair(
            "sccp_multiply", lambda: k1.sccp_multiply(*args),
            lambda: k1.sccp_multiply_plain(*args), None,
            f"({k_a},{n})x({n},{k_b})", 8 * (k_a * n + n * k_b) + 12 * lanes,
            lanes)]))

    # K2: emission sort of the main path's packed key stream
    val, row, col = k1.sccp_multiply(*args)
    key, _ = ops._packed_stream(row, col, val, a.n_rows, b.n_cols)
    del val, row, col
    torch.cuda.empty_cache()
    s = key.numel()
    rows.append(kernel_row(
        "emit_sort", "src/repro_torch/csrc/insitu_search.cu",
        "src/repro/kernels/insitu_search.py:164", [held_pair(
            "emit_sort", lambda: isr.emit_sort_keys(key),
            lambda: isr.emit_sort_keys_plain(key), lambda: torch.sort(key),
            f"({s},)", 8 * s, s * math.log2(s))]))

    # K3: align every product key against the sorted unique keys
    ks = isr.emit_sort_keys(key)
    n_unique = int(isr._unique_heads(ks, 1)[1])
    uk, _ = isr._unique_heads(ks, max(128, -(-n_unique // 128) * 128))
    del ks
    rows.append(kernel_row(
        "align_keys", "src/repro_torch/csrc/insitu_search.cu",
        "src/repro/kernels/insitu_search.py:268",
        [align_shape(f"search: ({s},) in ({uk.numel()},), {n_unique} unique",
                     key, uk)]))
    del uk

    # K4: the bit-serial minima scan, at the main path's shape (the packed
    # stream of the faithful path's one-column cut) and over 2^20 keys of
    # the full stream; then the faithful emission against the batched one
    # (untruncated and truncated)
    val, row, col = k1.sccp_multiply(a_cut.val, a_cut.idx, b_cut.val,
                                     b_cut.idx)
    v_cut, _ = ops._packed_stream(row, col, val, a_cut.n_rows, b_cut.n_cols)
    v = key[: 1 << 20].contiguous()
    for vec in (v_cut, v):
        nv = vec.numel()
        err = same(f"minima_mask ({nv},)", isr.minima_mask(vec),
                   isr.minima_mask_plain(vec))
        t, by = bound(5 * nv, 31 * nv)
        r = dict(ms=cuda_ms(lambda: isr.minima_mask(vec), 20),
                 plain_ms=cuda_ms(lambda: isr.minima_mask_plain(vec), 20),
                 bound_ms=t, bound_by=by)
        print(f"[kernel] minima_mask {nv} keys: bit-identical, {json.dumps(r)}",
              flush=True)
        if vec is v_cut:
            rows.append(dict(
                name="minima_mask", route="cuda",
                source="src/repro_torch/csrc/insitu_search.cu",
                replaces="src/repro/kernels/insitu_search.py:46",
                max_abs_err=err, shape=f"({nv},)", library_ms=None, **r))
    for lanes_cut, cap in ((512, 512), (4096, 256)):
        kk = key[:lanes_cut].contiguous()
        uk_f, nnz_f = isr.emit_sorted_unique(kk, cap, faithful=True)
        uk_b, nnz_b = isr.emit_sorted_unique(kk, cap)
        same(f"faithful emission uk ({lanes_cut} lanes, cap {cap})", uk_f, uk_b)
        nf, nb = int(nnz_f), int(nnz_b)
        require(nf == nb if nb <= cap else (nf == cap + 1 and nb > cap),
                f"faithful nnz {nf} vs batched {nb} at cap {cap}")
        print(f"[kernel] faithful emission {lanes_cut} lanes cap {cap}: "
              f"uk bit-identical, nnz {nf} / {nb}", flush=True)
    del key, v
    torch.cuda.empty_cache()
    return rows


def plan_sizes(a, b, nnz_c: int):
    """The planner's blocking sizes for this operand, with the histogram
    maxima they come from; printed as the ``[plan]`` line."""
    from repro_torch.plan.planner import make_plan
    from repro_torch.plan.symbolic import per_row_counts
    plan = make_plan(a, b, backend="hash")
    prod, uniq = (x.cpu().numpy() for x in per_row_counts(a, b))
    rpb = -(-a.n_rows // plan.n_buckets)

    def largest(per_row):
        return int(np.pad(per_row, (0, plan.n_buckets * rpb - a.n_rows))
                   .reshape(plan.n_buckets, rpb).sum(axis=1).max())

    lanes = a.k * a.n_cols * b.k
    pot = 1 << (lanes - 1).bit_length()
    info = dict(lanes=lanes, stream_pot=pot, n_buckets=plan.n_buckets,
                rows_per_bucket=rpb, largest_bucket_products=largest(prod),
                bucket_cap=plan.bucket_cap,
                bucket_lanes=plan.n_buckets * plan.bucket_cap,
                n_blocks=plan.n_blocks, largest_block_uniques=largest(uniq),
                block_cap=plan.block_cap,
                table_slots=plan.n_blocks * plan.block_cap,
                largest_block_load=largest(uniq) / plan.block_cap,
                table_load=nnz_c / (plan.n_blocks * plan.block_cap),
                tiled_tile=plan.tile,
                tiled_merge_levels=(pot // plan.tile).bit_length() - 1,
                out_cap=plan.out_cap)
    print(f"[plan] {json.dumps(info)}", flush=True)
    return plan


def check_accumulator_kernels(a, b, plan) -> list:
    """K5 (row sort), K6 (merge level) and K7 (bucket rank) against their
    plain versions at the shapes the 'tiled', 'bucket' and 'hash' paths give
    them: K5 at 4,096-lane rows over the packed stream, at ``bucket_cap``
    rows over the binned buckets and at ``block_cap`` rows over the hash
    tables; K6 at the merge tree's first and last level; K7 over every
    lane's bucket id."""
    import torch
    from repro_torch.core.sccp import sccp_multiply
    from repro_torch.kernels import bitonic_merge as bm
    from repro_torch.kernels import hash_accum as ha
    from repro_torch.kernels import ops
    from repro_torch.kernels import radix_bucket as rb

    val, row, col = sccp_multiply(a, b)
    key, v = ops._packed_stream(row, col, val, a.n_rows, b.n_cols)
    del val, row, col
    torch.cuda.empty_cache()
    n = key.numel()
    kpb = rb.bucket_bounds(a.n_rows, b.n_cols, plan.n_buckets)

    def sort_shape(what, k, w, tile):
        log = tile.bit_length() - 1
        return held_pair("sort_tiles", lambda: bm.sort_tiles(k, w, tile=tile),
                    lambda: bm.sort_tiles_plain(k, w, tile=tile),
                    lambda: torch.sort(k.view(-1, tile), dim=1),
                    f"{what}: rows of {tile} over {k.numel()}",
                    16 * k.numel(), k.numel() // 2 * log * (log + 1) // 2)

    # K5 at its three main-path shapes
    shapes = [sort_shape("tiled", key, v, plan.tile)]
    bk, bv, _ = rb.bin_stream(key, v, n_buckets=plan.n_buckets,
                              bucket_cap=plan.bucket_cap, keys_per_bucket=kpb)
    shapes.append(sort_shape("bucket", bk, bv, plan.bucket_cap))
    del bk, bv
    tk, tv, _ = ha.hash_tables(key, v, n_blocks=plan.n_blocks,
                               block_cap=plan.block_cap, keys_per_block=kpb)
    shapes.append(sort_shape("hash", tk, tv, plan.block_cap))
    del tk, tv
    torch.cuda.empty_cache()

    # K6 at the merge tree's first and last level; the whole tree's time
    def merge_level(k, w, run):
        return held_pair("merge_runs", lambda: bm.merge_runs(k, w, run=run),
                    lambda: bm.merge_runs_plain(k, w, run=run),
                    lambda: torch.sort(k.view(-1, 2 * run), dim=1),
                    f"level run={run} over {k.numel()}", 16 * k.numel(),
                    k.numel() // 2 * ((2 * run).bit_length() - 1))

    k1, t1 = bm.sort_tiles(key, v, tile=plan.tile)
    levels = [merge_level(k1, t1, plan.tile)]
    run = plan.tile
    while run < n // 2:
        k1, t1 = bm.merge_runs(k1, t1, run=run)
        run *= 2
    levels.append(merge_level(k1, t1, run))
    del k1, t1
    torch.cuda.empty_cache()
    tree_ms = cuda_ms(lambda: bm.sort_merge_tree(key, v, tile=plan.tile), 2)
    print(f"[kernel] merge tree (K5 + {(n // plan.tile).bit_length() - 1} "
          f"K6 levels) over {n}: {tree_ms:.3f} ms", flush=True)

    # K7 over every lane's bucket id
    bid = torch.where(key != ops.KEY_INVALID, key // kpb, -1).clamp(
        max=plan.n_buckets - 1).to(torch.int32)
    err = same("bin_ranks", rb.bin_ranks(bid, n_buckets=plan.n_buckets),
               rb.bin_ranks_plain(bid, n_buckets=plan.n_buckets))
    t, by = bound(8 * n, n)
    rank = dict(shape=f"({n},) ids of {plan.n_buckets} buckets",
                max_abs_err=err,
                ms=cuda_ms(lambda: rb.bin_ranks(bid, n_buckets=plan.n_buckets),
                           3),
                plain_ms=cuda_ms(lambda: rb.bin_ranks_plain(
                    bid, n_buckets=plan.n_buckets), 2),
                library_ms=None, bound_ms=t, bound_by=by)
    print(f"[kernel] bin_ranks {rank['shape']}: bit-identical, "
          f"{json.dumps(rank)}", flush=True)
    del key, v, bid
    torch.cuda.empty_cache()

    src = "src/repro_torch/csrc/bitonic_merge.cu"
    return [
        kernel_row("sort_tiles", src, "src/repro/kernels/bitonic_merge.py:151",
                   shapes),
        kernel_row("merge_runs", src, "src/repro/kernels/bitonic_merge.py:162",
                   levels, tree_ms=tree_ms),
        dict(name="bin_ranks", route="cuda",
             source="src/repro_torch/csrc/radix_bucket.cu",
             replaces="src/repro/kernels/radix_bucket.py:49", **rank),
    ]


def check_stream_kernel(a, b) -> dict:
    """K8 (fused slab multiply + sort) against its plain version at the
    shapes the 'stream' path gives it or can: one A slab times all of B (the
    planner's group of 1 on this operand), a slab of at most 4,096 lanes
    (one shared-memory residency) and a block of two slabs (group > 1)."""
    import torch
    from repro_torch.kernels import fused_sccp_stream as k8
    k_b = b.val.shape[1]
    n_small = 4096 // k_b
    cases = [
        ("one A slab x B", a.val[0], a.idx[0], b.val, b.idx),
        ("slab cut to one tile", a.val[0, :n_small].contiguous(),
         a.idx[0, :n_small].contiguous(), b.val[:n_small].contiguous(),
         b.idx[:n_small].contiguous()),
        ("group of 2 slabs", a.val[:2], a.idx[:2], b.val, b.idx),
    ]
    shapes = []
    for what, *args in cases:
        key = k8.fused_slab_sort(*args, n_cols=b.n_cols)[0]
        require(bool((key[1:] >= key[:-1]).all()),
                f"fused_slab_sort ({what}): keys not ascending")
        pot = key.numel()
        del key
        packed, _ = k8._pack_tile(*args, b.n_cols, pot)
        log = pot.bit_length() - 1
        shapes.append(held_pair(
            "fused_slab_sort",
            lambda: k8.fused_slab_sort(*args, n_cols=b.n_cols),
            lambda: k8.fused_slab_sort_plain(*args, n_cols=b.n_cols),
            lambda: torch.sort(packed),
            f"{what}: a {tuple(args[0].shape)} x b {tuple(args[2].shape)} "
            f"-> {pot} lanes",
            8 * (args[0].numel() + args[2].numel()) + 8 * pot,
            pot // 2 * log * (log + 1) // 2))
        del packed
    torch.cuda.empty_cache()
    return kernel_row("fused_slab_sort",
                      "src/repro_torch/csrc/fused_sccp_stream.cu",
                      "src/repro/kernels/fused_sccp_stream.py:58", shapes)


def check_numeric_kernels(a, b, structures, rows) -> None:
    """K1 and K3 at the warm phase's own shapes, each added to its kernel's
    row as a further shape: K1 on one slab group of A times all of B (one
    step of the 'stream' structure's numeric loop), K3 on that step's packed
    product keys against the 'stream' structure's keys, and on the 'sort'
    structure's path: every packed product key of the full stream (dead
    lanes packed as 0) against the structure's KEY_INVALID-padded keys."""
    import torch
    from repro_torch.core.spgemm import _product_keys
    from repro_torch.core.streaming import _slab_groups
    from repro_torch.kernels import sccp_multiply as k1
    by_name = {r["name"]: r for r in rows}
    grp = max(1, min(structures["stream"].plan.stream_group, a.k))
    a_val, a_idx, _ = _slab_groups(a, grp)
    args = (a_val[:grp], a_idx[:grp], b.val, b.idx)
    n, k_b = b.val.shape
    lanes = grp * n * k_b
    by_name["sccp_multiply"]["shapes"].append(held_pair(
        "sccp_multiply", lambda: k1.sccp_multiply(*args),
        lambda: k1.sccp_multiply_plain(*args), None,
        f"numeric step: ({grp},{n})x({n},{k_b})",
        8 * (grp * n + n * k_b) + 12 * lanes, lanes))
    for what, st, mul_args in (("numeric step", structures["stream"], args),
                               ("numeric", structures["sort"],
                                (a.val, a.idx, b.val, b.idx))):
        val, row, col = k1.sccp_multiply(*mul_args)
        _, pk = _product_keys(row, col, b.n_cols)
        del val, row, col
        by_name["align_keys"]["shapes"].append(align_shape(
            f"{what} ({st.plan.backend} structure): ({pk.numel()},) in "
            f"({st.key.numel()},)", pk, st.key))
        del pk
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def drive_paths(a, b, a_cut, b_cut, structures):
    """Each path with the launch counters zeroed just before and read just
    after: the six accumulators, the faithful cut, and the warm numeric
    phase on each of ``structures`` ({backend: SpgemmStructure}). Returns
    ({path: counts}, {path: (coo, seconds)})."""
    import torch
    import repro_torch
    from repro_torch import kernels
    from repro_torch.core.sccp import sccp_multiply
    from repro_torch.core.spgemm import _coo_from_slots

    def faithful():
        val, row, col = sccp_multiply(a_cut, b_cut)
        cap = max(128, -(-int(repro_torch.count_products(a_cut, b_cut))
                         // 128) * 128)
        uk, sums, nnz = kernels.ops.search_merge(
            row, col, val, a_cut.n_rows, b_cut.n_cols, out_cap=cap,
            faithful=True)
        return _coo_from_slots(uk, sums, nnz, out_cap=cap,
                               n_rows=a_cut.n_rows, n_cols=b_cut.n_cols)

    paths = {
        "sort": lambda: repro_torch.spgemm(a, b, check=True),
        "search": lambda: repro_torch.spgemm(a, b, accumulator="search",
                                             check=True),
        "search_faithful_cut": faithful,
    }
    for acc in ACCUMULATORS[2:]:
        paths[acc] = (lambda acc=acc: repro_torch.spgemm(
            a, b, accumulator=acc, check=True))
    for backend, st in structures.items():
        paths[f"numeric_{backend}"] = (lambda st=st: repro_torch.spgemm(
            a, b, structure=st, check=True))
    counts, out = {}, {}
    for name, fn in paths.items():
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        coo = fn()
        torch.cuda.synchronize()
        out[name] = (coo, time.perf_counter() - t0)
        counts[name] = kernels.launch_counts()
        print(f"[path] {name}: {out[name][1] * 1e3:.1f} ms, launches "
              f"{counts[name]}", flush=True)
    return counts, out


def stage_ms(a, b) -> dict:
    """Host-clock ms of each stage of one cold call, each synchronised: the
    symbolic out_cap pass (and the planner's, which 'bucket' and 'hash' pay
    instead), the SCCP multiply, each accumulation, and the torch parts of
    'bucket' and 'hash' before their table sort (the binning, the probe
    loop)."""
    from repro_torch.core.sccp import sccp_multiply
    from repro_torch.core.spgemm import accumulate_stream
    from repro_torch.kernels import hash_accum, ops, radix_bucket
    from repro_torch.plan.planner import make_plan
    from repro_torch.plan.symbolic import out_cap_auto

    cap, t_sym = timed_ms(lambda: out_cap_auto(a, b))
    plan, t_plan = timed_ms(lambda: make_plan(a, b, backend="bucket"))
    (val, row, col), t_mul = timed_ms(lambda: sccp_multiply(a, b))
    st = {"symbolic_out_cap": t_sym, "make_plan": t_plan,
          "sccp_multiply": t_mul}
    for acc in ACCUMULATORS:
        _, st[f"accumulate_{acc}"] = timed_ms(lambda: accumulate_stream(
            row, col, val, cap, a.n_rows, b.n_cols, backend=acc, plan=plan))
    (key, v), st["pack_stream"] = timed_ms(lambda: ops._packed_stream(
        row, col, val, a.n_rows, b.n_cols))
    del val, row, col
    kpb = radix_bucket.bucket_bounds(a.n_rows, b.n_cols, plan.n_buckets)
    _, st["bucket_bin_stream"] = timed_ms(lambda: radix_bucket.bin_stream(
        key, v, n_buckets=plan.n_buckets, bucket_cap=plan.bucket_cap,
        keys_per_bucket=kpb))
    _, st["hash_tables"] = timed_ms(lambda: hash_accum.hash_tables(
        key, v, n_blocks=plan.n_blocks, block_cap=plan.block_cap,
        keys_per_block=kpb))
    return st


def stream_stage_ms(a, b, want) -> dict:
    """Host-clock ms of one cold 'stream' call's stages, each synchronised:
    the planner, then K8 and the two halves of ``streaming.absorb_sorted``
    summed over the steps (the tile's compaction; the K6 merge with the
    compaction back to the buffer width), and the final unpack. The staged
    call's result must equal ``want`` bit for bit."""
    from repro_torch.core import streaming as st
    from repro_torch.kernels import ops
    from repro_torch.plan.planner import make_plan

    plan, t_plan = timed_ms(lambda: make_plan(a, b, backend="stream"))
    a_val, a_idx, n_groups = st._slab_groups(a, plan.stream_group)
    state = st.stream_init(st.buffer_cap(plan.out_cap), a.val.dtype,
                           a.val.device)
    buf_cap = state.key.numel()
    ms = dict(stream_make_plan=t_plan, stream_fused_slab_sort=0.0,
              stream_compact_tile=0.0, stream_merge_tile=0.0)
    for g in range(n_groups):
        sl = slice(g * plan.stream_group, (g + 1) * plan.stream_group)
        (key, tot), t = timed_ms(lambda: ops.fused_slab_sort(
            a_val[sl], a_idx[sl], b.val, b.idx, n_cols=b.n_cols))
        ms["stream_fused_slab_sort"] += t
        tile, t = timed_ms(lambda: st._compact_tile(
            key, tot, stream_cap=plan.stream_cap, buf_cap=buf_cap))
        ms["stream_compact_tile"] += t
        del key, tot
        state, t = timed_ms(lambda: st._merge_tile(state, *tile))
        ms["stream_merge_tile"] += t
        del tile
    coo, ms["stream_finalize"] = timed_ms(lambda: st.finalize(
        state, plan.out_cap, a.n_rows, b.n_cols))
    for f in ("row", "col", "val", "ngroups"):
        same(f"staged stream vs path .{f}", getattr(coo, f), getattr(want, f))
    sizes = dict(steps=n_groups, stream_group=plan.stream_group,
                 stream_cap=plan.stream_cap, buf_cap=buf_cap,
                 out_cap=plan.out_cap, merge_lanes=2 * buf_cap)
    print(f"[stream] {json.dumps(sizes)}", flush=True)
    return ms


def numeric_stage_ms(a, b, st) -> dict:
    """Host-clock ms of the warm phase's stages on a 'sort' structure
    (``spgemm._slot_sums`` step by step), each synchronised: K1, the packed
    product keys, K3, the slot sum as the path runs it (dead and missing
    lanes spread over the dump slots) and, for comparison, the same sum
    with every such lane sent to one dump slot, and over the valid lanes
    only (their selection included)."""
    import torch
    from repro_torch.core import spgemm as sp
    from repro_torch.core.sccp import sccp_multiply
    from repro_torch.kernels.insitu_search import align_keys

    ms = {}
    (val, row, col), ms["numeric_sccp_multiply"] = timed_ms(
        lambda: sccp_multiply(a, b))
    (valid, pk), ms["numeric_pack_keys"] = timed_ms(
        lambda: sp._product_keys(row, col, st.n_cols))
    del row, col
    val = torch.where(valid, val.reshape(-1), 0)
    (slot, hit), ms["numeric_align_keys"] = timed_ms(
        lambda: align_keys(pk, st.key))
    hit &= valid

    def slot_sum():
        sums = sp._slot_sums_init(st.out_cap, val.dtype, val.device)
        return sums.index_add_(0, sp._slot_index(slot, hit, st.out_cap), val)

    def one_dump_slot():
        sums = sp._slot_sums_init(st.out_cap, val.dtype, val.device)
        return sums.index_add_(0, torch.where(hit, slot, st.out_cap), val)

    def valid_sum():
        sel = torch.nonzero(hit).squeeze(1)
        sums = sp._slot_sums_init(st.out_cap, val.dtype, val.device)
        return sums.index_add_(0, slot[sel], val[sel])

    want, ms["numeric_index_add_spread_dump"] = timed_ms(slot_sum)
    for name, fn in (("numeric_index_add_one_dump_slot", one_dump_slot),
                     ("numeric_index_add_valid_lanes", valid_sum)):
        got, ms[name] = timed_ms(fn)
        same(f"slot sums ({name})", got[:st.out_cap], want[:st.out_cap])
    print(f"[numeric] {int(valid.sum())} valid of {valid.numel()} lanes",
          flush=True)
    return ms


def coo_to_scipy(coo):
    import scipy.sparse as sp
    import torch
    ok = coo.row >= 0
    r, c, v = (t[ok].cpu().numpy() for t in (coo.row, coo.col, coo.val))
    return sp.csr_matrix((v.astype(np.float64), (r, c)), shape=coo.shape)


def check_against_scipy(name: str, coo, c_ref, nnz_ref: int) -> None:
    import torch
    require(int(coo.ngroups) == nnz_ref,
            f"{name}: ngroups {int(coo.ngroups)} != nnz(C) {nnz_ref}")
    ok = coo.row >= 0
    require(int(ok.sum()) == nnz_ref, f"{name}: {int(ok.sum())} valid slots")
    key = coo.row[ok].long() * coo.shape[1] + coo.col[ok].long()
    require(bool((key[1:] > key[:-1]).all()),
            f"{name}: coordinates not strictly ascending")
    diff = coo_to_scipy(coo) - c_ref
    diff.eliminate_zeros()
    require(diff.nnz == 0, f"{name}: {diff.nnz} entries differ from scipy")


# ---------------------------------------------------------------------------
# The SpMM slice: MoE dispatch='spmm' (K9) and SparseMLP's N:M route (K10)
# ---------------------------------------------------------------------------

# a prefill batch at deepseek-v2-lite's published widths: 4 requests x 1,024
# tokens; the ELLPACK twin materializes (tokens, d_in·k) products, so it runs
# on a cut of ELL_CUT tokens
PREFILL = (4, 1024)
ELL_CUT = 8


def moe_operands(seed: int):
    """deepseek-v2-lite's MoE layer (``dispatch='spmm'`` over the config's
    ``'sort'``), its parameters and a prefill batch, float32 on the CPU.

    Tokens are multiples of 2^-3 in [-1, 1] with feature 0 fixed at 1; the
    router's rows are multiples of 2^-6 in [-2^-5, 2^-5], except row 0,
    which holds the tags e·2^-17. Every logit is then a multiple of 2^-17
    well inside float32's 24 bits, exact in any summation order, and no two
    experts of a token tie (the tags sit below the grid of the rest), so
    both devices route every token alike; ``route_exactly`` checks it. The
    expert weights are normal draws over sqrt(fan_in)."""
    import torch
    from repro_torch.configs import deepseek_v2_lite
    base = deepseek_v2_lite.CONFIG
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, dispatch="spmm"))
    m = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_ff_expert
    rng = np.random.default_rng(seed)

    def lin(*shape):
        w = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(w / np.float32(math.sqrt(shape[-2])))

    router = rng.integers(-2, 3, (d, e)).astype(np.float32) / 64
    router[0] = np.arange(e, dtype=np.float32) * np.float32(2.0 ** -17)
    p = {"router": torch.from_numpy(router), "w_gate": lin(e, d, f),
         "w_up": lin(e, d, f), "w_down": lin(e, f, d)}
    fs = m.n_shared * f
    p["shared"] = {"w_gate": lin(d, fs), "w_up": lin(d, fs),
                   "w_down": lin(fs, d)}
    x = rng.integers(-8, 9, (*PREFILL, d)).astype(np.float32) / 8
    x[..., 0] = 1.0
    return cfg, p, torch.from_numpy(x)


def route_exactly(x, router) -> None:
    """Require float32 logits equal to float64 ones and distinct in every
    token, on the operand's device."""
    import torch
    x2 = x.reshape(-1, x.shape[-1])
    l64 = x2.double().cpu() @ router.double().cpu()
    require(torch.equal((x2 @ router).double().cpu(), l64),
            f"router logits on {x.device} are not exact")
    srt = l64.sort(dim=-1).values
    require(bool((srt[:, 1:] > srt[:, :-1]).all()), "router logits tie")


def int_tensor(rng, shape, dev):
    import torch
    return torch.from_numpy(rng.integers(-4, 5, shape).astype(np.float32)) \
        .to(dev)


def sparse_rows(val, idx, n_rows: int):
    """A of row-wise ELLPACK planes as a torch CSR tensor (the library
    call's operand; built outside its timing)."""
    import torch
    s, c = torch.nonzero(idx >= 0, as_tuple=True)
    with warnings.catch_warnings():        # torch's beta-state notices
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_coo_tensor(torch.stack([idx[s, c].long(), c]),
                                    val[s, c], (n_rows, val.shape[1]))
        return a.coalesce().to_sparse_csr()


def check_spmm_kernels(cfg, p, x, mlp, x_int, h_int, seed: int) -> list:
    """K9 at the MoE path's dispatch and combine shapes and K10 at
    SparseMLP's fc_in and fc_out shapes, each held bit for bit against its
    plain twin on integer-valued operands (|partial sums| < 2^24, so every
    order of the atomics and of the products gives the same bits). K9's
    planes are the routing's own (dispatch: value 1 on each kept pair;
    combine: the slot → token index with integer values in place of the
    routing weights); its library call is ``torch.sparse.mm`` of A as a CSR
    tensor, and its bound reads X only at the columns of A with a valid
    lane. K10's is ``x @ wp``, the dense product of the pruned weight,
    TF32 off; each K10 entry also holds ``broadcast_ms``, the probe build
    of its source with the gather taken out (a wrong result, not checked),
    which times the loop with no bank conflicts."""
    import torch
    from repro_torch.kernels import ell_spmm as k9
    from repro_torch.kernels import nm_spmm as k10
    from repro_torch.models import ffn
    dev = x.device
    rng = np.random.default_rng(seed + 1)
    t, d = x.shape[0] * x.shape[1], cfg.d_model
    logits = x.reshape(1, t, d) @ p["router"]
    w, _, _, kept, slot = ffn._spmm_route(logits, cfg)
    n_slots = cfg.moe.n_experts * ffn.moe_capacity(t, cfg)
    disp = ffn.dispatch_planes(kept[0], slot[0], n_slots, torch.float32)
    comb = ffn.combine_planes(kept[0], slot[0], w[0], n_slots, torch.float32)
    comb_val = torch.where(comb.idx >= 0, int_tensor(rng, comb.val.shape,
                                                     dev), 0.0)
    ell = []
    for what, val, idx, xx, n_rows in (
            ("dispatch", disp.val, disp.idx, int_tensor(rng, (t, d), dev),
             n_slots),
            ("combine", comb_val, comb.idx, int_tensor(rng, (n_slots, d),
                                                       dev), t)):
        k, n = val.shape
        valid = (idx >= 0) & (idx < n_rows)
        n_used = int(valid.any(0).sum())       # columns whose X row is read
        a_csr = sparse_rows(val, idx, n_rows)
        ell.append(held_pair(
            "ell_spmm", lambda: k9.ell_spmm(val, idx, xx, n_rows),
            lambda: k9.ell_spmm_plain(val, idx, xx, n_rows),
            lambda: torch.sparse.mm(a_csr, xx),
            f"{what}: ({k},{n}) x ({n},{d}) -> ({n_rows},{d}), "
            f"{int(valid.sum())} valid lanes in {n_used} columns",
            8 * k * n + 4 * n_used * d + 4 * n_rows * d,
            2 * int(valid.sum()) * d))
        del a_csr, xx
    nm = []
    for what, layer, xx in (("fc_in", mlp.fc_in, x_int),
                            ("fc_out", mlp.fc_out, h_int)):
        wn = layer.w_nm
        wp = wn.to_dense()
        nm.append(held_pair(
            "nm_spmm", lambda: k10.nm_spmm(xx, wn.val, wn.off, n=wn.n,
                                           m=wn.m),
            lambda: k10.nm_spmm_plain(xx, wn.val, wn.off, n=wn.n, m=wn.m),
            lambda: xx @ wp,
            f"{what}: ({t},{wn.d_in}) x {wn.n}:{wn.m} ({wn.r},{wn.d_out})",
            4 * t * wn.d_in + 5 * wn.r * wn.d_out + 4 * t * wn.d_out,
            2 * t * wn.r * wn.d_out))
        nm[-1]["broadcast_ms"] = cuda_ms(lambda: k10.launch(
            "nm_spmm_broadcast", xx, wn.val, wn.off, n=wn.n, m=wn.m), 3)
        print(f"[probe] nm_spmm {what} with no gather (broadcast reads): "
              f"{nm[-1]['broadcast_ms']:.4f} ms, as built "
              f"{nm[-1]['ms']:.4f} ms", flush=True)
        del wp
    torch.cuda.empty_cache()
    return [kernel_row("ell_spmm", "src/repro_torch/csrc/ell_spmm.cu",
                       "src/repro/kernels/ell_spmm.py:33", ell),
            kernel_row("nm_spmm", "src/repro_torch/csrc/nm_spmm.cu",
                       "src/repro/kernels/nm_spmm.py:41", nm)]


def peak_of(fn):
    """Run ``fn`` once; its result, the device's peak memory during the
    call, and what the call added above the memory allocated before it."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    top = torch.cuda.max_memory_allocated()
    return out, dict(peak_gib=top / 2**30, call_gib=(top - base) / 2**30)


def drive_spmm_paths(paths: dict):
    """Each SpMM path once, with the launch counters zeroed just before and
    read just after. Returns ({path: counts}, {path: result},
    {path: (ms, peak)})."""
    import torch
    from repro_torch import kernels
    counts, out, cost = {}, {}, {}
    for name, fn in paths.items():
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res, peak = peak_of(fn)
        ms = (time.perf_counter() - t0) * 1e3
        counts[name] = kernels.launch_counts()
        out[name], cost[name] = res, (ms, peak)
        print(f"[path] {name}: {ms:.1f} ms, peak {json.dumps(peak)}, "
              f"launches {counts[name]}", flush=True)
    return counts, out, cost



def spmm_stage_ms(cfg, p, x, mlp, x_int) -> dict:
    """Host-clock ms of one ``moe_apply`` call's stages, each synchronised
    (``models.ffn._moe_spmm`` step by step: router product and routing,
    K9 dispatch, the three expert ``bmm``s with the SiLU, the combine
    planes, K9 combine, the shared SwiGLU), and of one ``SparseMLP`` call's
    (K10, GELU, K10)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import ffn
    t, d = x.shape[0] * x.shape[1], cfg.d_model
    e = cfg.moe.n_experts
    cap = ffn.moe_capacity(t, cfg)
    x_grp = x.reshape(1, t, d)
    ms = {}
    (w, _, _, kept, slot), ms["moe_router_and_routing"] = timed_ms(
        lambda: ffn._spmm_route(x_grp @ p["router"], cfg))
    disp, ms["moe_dispatch_planes"] = timed_ms(
        lambda: ffn.dispatch_planes(kept[0], slot[0], e * cap, x.dtype))
    xe, ms["moe_k9_dispatch"] = timed_ms(
        lambda: ffn._spmm_ell_auto(disp, x_grp[0]).reshape(e, cap, d))

    def experts():
        h = torch.bmm(xe, p["w_gate"])
        u = torch.bmm(xe, p["w_up"])
        return torch.bmm(F.silu(h) * u, p["w_down"]).reshape(e * cap, d)

    ye, ms["moe_expert_bmm"] = timed_ms(experts)
    comb, ms["moe_combine_planes"] = timed_ms(
        lambda: ffn.combine_planes(kept[0], slot[0], w[0], e * cap, x.dtype))
    _, ms["moe_k9_combine"] = timed_ms(lambda: ffn._spmm_ell_auto(comb, ye))
    _, ms["moe_shared_swiglu"] = timed_ms(
        lambda: ffn.swiglu_apply(p["shared"], x_grp, x.dtype))
    h, ms["mlp_k10_fc_in"] = timed_ms(lambda: mlp.fc_in(x_int))
    g, ms["mlp_gelu"] = timed_ms(lambda: F.gelu(h, approximate="tanh"))
    _, ms["mlp_k10_fc_out"] = timed_ms(lambda: mlp.fc_out(g))
    return ms


def spmm_slice(seed: int):
    """The SpMM slice end to end: returns (kernel rows, {path: counts},
    the e2e summary). See the module docstring, phases 5-6."""
    import torch
    import repro_torch
    from repro_torch import kernels
    from repro_torch.core.formats import params_from_numpy
    from repro_torch.models import sparse as sl
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False    # full float32 products
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg, p_cpu, x_cpu = moe_operands(seed)
    p = params_from_numpy(p_cpu, device=dev)
    x = x_cpu.to(dev)
    route_exactly(x_cpu, p_cpu["router"])
    route_exactly(x, p["router"])
    d, f = cfg.d_model, cfg.d_ff
    t = PREFILL[0] * PREFILL[1]
    rng = np.random.default_rng(seed + 2)
    w_in, w_out = int_tensor(rng, (d, f), dev), int_tensor(rng, (f, d), dev)
    mlp = repro_torch.SparseMLP(w_in, w_out, 0.5, nm=(2, 4))
    x_int, h_int = int_tensor(rng, (t, d), dev), int_tensor(rng, (t, f), dev)
    w_auto = torch.from_numpy(rng.standard_normal((d, f), dtype=np.float32)
                              ).to(dev)
    lin_auto = repro_torch.SparseLinear(w_auto, 0.9, nm="auto")
    a_dense = int_tensor(rng, (64, d), dev) \
        * (torch.rand((64, d), device=dev) < 0.05)
    a_act = repro_torch.ell_rows_from_dense(
        a_dense, int((a_dense != 0).sum(0).max()), device=dev)
    torch.cuda.synchronize()
    print(f"[spmm] deepseek-v2-lite MoE E={cfg.moe.n_experts} "
          f"top-{cfg.moe.top_k} d_ff_expert={cfg.moe.d_ff_expert} "
          f"shared={cfg.moe.n_shared} T={t}; SparseMLP {d}->{f}->{d} 2:4 "
          f"(ELL twin k {mlp.fc_in.w_ell.k}/{mlp.fc_out.w_ell.k}); "
          f"90% SparseLinear k {lin_auto.w_ell.k}; set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 5: K9 and K10 against their plain twins ------------------------
    rows = check_spmm_kernels(cfg, p, x, mlp, x_int, h_int, seed)

    # -- phase 6: the paths, counters zeroed around each -----------------------
    x_cut, h_cut = x_int[:ELL_CUT], h_int[:ELL_CUT]
    paths = {
        "moe_spmm": lambda: repro_torch.moe_apply(p, x, cfg, torch.float32),
        "sparse_mlp": lambda: mlp(x_int),
        "sparse_linear_ellpack_cut": lambda: (
            sl.sparse_linear_apply(x_cut, mlp.fc_in.w_ell),
            sl.sparse_linear_apply(h_cut, mlp.fc_out.w_ell)),
        "sparse_linear_auto_cut": lambda: lin_auto(x_cut),
        "matmul_sparse_miss": lambda: lin_auto.matmul_sparse(
            a_act, backend="sort"),
        "matmul_sparse_hit": lambda: lin_auto.matmul_sparse(
            a_act, backend="sort"),
    }
    counts, out, cost = drive_spmm_paths(paths)
    require(counts["moe_spmm"]["ell_spmm"] == 2,
            f"moe path launched K9 {counts['moe_spmm']['ell_spmm']} times")
    require(counts["sparse_mlp"]["nm_spmm"] == 2,
            f"SparseMLP launched K10 {counts['sparse_mlp']['nm_spmm']} times")
    for name in ("matmul_sparse_miss", "matmul_sparse_hit"):
        for kname in ("sccp_multiply", "align_keys"):
            require(counts[name][kname] > 0, f"{name} skipped {kname}")

    # MoE: the same call on CPU tensors (the plain twins), same routing
    y, aux = out["moe_spmm"]
    require(y.shape == x.shape and bool(torch.isfinite(y).all()),
            "moe output not finite or misshapen")
    t_cpu = time.perf_counter()
    y_cpu, aux_cpu = repro_torch.moe_apply(p_cpu, x_cpu, cfg, torch.float32)
    t_cpu = time.perf_counter() - t_cpu
    from repro_torch.models import ffn
    r_dev = ffn._spmm_route(x.reshape(1, t, d) @ p["router"], cfg)
    r_cpu = ffn._spmm_route(x_cpu.reshape(1, t, d) @ p_cpu["router"], cfg)
    for i, name in ((1, "ids"), (3, "kept"), (4, "slot")):
        require(r_dev[i].is_cuda, f"moe routing {name} not on the card")
        same(f"moe routing {name}, card vs CPU", r_dev[i].cpu(), r_cpu[i])
    moe_err = float((y.cpu() - y_cpu).abs().max())
    moe_tol = 1e-4 * float(y_cpu.abs().max())
    require(moe_err <= moe_tol, f"moe y off by {moe_err} > {moe_tol}")
    aux_err = abs(float(aux) - float(aux_cpu))
    require(aux_err <= 1e-5 * abs(float(aux_cpu)), f"moe aux off by {aux_err}")
    print(f"[check] moe_apply card == CPU routing (ids, kept, slots; "
          f"{int(r_cpu[3].sum())} of {r_cpu[3].numel()} pairs kept), y "
          f"max|diff| {moe_err:.3e} <= 1e-4·max|y| = {moe_tol:.3e}, aux "
          f"{float(aux):.6f} vs {float(aux_cpu):.6f}; CPU call "
          f"{t_cpu:.1f} s", flush=True)
    del y_cpu, aux_cpu, p_cpu

    # SparseMLP: each layer equals the dense product of its pruned weight
    wp_in, wp_out = mlp.fc_in.w_nm.to_dense(), mlp.fc_out.w_nm.to_dense()
    same("SparseMLP fc_in vs x @ wp", mlp.fc_in(x_int), x_int @ wp_in)
    same("SparseMLP fc_out vs h @ wp", mlp.fc_out(h_int), h_int @ wp_out)
    ym = out["sparse_mlp"]
    require(ym.shape == (t, d) and bool(torch.isfinite(ym).all()),
            "SparseMLP output not finite or misshapen")
    want = mlp.fc_out(torch.nn.functional.gelu(x_int @ wp_in,
                                               approximate="tanh"))
    same("SparseMLP vs fc_out(gelu(x @ wp))", ym, want)
    # the ELLPACK twin equals the N:M route on the cut
    e_in, e_out = out["sparse_linear_ellpack_cut"]
    same("ELLPACK twin fc_in", e_in, mlp.fc_in(x_cut))
    same("ELLPACK twin fc_out", e_out, mlp.fc_out(h_cut))
    print(f"[check] SparseMLP layers == x @ wp bit for bit (TF32 off); "
          f"ELLPACK twin == N:M route on {ELL_CUT} tokens", flush=True)
    del wp_in, wp_out, want
    # 'auto' at a 90% global prune routes to ELLPACK
    require(lin_auto.w_nm is None, "90% global prune routed to N:M")
    ya = out["sparse_linear_auto_cut"]
    ref = x_cut @ lin_auto.w_ell.to_dense()
    auto_err = float((ya - ref).abs().max())
    require(auto_err <= 1e-5 * float(ref.abs().max()),
            f"auto ELLPACK apply off by {auto_err}")
    # matmul_sparse: a miss then a hit, both equal to the dense product
    st = lin_auto.cache.stats()
    require(st["misses"] == 1 and st["hits"] == 1, f"cache stats {st}")
    c_ref = a_dense @ lin_auto.w_ell.to_dense()
    for name in ("matmul_sparse_miss", "matmul_sparse_hit"):
        coo = out[name]
        require(not bool(coo.overflowed()), f"{name} overflowed")
        err = float((coo.to_dense() - c_ref).abs().max())
        require(err <= 1e-5 * float(c_ref.abs().max()),
                f"{name} off the dense product by {err}")
    # same coordinates; the values are float sums whose slot index_add_
    # lands in a different order each call
    hit, miss = out["matmul_sparse_hit"], out["matmul_sparse_miss"]
    for f_ in ("row", "col", "ngroups"):
        same(f"matmul_sparse hit vs miss .{f_}", getattr(hit, f_),
             getattr(miss, f_))
    require(float((hit.val - miss.val).abs().max())
            <= 1e-5 * float(miss.val.abs().max()),
            "matmul_sparse hit vs miss values differ")
    print(f"[check] 'auto' at 90% -> ELLPACK (k {lin_auto.w_ell.k}), max|diff| "
          f"{auto_err:.3e}; matmul_sparse miss then hit {st}, "
          f"{int(out['matmul_sparse_hit'].ngroups)} groups", flush=True)
    del out

    # -- e2e: three timed calls each, K9 / K10 twice a call --------------------
    e2e = {}
    for name, kname in (("moe_spmm", "ell_spmm"), ("sparse_mlp", "nm_spmm")):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t1 = time.perf_counter()
            paths[name]()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            n = kernels.launch_counts()[kname]
            require(n == 2, f"{name} launched {kname} {n} times")
        e2e[name] = times
    summary = {"spmm_e2e_ms": e2e,
               "spmm_stage_ms": spmm_stage_ms(cfg, p, x, mlp, x_int),
               "spmm_path_ms": {k: v[0] for k, v in cost.items()},
               "spmm_peak_mem_per_call": {k: v[1] for k, v in cost.items()},
               "moe_max_abs_err_vs_cpu": moe_err}
    return rows, counts, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the operand's integer values")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on "
              "a GPU and has nothing to run here", file=sys.stderr)
        return 2
    if not (REPO / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO / 'src' / 'repro_torch'} not found; run "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    import scipy
    import repro_torch
    from repro_torch.core.formats import (from_numpy, np_ell_cols_from_scipy,
                                          np_ell_rows_from_scipy)
    from repro_torch.kernels import _build

    # -- phase 1: the card and the build --------------------------------------
    card = gpu_line()
    print(f"[gpu] {card}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} scipy {scipy.__version__} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    build_s = _build.build_all()
    print(f"[build] kernels built in {build_s:.2f} s", flush=True)
    for src in sorted(_build.SRC_DIR.glob("*.cu")):
        for line in _build.build_log(src.stem).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {src.stem}: {line.strip()}", flush=True)

    # -- the operand: bcsstk32, C = A·Aᵀ ----------------------------------------
    t0 = time.perf_counter()
    A = table1_matrix(BCSSTK32, args.seed)
    A_csc = A.tocsc()
    k = int(np.diff(A_csc.indptr).max())          # lossless ELLPACK width
    dev = torch.device("cuda")
    a = from_numpy(*np_ell_rows_from_scipy(A_csc, k), n_rows=A.shape[0],
                   device=dev)
    b = from_numpy(*np_ell_cols_from_scipy(A.T.tocsr(), k), n_cols=A.shape[0],
                   device=dev)
    A64 = A.astype(np.float64)
    c_ref = (A64 @ A64.T).tocsr()
    pattern = A64.copy()
    pattern.data[:] = 1.0
    nnz_c = int((pattern @ pattern.T).nnz)
    products = int(repro_torch.count_products(a, b))
    print(f"[operand] {BCSSTK32[1]}: dim {A.shape[0]} nnz {A.nnz} k {k} "
          f"lanes {k * A.shape[0] * k} products {products} nnz(C) {nnz_c} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    # one column of the contraction: A[:, c]·A[:, c]ᵀ has nnz_c² coordinates
    cut = int(np.argmin(np.abs(np.diff(A_csc.indptr) - 20)))
    A_cut = A_csc[:, [cut]]
    a_cut = from_numpy(*np_ell_rows_from_scipy(A_cut, k), n_rows=A.shape[0],
                       device=dev)
    b_cut = from_numpy(*np_ell_cols_from_scipy(A_cut.T.tocsr(), k),
                       n_cols=A.shape[0], device=dev)

    # -- phase 2: kernels against their plain versions ------------------------
    rows = check_kernels(a, b, a_cut, b_cut)
    plan = plan_sizes(a, b, nnz_c)
    rows += check_accumulator_kernels(a, b, plan)
    rows.append(check_stream_kernel(a, b))

    # -- the warm phase's structures (symbolic, once) --------------------------
    structures, build_ms = {}, {}
    for backend in ("sort", "stream"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        structures[backend] = repro_torch.make_structure(a, b,
                                                         backend=backend)
        torch.cuda.synchronize()
        build_ms[backend] = (time.perf_counter() - t0) * 1e3
        require(int(structures[backend].nnz) == nnz_c,
                f"structure({backend}) nnz {int(structures[backend].nnz)}")
    print(f"[structure] make_structure ms {json.dumps(build_ms)}", flush=True)
    check_numeric_kernels(a, b, structures, rows)

    # -- phase 3: the main path -------------------------------------------------
    counts, out = drive_paths(a, b, a_cut, b_cut, structures)
    require(counts["sort"]["sccp_multiply"] > 0, "sort path skipped K1")
    for kname in ("sccp_multiply", "emit_sort", "align_keys"):
        require(counts["search"][kname] > 0, f"search path skipped {kname}")
    require(counts["search_faithful_cut"]["minima_mask"] > 0,
            "faithful path skipped minima_mask")
    for acc, kernels_run in (("tiled", ("sccp_multiply", "sort_tiles",
                                        "merge_runs")),
                             ("bucket", ("sccp_multiply", "bin_ranks",
                                         "sort_tiles")),
                             ("hash", ("sccp_multiply", "sort_tiles")),
                             ("stream", ("fused_slab_sort", "merge_runs")),
                             ("numeric_sort", ("sccp_multiply",
                                               "align_keys")),
                             ("numeric_stream", ("sccp_multiply",
                                                 "align_keys"))):
        for kname in kernels_run:
            require(counts[acc][kname] > 0, f"{acc} path skipped {kname}")
    c_sort = out["sort"][0]
    check_against_scipy("sort", c_sort, c_ref, nnz_c)
    others = ACCUMULATORS[1:] + tuple(f"numeric_{s}" for s in structures)
    for acc in others:
        for f in ("row", "col", "val", "ngroups"):
            same(f"sort vs {acc} .{f}", getattr(out[acc][0], f),
                 getattr(c_sort, f))
    print(f"[check] sort == scipy A @ A.T, ngroups {nnz_c} == nnz(C); "
          f"{', '.join(others)} == sort bit for bit (row, col, val, "
          "ngroups)", flush=True)
    require(counts["stream"]["sccp_multiply"] == 0,
            "stream path materialized the product stream through K1")
    stream_ms = stream_stage_ms(a, b, out["stream"][0])
    # a stale structure (one product moved to a row its column lacks) with
    # validate=False must poison ngroups
    st = structures["sort"]
    idx = a.idx.clone()
    s0, c0 = (int(x) for x in torch.nonzero(idx >= 0)[0])
    free = np.setdiff1d(np.arange(a.n_rows), idx[:, c0].cpu().numpy())
    idx[s0, c0] = int(free[0])
    a_stale = repro_torch.EllRows(val=a.val, idx=idx, n_rows=a.n_rows)
    stale = repro_torch.spgemm(a_stale, b, structure=st, validate=False)
    require(int(stale.ngroups) > st.out_cap,
            f"stale structure not poisoned: ngroups {int(stale.ngroups)}")
    print(f"[check] stale structure (validate=False): ngroups "
          f"{int(stale.ngroups)} > out_cap {st.out_cap}", flush=True)
    del stale, a_stale, idx
    c_f = out["search_faithful_cut"][0]
    A_cut64 = A_cut.astype(np.float64)
    cut_ref = (A_cut64 @ A_cut64.T).tocsr()
    check_against_scipy("faithful cut", c_f, cut_ref,
                        int(np.diff(A_csc.indptr)[cut]) ** 2)
    c_fb = repro_torch.spgemm(a_cut, b_cut, accumulator="search",
                              out_cap=c_f.cap)
    for f in ("row", "col", "val", "ngroups"):
        same(f"faithful vs batched .{f}", getattr(c_f, f), getattr(c_fb, f))
    print(f"[check] faithful cut (column {cut}): == batched search, == scipy",
          flush=True)
    del out, c_sort, c_f, c_fb
    torch.cuda.empty_cache()

    # -- end-to-end times, three more calls each; the first one's peak --------
    # device memory (reset just before it), and what the call itself added
    # on top of the resident operands and structures. With out_cap="auto"
    # every cold call's peak includes its symbolic pass; a call given its
    # backend's plan ("planned") shows the accumulation's own footprint.
    from repro_torch.plan.planner import make_plan
    plans = {acc: make_plan(a, b, backend=acc) for acc in ACCUMULATORS}
    calls = {acc: (lambda acc=acc: repro_torch.spgemm(a, b, accumulator=acc))
             for acc in ACCUMULATORS}
    for backend, st in structures.items():
        calls[f"numeric_{backend}"] = (
            lambda st=st: repro_torch.spgemm(a, b, structure=st))
    e2e, peak, planned_peak = {}, {}, {}
    for name, fn in calls.items():
        peak[name] = peak_of(fn)[1]
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        e2e[name] = times
    for acc, p in plans.items():
        planned_peak[acc] = peak_of(
            lambda: repro_torch.spgemm(a, b, plan=p))[1]
    print(json.dumps({"e2e_ms": e2e, "peak_mem_per_call": peak,
                      "peak_mem_per_planned_call": planned_peak,
                      "make_structure_ms": build_ms,
                      "stage_ms": {**stage_ms(a, b), **stream_ms,
                                   **numeric_stage_ms(a, b,
                                                      structures["sort"])},
                      "operand": BCSSTK32[1], "nnz_c": nnz_c}), flush=True)

    # -- phases 5-6: the SpMM slice ---------------------------------------------
    spmm_rows, spmm_counts, spmm_summary = spmm_slice(args.seed)
    rows += spmm_rows
    counts.update(spmm_counts)
    print(json.dumps(spmm_summary), flush=True)

    # -- phase 7: the kernels line and the result ------------------------------
    for r in rows:
        r["launches"] = sum(c[r["name"]] for c in counts.values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "shapes", "tree_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows]}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
