"""Hand-written Hopper kernels of the port, each beside its plain torch twin.

  sccp_multiply — structured slab-pair multiply (paper Fig. 8)
  insitu_search — the paper's Alg. 1 / Fig. 11: emission sort, alignment
                  search, bit-serial minima scan
  bitonic_merge — the (key, value) row sort and merge-tree level with
                  run-tail totals ('tiled', the bucket/table sort, the
                  streaming engine's merge)
  radix_bucket  — stable binning ranks and propagation blocking ('bucket')
  fused_sccp_stream — one streaming step: multiply + sort + run totals
                  fused ('stream')
  hash_accum    — open-addressing tables, probed in torch ('hash')
  ell_spmm      — ELLPACK-rows × dense SpMM by vector atomics (MoE
                  'spmm' dispatch and combine)
  nm_spmm       — N:M-condensed SpMM, nmSPARSE's conflict-free shared
                  tiles (SparseLinear's N:M route)
  ops           — stream packing and the packed-key accumulations
  _build        — nvcc build of ``csrc/*.cu`` into ctypes libraries

``launch_counts`` reads, and ``reset_launch_counts`` zeroes, the launch
counter of every kernel wrapper; a wrapper counts only real kernel launches
(one per grid), never its plain twin.
"""
from . import (bitonic_merge, ell_spmm, fused_sccp_stream, hash_accum,
               insitu_search, nm_spmm, ops, radix_bucket, sccp_multiply)

WRAPPERS = {
    "sccp_multiply": sccp_multiply.sccp_multiply,
    "emit_sort": insitu_search.emit_sort_keys,
    "align_keys": insitu_search.align_keys,
    "minima_mask": insitu_search.minima_mask,
    "sort_tiles": bitonic_merge.sort_tiles,
    "merge_runs": bitonic_merge.merge_runs,
    "bin_ranks": radix_bucket.bin_ranks,
    "fused_slab_sort": fused_sccp_stream.fused_slab_sort,
    "ell_spmm": ell_spmm.ell_spmm,
    "nm_spmm": nm_spmm.nm_spmm,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = ["WRAPPERS", "bitonic_merge", "ell_spmm", "fused_sccp_stream",
           "hash_accum", "insitu_search", "launch_counts", "nm_spmm", "ops",
           "radix_bucket", "reset_launch_counts", "sccp_multiply"]
