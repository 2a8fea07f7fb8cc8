"""Hand-written Hopper kernels of the port, each beside its plain torch twin.

  sccp_multiply — structured slab-pair multiply (paper Fig. 8)
  insitu_search — the paper's Alg. 1 / Fig. 11: emission sort, alignment
                  search, bit-serial minima scan
  ops           — stream packing and the 'search' accumulation
  _build        — nvcc build of ``csrc/*.cu`` into ctypes libraries

``launch_counts`` reads, and ``reset_launch_counts`` zeroes, the launch
counter of every kernel wrapper; a wrapper counts only real kernel launches,
never its plain twin.
"""
from . import insitu_search, ops, sccp_multiply

WRAPPERS = {
    "sccp_multiply": sccp_multiply.sccp_multiply,
    "emit_sort": insitu_search.emit_sort_keys,
    "align_keys": insitu_search.align_keys,
    "minima_mask": insitu_search.minima_mask,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = ["WRAPPERS", "insitu_search", "launch_counts", "ops",
           "reset_launch_counts", "sccp_multiply"]
