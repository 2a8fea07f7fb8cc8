"""``torch.cuda.max_memory_allocated`` over the window (reset as it opens),
in GiB: resident operands, the structure cache, the program's working set,
and the sampled results held for the check."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30 if rec["peak_bytes"] else None
