"""K7, the binning (``bin_stream``, ``bin_ranks``): every valid product's key and value read once
and written once (16 B)."""


def need(s):
    return 16 * s["products"], 0
