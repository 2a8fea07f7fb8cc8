"""K3 flat: each product's key read (4 B) and its slot in C written (4 B),
C's unique keys read once (4 B)."""


def need(s):
    return 8 * s["products"] + 4 * s["nnz_c"], 0
