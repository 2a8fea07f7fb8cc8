"""K1, the structured multiply: A's and B's non-zeros read once (a value
and an index, 8 B each), every valid product written once as a packed key
and a value (8 B); one multiply a product."""


def need(s):
    return 8 * (s["nnz_a"] + s["nnz_b"]) + 8 * s["products"], s["products"]
