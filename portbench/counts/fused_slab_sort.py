"""K8, the streaming step (multiply fused into the sort): A's and B's
non-zeros read once (8 B each), every valid product written once as a
sorted key and value (8 B); one multiply a product."""


def need(s):
    return 8 * (s["nnz_a"] + s["nnz_b"]) + 8 * s["products"], s["products"]
