"""K6, the merge-path merge: every valid product's key and value read once
and written once (16 B)."""


def need(s):
    return 16 * s["products"], 0
