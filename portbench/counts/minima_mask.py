"""K4, the bit-serial minima: every valid product's key read once (4 B)."""


def need(s):
    return 4 * s["products"], 0
