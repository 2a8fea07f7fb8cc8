"""Useful GFLOP/s: 2 a valid scalar product of every product completed in
the window, over the window's seconds (its start to the end of its last
product)."""


def read(rec):
    if rec["window_s"] <= 0:
        return None
    return rec["work_flop"] / rec["window_s"] / 1e9
