"""A throwaway cell of each kind, run on the card for a short window with
the profiler on: correct, and the device trace read."""
import time

import pytest

from portbench import bench, run


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.cold", "tiny.serve"])
def test_a_cell_runs_on_the_card(tiny_root, card, cell):
    b = bench.Bench(tiny_root)
    out, rec = run.run(b, cell, 2 ** 32 + 1, 2.0, True, card,
                       time.perf_counter())
    assert out["correct"] and out["checked"] > 0
    assert rec["profile"] and rec["profile"]["busy_s"] > 0
    units = rec["profile"]["units"]
    assert units and any("sccp_multiply" in u["launched"] for u in units)
    assert rec["peak_bytes"] > 0
