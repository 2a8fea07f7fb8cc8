"""The kernels' roofline share charges each profiled call or request only
the kernel wrappers that it launched itself."""
import pytest
import torch

from portbench import bench, devtrace, drive, roofline

PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flop_per_s": 67e12}
STATS = {0: {"nnz_a": 1000, "nnz_b": 2000, "products": 50_000,
             "nnz_c": 40_000},
         1: {"nnz_a": 900, "nnz_b": 1800, "products": 30_000,
             "nnz_c": 20_000}}


def test_the_window_hands_out_what_ran_since_its_last_call():
    counts = {"sccp_multiply": 0, "align_keys": 0, "align_product_keys": 0}
    w = devtrace.Window(False, 10.0, lambda: dict(counts))
    assert w.launched() == frozenset()          # not profiling
    w.state, w._seen = "on", dict(counts)
    counts["sccp_multiply"] += 1
    counts["align_keys"] += 45
    assert w.launched() == {"sccp_multiply", "align_keys"}
    counts["sccp_multiply"] += 1
    counts["align_product_keys"] += 1
    assert w.launched() == {"sccp_multiply", "align_product_keys"}
    assert w.launched() == frozenset()


def test_two_patterns_on_two_paths_are_each_charged_their_own():
    need = bench.find().counts()
    flat = frozenset({"sccp_multiply", "align_keys"})
    grouped = frozenset({"sccp_multiply", "align_product_keys"})
    units = [{"pattern": 0, "launched": flat},
             {"pattern": 1, "launched": grouped},
             {"pattern": 1, "launched": grouped}]
    rec = {"product_stats": STATS, "counts": need, "peaks": PEAKS,
           "profile": {"port_kernel_s": 0.01, "units": units}}

    def least(unit):
        return sum(roofline.least_s(*need[w](STATS[unit["pattern"]]), PEAKS)
                   for w in unit["launched"])

    want = 100.0 * sum(least(u) for u in units) / 0.01
    assert roofline.kernels_pct(rec) == pytest.approx(want, rel=1e-12)
    # charging every wrapper that ran anywhere to every unit reads higher
    every = flat | grouped
    over = 100.0 * sum(least(dict(u, launched=every)) for u in units) / 0.01
    assert roofline.kernels_pct(rec) < over
    # a unit that launched none of the counted wrappers adds nothing
    rec["profile"]["units"].append({"pattern": 0, "launched": frozenset()})
    assert roofline.kernels_pct(rec) == pytest.approx(want, rel=1e-12)


class _AlwaysOn(devtrace.Window):
    """A window that counts from the start without a profiler; each flush
    or call bumps a wrapper of its own, so each unit's set names it."""

    def __init__(self):
        self.n = 0
        super().__init__(False, 1.0, lambda: {f"call{i}": 1
                                              for i in range(self.n)})
        self.state, self._seen = "on", {}

    def tick(self, t):
        pass

    def launched(self):
        self.n += 1
        return super().launched()

    def stop(self):
        self.state = "done"


@pytest.mark.parametrize("cell", ["tiny.cold", "tiny.serve"])
def test_each_unit_carries_only_its_own_call_or_flush(tiny_root, cell):
    b = bench.Bench(tiny_root)
    w = b.cell(cell)
    mix = b.mix(w["traffic"])
    drv = drive.KINDS[mix["kind"]](b.config(w["config"]), mix, 3,
                                   torch.device("cpu"))
    drv.setup()
    win = _AlwaysOn()
    drv.window(1.0, win)
    assert win.units and all(len(u["launched"]) == 1 for u in win.units)
    flushes = {next(iter(u["launched"])) for u in win.units}
    assert len(flushes) == win.n            # one launched() a call or flush
    if mix["kind"] == "cold":
        assert len(win.units) == win.n
