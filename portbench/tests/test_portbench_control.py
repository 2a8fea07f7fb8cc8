"""The comparison that decides ``correct`` fails what it has to fail: the
control (the reference in bfloat16 in the program's place) on three seeds,
and a whole run with the timed path broken underneath, once for each fault
a cell of this benchmark can have. These runs skip the look for a card and
drive the rest of a run on the CPU, at a tiny size."""
import time

import pytest
import torch

from portbench import bench, control, run, verdict

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", ["tiny.cold", "tiny.serve"])
def test_the_bfloat16_control_is_not_correct(tiny_root, cell):
    b = bench.Bench(tiny_root)
    w = b.cell(cell)
    for seed in (1, 2, 2 ** 31 + 3):
        got = control.readings(b.config(w["config"]), b.mix(w["traffic"]),
                               seed, CPU)
        assert got["val_err"] >= 1.0
        assert not verdict.judge(got, 1)


def _altered(coo):
    """An answer altered where it is produced: one value off by one."""
    val = coo.val.clone()
    val[0] += 1
    return type(coo)(row=coo.row, col=coo.col, val=val, shape=coo.shape,
                     ngroups=coo.ngroups)


def _cold_faults(rt):
    real = rt.spgemm
    state = {}

    def unchanged(a, b, **kw):        # the first call's answer, every call
        if "c" not in state:
            state["c"] = real(a, b, **kw)
        return state["c"]

    def half(a, b, **kw):             # half of A's slots left out
        k = a.idx.shape[0] // 2
        idx = a.idx.clone()
        idx[k:] = -1
        return real(type(a)(val=a.val, idx=idx, n_rows=a.n_rows), b, **kw)

    return {"altered": lambda a, b, **kw: _altered(real(a, b, **kw)),
            "unchanged": unchanged, "half": half}


def _serve_faults(rt):
    real = rt.ServingEngine.flush_spgemm
    state = {}

    def altered(self, **kw):
        return {rid: _altered(c) for rid, c in real(self, **kw).items()}

    def unchanged(self, **kw):        # the first answer, every flush
        res = real(self, **kw)
        stale = state.setdefault("c", next(iter(res.values())))
        return {rid: stale for rid in res}

    def half(self, **kw):             # every other request's answer dropped
        return {rid: c for rid, c in real(self, **kw).items()
                if rid % 2 == 0}

    return {"altered": altered, "unchanged": unchanged, "half": half}


@pytest.mark.parametrize("fault", ["altered", "unchanged", "half"])
@pytest.mark.parametrize("cell", ["tiny.cold", "tiny.serve"])
def test_a_run_with_the_timed_path_broken_is_not_correct(
        tiny_root, monkeypatch, cell, fault):
    import repro_torch
    b = bench.Bench(tiny_root)
    if cell == "tiny.cold":
        monkeypatch.setattr(repro_torch, "spgemm",
                            _cold_faults(repro_torch)[fault])
    else:
        monkeypatch.setattr(repro_torch.ServingEngine, "flush_spgemm",
                            _serve_faults(repro_torch)[fault])
    out, _ = run.run(b, cell, 77, 1.0, False, CPU, time.perf_counter())
    assert out["correct"] is False
    assert any(v["value"] > v["limit"] for v in out["checks"].values())
