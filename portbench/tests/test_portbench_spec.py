"""``BENCHMARK.json`` and the files it names: found by name, parsed, and
within the rules for names and units; a throwaway configuration, mix, cell
and metric added as files alone run."""
import json
import re
import time

import pytest
import torch

from conftest import ROOT
from portbench import bench, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_every_named_file_is_found_and_parses():
    assert bench.problems(ROOT) == []
    b = bench.Bench(ROOT)
    for w in b.spec["workloads"]:
        assert b.config(w["config"])["dim"] > 0
        assert b.mix(w["traffic"])["kind"] in ("cold", "serve")
        for trace in (False, True):
            for m in b.metrics(w["name"], trace):
                assert callable(b.reader(m["name"]))
    assert set(b.counts()) >= {"sccp_multiply", "align_product_keys"}


def test_names_units_and_keys_keep_to_the_rules():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    metrics = spec["end_to_end"] + spec["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"])
        assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(json.dumps(spec)) < 64 * 1024


def test_a_throwaway_cell_added_as_files_is_found(tiny_root):
    assert bench.problems(tiny_root) == []
    b = bench.Bench(tiny_root)
    names = [m["name"] for m in b.metrics("tiny.cold", True)]
    assert "calls.tiny" in names and "symbolic_ms.cold" in names
    assert [m["name"] for m in b.metrics("tiny.serve", False)] == [
        "request_ms_p95", "setup_s"]
    assert [m["name"] for m in b.metrics("tiny.cold", False)] == [
        "gflops", "peak_gib", "setup_s"]


@pytest.mark.parametrize("cell", ["tiny.cold", "tiny.serve"])
def test_a_throwaway_cell_runs_on_the_cpu(tiny_root, cell):
    b = bench.Bench(tiny_root)
    for trace in (False, True):
        out, rec = run.run(b, cell, 2 ** 33 + 5, 1.5, trace,
                           torch.device("cpu"), time.perf_counter())
        assert out["correct"] and out["failed"] == 0 and out["checked"] > 0
        assert list(out)[-2:] == ["checks", "checked"]
        assert trace or {"gflops", "request_ms_p95"} & set(out["metrics"])
    if cell == "tiny.cold":
        assert out["metrics"]["calls.tiny"]["value"] == len(rec["units"])
