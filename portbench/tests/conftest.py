"""Fixtures of the benchmark's CPU tests.

Run from the repository's root: ``python -m pytest portbench/tests``.
The tests marked ``cuda`` skip without a card; on the chip,
``python -m pytest -m cuda portbench/tests`` runs them.
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"dim": 240, "nnz": 14400, "sigma": 6.0, "c_rows": 160}


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark with a throwaway configuration, mix, two
    cells and a per-layer metric, added as files and entries only."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "portbench/configs/bcsstk32.json").read_text())
    cfg.update(TINY)
    pb = tmp_path / "portbench"
    (pb / "configs/tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "portbench/mixes/serve-6rps.json").read_text())
    mix["rate"] = 10.0
    (pb / "mixes/serve-tiny.json").write_text(json.dumps(mix))
    (pb / "metrics/calls.tiny.py").write_text(
        "def read(rec):\n    return float(len(rec['units']))\n")
    spec["configs"].append({"name": "tiny", "source": "a test's own",
                            "file": "portbench/configs/tiny.json",
                            "reduced": ["dim", "nnz", "c_rows"],
                            "why": "a throwaway configuration"})
    spec["workloads"] += [
        {"name": "tiny.cold", "config": "tiny", "traffic": "cold",
         "chips": 1, "why": "a throwaway cold cell"},
        {"name": "tiny.serve", "config": "tiny", "traffic": "serve-tiny",
         "chips": 1, "why": "a throwaway serve cell"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:       # the tiny cells join their kind's metrics
            m["workloads"] += [f"tiny.{kind}" for kind in ("cold", "serve")
                               if any(w.endswith("." + kind)
                                      for w in m["workloads"])]
    spec["per_layer"].append({
        "name": "calls.tiny", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "front door", "moves": "gflops",
        "workloads": ["tiny.cold"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tmp_path


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
