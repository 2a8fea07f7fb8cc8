"""Everything a run needs, found by name from ``BENCHMARK.json``.

  configs/<config>.json   a configuration (the ``file`` of its entry)
  mixes/<traffic>.json    a traffic mix: its ``kind`` (``cold`` or
                          ``serve``, the drivers of ``drive.py``) and the
                          kind's parameters
  metrics/<metric>.py     one reader a metric, end-to-end or per-layer:
                          ``read(rec)`` returns its number or None
  counts/<wrapper>.py     the bytes and operations that one kernel wrapper
                          of the program needs for a product:
                          ``need(s) -> (bytes, ops)``
  peaks.json              the published peaks of each device by its name

A later change adds a configuration, a mix, a cell or a metric by adding
such files and entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class Bench:
    """``BENCHMARK.json`` at ``root``, with the files it names."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "portbench"

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict:
        return json.loads((self.dir / "mixes" / f"{name}.json").read_text())

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The metrics that cell ``cell`` reports: its end-to-end ones, or
        with ``trace`` its per-layer ones."""
        if not trace:
            return [m for m in self.spec["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        reported = {m["name"] for m in self.metrics(cell, False)}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell])
                and m["moves"] in reported]

    def reader(self, metric: str):
        return _load(self.dir / "metrics" / f"{metric}.py").read

    def counts(self) -> Dict[str, object]:
        """{kernel wrapper: its ``need``} for every file in ``counts/``."""
        return {p.stem: _load(p).need
                for p in sorted((self.dir / "counts").glob("*.py"))}

    def peaks(self, device_name: str) -> dict:
        table = json.loads((self.dir / "peaks.json").read_text())
        return table.get(device_name, table["default"])


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_file_" + re.sub(r"\W", "_", path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def problems(root: Path) -> List[str]:
    """What in ``BENCHMARK.json`` at ``root`` cannot be found or parsed,
    or breaks the rules for names and units; empty when all is well."""
    b = Bench(root)
    out: List[str] = []
    s = b.spec
    for c in s["configs"]:
        if not NAME.match(c["name"]):
            out.append(f"config name {c['name']!r}")
        for k in c["reduced"]:
            if not NAME.match(k):
                out.append(f"reduced key {k!r}")
        try:
            b.config(c["name"])
        except (OSError, ValueError) as e:
            out.append(f"config {c['name']}: {e}")
    metrics = s["end_to_end"] + s["per_layer"]
    for m in metrics:
        if not NAME.match(m["name"]):
            out.append(f"metric name {m['name']!r}")
        if not UNIT.match(m["unit"]):
            out.append(f"unit {m['unit']!r}")
        if not (b.dir / "metrics" / f"{m['name']}.py").exists():
            out.append(f"no reader for {m['name']}")
    for w in s["workloads"]:
        for k in ("name", "config", "traffic"):
            if not NAME.match(w[k]):
                out.append(f"workload {k} {w[k]!r}")
        try:
            kind = b.mix(w["traffic"])["kind"]
            if kind not in ("cold", "serve"):
                out.append(f"mix {w['traffic']}: kind {kind!r}")
        except (OSError, ValueError, KeyError) as e:
            out.append(f"mix {w['traffic']}: {e}")
        if not any(m["name"] != "setup_s" for m in b.metrics(w["name"],
                                                             False)):
            out.append(f"{w['name']} reports no end-to-end metric")
        if not b.metrics(w["name"], True):
            out.append(f"{w['name']} reports no per-layer metric")
    names = [x["name"] for x in s["configs"]] + [x["name"] for x in metrics]
    names += [x["name"] for x in s["workloads"]]
    if len(set(names)) != len(names):
        out.append("a name is used twice")
    return out


def find(root: Optional[Path] = None) -> Bench:
    return Bench(root if root is not None else HERE.parent)
