"""Tabulate the port's dry-run records as markdown: one row a config, one
column a shape, each cell ``argument GiB a device on (16,16)/(2,16,16)
(flagged over one H100's 80 GiB) · TFLOP a device on each (an even
split) · the whole program's peak live GiB · trace seconds on each``. The
bytes and FLOPs are counts from the resolved layouts and
``launch/op_analysis.py``, not times.

Run from the repository root after ``python -m repro_torch.launch.dryrun
--all`` (or with the directory it wrote to):

    python3 tools/dryrun_table.py [results/dryrun_torch]
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

GIB = 2 ** 30
HBM_GIB = 80
MESHES = ("pod16x16", "pod2x16x16")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def cell_text(by_mesh: dict) -> str:
    """``args (16,16)/(2,16,16) GiB · TFLOP a device on each · peak live
    GiB · trace s`` of one (config, shape) on both meshes."""
    cells = [by_mesh.get(m) for m in MESHES]

    def both(fn):
        return "/".join(fn(c) if c else "—" for c in cells)

    over = any(c and c["mem_per_device"]["argument_bytes"] > HBM_GIB * GIB
               for c in cells)
    first = next(c for c in cells if c)
    return (both(lambda c: "{:.3g}".format(
        c["mem_per_device"]["argument_bytes"] / GIB))
        + (" **over 80**" if over else "")
        + " · " + both(lambda c: f"{c['flops_per_device'] / 1e12:.4g}")
        + f" · {first['peak_live_bytes'] / GIB:,.0f}"
        + " · " + both(lambda c: f"{c['trace_s']:.0f}"))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = Path(argv[0] if argv else "results/dryrun_torch")
    recs = {}
    for p in sorted(root.glob("*.json")):
        r = json.loads(p.read_text())
        recs.setdefault(r["arch"], {}).setdefault(r["shape"], {})[
            r["mesh"]] = r
    print("| config | " + " | ".join(SHAPES) + " |")
    print("|---" * (len(SHAPES) + 1) + "|")
    for arch in sorted(recs):
        row = [cell_text(recs[arch][sh]) if sh in recs[arch] else "—"
               for sh in SHAPES]
        print(f"| {arch} | " + " | ".join(row) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
