"""The control of ``correct``: the plain reference, computed in bfloat16
(the precision below the configuration's float32), put in the program's
place, on a cell's own operands at its own size.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3

For each seed it makes the operands as a run of the cell does (a cold
cell: the first call's relabelling; a serve cell: the whole matrix with
the first value set), computes the product in bfloat16 and in float64,
and prints the numbers that decide ``correct`` for the bfloat16 result, as
JSON, one line a seed. A sound control fails at least one of them.
The benchmark's own runs do not run it.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cfg: dict, mix: dict, seed: int, device) -> dict:
    """The numbers compared, for the bfloat16 reference in the program's
    place."""
    import torch

    from portbench import operands as ops
    from portbench import verdict
    from portbench.reference.product import product
    m = ops.load_matrix(cfg, device)
    p = q = keep = None
    if mix["kind"] == "cold":
        vals = ops.draw_values(m, 1, seed)
        g = ops.device_generator(seed, "relabel", device)
        p = torch.randperm(m.c_rows, generator=g, device=device)
        q = torch.randperm(m.dim, generator=g, device=device)
    else:
        vals = ops.draw_values(m, int(mix["value_sets"]), seed)
        keep = ops.draw_keeps(m, list(mix["drops"]), seed)[0][m.csr_pos]
    val = vals[0][m.csr_pos]
    kw = dict(dim=m.dim, c_rows=m.c_rows, keep=keep, p=p, q=q)
    low = list(product(m.row, m.col, val, dtype=torch.bfloat16, **kw))
    key = torch.cat([b.key for b in low])
    out = torch.cat([b.val for b in low]).float()
    del low
    row, col = (key // m.dim).to(torch.int32), (key % m.dim).to(torch.int32)
    got = verdict.compare(row, col, out, key.numel(),
                          product(m.row, m.col, val, **kw), m.dim)
    return dict(got, missing=0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import bench, verdict
    b = bench.find(ROOT)
    cell = b.cell(args.workload)
    cfg, mix = b.config(cell["config"]), b.mix(cell["traffic"])
    for seed in args.seeds:
        got = readings(cfg, mix, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "bfloat16 reference",
                          "correct": verdict.judge(got, 1), **got}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
