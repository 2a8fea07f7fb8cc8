"""Find the highest request rate a ``serve`` cell sustains, once, on the chip.

    python3 portbench/sweep.py --workload <serve cell> --seed <n>
                               --seconds <s> --rates 4 6 8 ...

One set-up, then one window of ``--seconds`` at each rate, in the order
given. For each rate it prints the requests completed a second, the median
and 95th-percentile latency, and the mean latency of the window's last
quarter over its first: a backlog that grows through the window reads well
above 1. The cell's rate is then set, as a number in its mix, below the
highest rate that keeps up, where its tail is steady from run to run.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import bench, devtrace, drive
    b = bench.find(ROOT)
    cell = b.cell(args.workload)
    mix = dict(b.mix(cell["traffic"]), sample=0)
    t0 = time.perf_counter()
    drv = drive.Serve(b.config(cell["config"]), mix, args.seed,
                      torch.device("cuda", 0))
    drv.setup()
    print(f"setup {time.perf_counter() - t0:.1f} s", flush=True)
    for rate in args.rates:
        drv.mix["rate"] = rate
        drv.rec = {"units": []}
        torch.cuda.reset_peak_memory_stats()
        drv.window(args.seconds, devtrace.Window(False, args.seconds, None))
        lat = np.array(drv.rec["latency_ms"])
        q = max(1, len(lat) // 4)
        row = {"rate": rate, "done_per_s": len(lat) / drv.rec["window_s"],
               "p50_ms": float(np.percentile(lat, 50)),
               "p95_ms": float(np.percentile(lat, 95)),
               "growth": float(lat[-q:].mean() / max(lat[:q].mean(), 1e-9)),
               "failed": drv.rec["failed"],
               "mean_flush_ms": float(np.mean(drv.rec["flush_ms"])),
               "requests_per_flush": len(lat) / len(drv.rec["flush_ms"]),
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
