"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout. Set-up (operands from the seed, the program's
kernels built or loaded, the cell's warm-up) counts as ``setup_s``; then the
cell's traffic runs for ``--seconds``. ``--trace 0`` reports the cell's
end-to-end metrics; ``--trace 1`` runs with ``repro_torch.obs`` on and the
profiler over part of the window, and reports its per-layer metrics and the
breakdown. After the window the program's state is freed and its sampled
results are compared with the plain reference; the numbers compared go to
standard error, each beside its limit, and into the result line under
``checks``. The last line of standard output is the result, as JSON.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None):
    """Loaded modules (or ``names``) whose top-level name is JAX's or the
    JAX package's, compared whole."""
    return sorted({name.split(".")[0] for name in
                   (sys.modules if names is None else names)
                   if name.split(".")[0] in FORBIDDEN})


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(bench, cell_name: str, seed: int, seconds: float, trace: bool,
        device, t_start: float) -> dict:
    """One run of ``cell_name``; returns the result line's object (without
    the device's name, which the caller adds)."""
    import torch

    from portbench import devtrace, drive, verdict
    cell = bench.cell(cell_name)
    cfg = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    drv = drive.KINDS[mix["kind"]](cfg, mix, seed, device)
    drv.setup()
    if trace and device.type == "cuda":
        devtrace.warm_up(device)
    rec = drv.rec
    rec["setup_s"] = time.perf_counter() - t_start

    from repro_torch import kernels, obs
    win = devtrace.Window(trace and device.type == "cuda", seconds,
                          kernels.launch_counts)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if trace:
        obs.enable(reset=True)
    drv.window(seconds, win)
    if trace:
        obs.disable()
        rec["spans"] = obs.get_tracer().spans()
    rec["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else 0)
    drv.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, n_checked = drv.check()
    correct = verdict.judge(numbers, n_checked)

    metrics, breakdown = {}, None
    if trace:
        if mix["kind"] == "serve":
            drv.pattern_stats()
        rec["profile"] = win.reduce(devtrace.port_kernel_names(
            ROOT / "src" / "repro_torch" / "csrc")) if win.enabled else None
        rec["counts"] = bench.counts()
        rec["peaks"] = bench.peaks(torch.cuda.get_device_name(device)
                                   if device.type == "cuda" else "default")
        if rec["profile"]:
            p = rec["profile"]
            breakdown = {"device_ops": p["device_ops"],
                         "idle_gaps": p["idle_gaps"]}
            print(f"profiled {len(p['units'])} call(s) in {p['wall_s']:.3f} s"
                  f" (trace window {p['window_s']:.3f} s), launches " + json.dumps(
                {k: v for k, v in p["launches"].items() if v}) + "; port "
                "kernels seen " + json.dumps(p["port_kernels_seen"]),
                flush=True)
            print("product counts by pattern " + json.dumps(
                rec.get("product_stats")), flush=True)
    for m in bench.metrics(cell_name, trace):
        value = bench.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics}
    if breakdown:
        out["breakdown"] = breakdown
    out["checks"] = verdict.lines(numbers)
    out["checked"] = n_checked
    return out, rec


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import bench as bench_mod

    b = bench_mod.find(ROOT)
    cell = b.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    seed = args.seed % 2 ** 63
    out, rec = run(b, args.workload, seed, args.seconds, bool(args.trace),
                   device, T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {bad}", file=sys.stderr)
        return 3
    out["device"] = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(device),
                     "count": cell["chips"],
                     "memory_peak_bytes": int(rec["peak_bytes"])}
    if rec.get("profile"):
        out["device"]["busy_s"] = rec["profile"]["busy_s"]
        out["device"]["window_s"] = rec["profile"]["window_s"]
    checks = out.pop("checks")
    n_checked = out.pop("checked")
    print(f"checked {n_checked} result(s) against the reference",
          file=sys.stderr)
    for k, v in checks.items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr)
    out["checks"] = checks
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
