"""Multi-pod dry run: trace every (arch x shape x mesh) cell on the ``meta``
device, mirroring ``src/repro/launch/dryrun.py``.

For each cell it builds the production mesh ((16,16) single-pod and
(2,16,16) multi-pod, ``launch.mesh.make_production_mesh``), lays the
step's arguments out by the logical-axis rules
(``launch.steps.abstract_*_args``: meta tensors, nothing allocated), runs
the real step (the one ``launch/train.py`` and ``launch/serve.py``
execute) on them at the cell's global shapes under
``launch.op_analysis.analyze``, and records:

  * ``mem_per_device.argument_bytes``  one device's share of the step's
    arguments, from the resolved specs' shard shapes (exact)
  * ``mem_per_device.output_bytes``    one device's share of the step's
    outputs: a prefill's or a decode's (logits, cache) under
    ``prefill_out_shardings``, the train step's parameters and optimizer
    state as their arguments (it updates them in place) and its metrics
    whole (exact)
  * ``flops``, ``bytes``               the whole program's matmul FLOPs and
    its ops' operand plus output bytes (``op_analysis``)
  * ``flops_per_device``, ``bytes_per_device``  those over ``n_devices``:
    they assume the work splits evenly over the mesh
  * ``peak_live_bytes``                the peak of live tensor bytes of the
    whole program on one device (``op_analysis``), arguments included
  * ``trace_s``                        seconds to build and trace the cell
    (the reference's ``compile_s``)

  * ``collective_bytes``, ``collective_count``  by the reference's kinds
    (all-gather, all-reduce, reduce-scatter, all-to-all,
    collective-permute): one device's output bytes of each collective op of
    the partitioned program, and the ops (``collective_trace``). Filled for
    every cell of every config; a train cell's count holds the forward,
    the backward (each collective's dual, and the forward's again where
    the activation checkpoint recomputes a block) and the ZeRO-1
    update's. The layers, and the scans' chunks, are a Python loop here,
    so an op of a layer counts once a layer (once a chunk inside the SSM
    and RG-LRU mixers); the reference's HLO counts a scanned layer's op
    once.

A device's temporaries beyond the even split are not counted (``gaps``).
A decode cell runs one step at the cache's last position (``seq_len -
1``); a decode step's work does not depend on it.

Results land in results/dryrun_torch/<arch>__<shape>__<mesh>.json.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

from ..configs import ARCHS, applicable_shapes, get_config
from ..configs.base import ShapeCase, get_shape
from ..models import build_model
from ..models.params import tree_leaves, tree_unflatten
from ..optim import AdamWConfig
from ..parallel.sharding import NamedSharding, sharding_rules
from .mesh import make_production_mesh
from .op_analysis import analyze
from .steps import (abstract_cache, abstract_decode_args,
                    abstract_prefill_args, abstract_train_args,
                    make_prefill_step, make_serve_step, make_train_step,
                    prefill_out_shardings, with_shardings)

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

DRYRUN_GAPS = {"temp_bytes": "a device's temporaries beyond an "
               "even split of peak_live_bytes are not counted: the "
               "partitioned program is traced for its collectives only"}


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if b < 1024:
            return f"{b:.2f}{unit}"
        b /= 1024
    return f"{b:.2f}PiB"


def device_bytes(tree) -> int:
    """One device's bytes of ``tree``'s tensor leaves: each laid out by its
    ``sharding`` attribute (``models.params.meta_tensor``), whole where it
    has none."""
    total = 0
    for t in tree_leaves(tree):
        shape = tuple(t.shape)
        sh = getattr(t, "sharding", None)
        if isinstance(sh, NamedSharding):
            shape = sh.shard_shape(shape)
        total += math.prod(shape) * t.element_size()
    return total


def _output_bytes(model, case, step, out) -> int:
    if case.kind == "train":
        # params and opt_state come back updated in place: their layouts
        params, opt_state, metrics = out
        return device_bytes((params, opt_state)) + device_bytes(metrics)
    laid = (out[0], abstract_cache(out[1]))
    return device_bytes(with_shardings(
        laid, prefill_out_shardings(model, case, step, out)))


def collective_trace(model, case: ShapeCase, step, args):
    """``(bytes, count)`` by kind of the partitioned program's collectives
    on ``args`` (meta, laid out by their ``sharding``): the weights placed
    by the rules, the cache by its layout, the step traced on a meta mesh
    of the active mesh's shape, where one device stands for all
    (``parallel.sharding.mesh_coords``)."""
    from ..parallel import mesh as pmesh
    from ..parallel.sharding import ShardingRules, mesh_rules, use_rules
    rules = mesh_rules()
    mesh = rules.mesh
    if mesh.size == 1:              # one device: every collective skipped
        return tuple({k: 0 for k in pmesh.KINDS} for _ in range(2))
    if mesh.devices.flat[0].type != "meta":
        mesh = pmesh.make_mesh(mesh.devices.shape, mesh.axis_names,
                               ["meta"] * mesh.size)
    with use_rules(ShardingRules(mesh, rules.rules)):
        return _traced(model, case, step, args, mesh)


def _traced(model, case, step, args, mesh):
    from ..parallel import mesh as pmesh
    from ..parallel.sharding import shard
    if case.kind == "train":
        params, opt_state = model.place(args[0], args[1])
        pmesh.reset_collectives()
        step(params, opt_state, args[2])
        return pmesh.collectives()
    params = model.place(args[0])
    pmesh.reset_collectives()
    if case.kind == "prefill":
        step(params, args[1])
    else:
        _, cache, tokens = args
        layers = tree_unflatten(cache["layers"], [
            shard(t, t.sharding.spec, mesh)
            for t in tree_leaves(cache["layers"])])
        step(params, {"layers": layers, "pos": cache["pos"]}, tokens)
    return pmesh.collectives()


def analyze_cell(cfg, case: ShapeCase, mesh) -> dict:
    """Trace one cell: ``cfg``'s step of ``case.kind`` on meta arguments at
    ``case``'s shapes, laid out on ``mesh``. Returns the record's counts
    (see the module docstring) without the cell's names."""
    t0 = time.time()
    with sharding_rules(mesh):
        model = build_model(cfg)
        if case.kind == "train":
            step = make_train_step(model, AdamWConfig())
            args = abstract_train_args(model, case)
        elif case.kind == "prefill":
            step = make_prefill_step(model, s_max=case.seq_len)
            args = abstract_prefill_args(model, case)
        else:
            step = make_serve_step(model)
            args = abstract_decode_args(model, case)
        arg_bytes = device_bytes(args)
        if case.kind == "decode":      # the port's cache counts pos in Python
            params, cache, tokens = args
            args = (params, {**cache, "pos": case.seq_len - 1}, tokens)
        out, cost = analyze(step, *args)
        out_bytes = _output_bytes(model, case, step, out)
        coll = collective_trace(model, case, step, args)
    gaps = dict(DRYRUN_GAPS)
    n_dev = mesh.size
    return {
        "n_devices": n_dev,
        "n_params": model.n_params(),
        "active_params": cfg.active_params(),
        "trace_s": round(time.time() - t0, 2),
        "flops": cost["flops"],
        "bytes": cost["hbm_bytes"],
        "flops_per_device": cost["flops"] / n_dev,
        "bytes_per_device": cost["hbm_bytes"] / n_dev,
        "peak_live_bytes": cost["peak_live_bytes"],
        "n_ops": cost["n_ops"],
        "mem_per_device": {"argument_bytes": arg_bytes,
                           "output_bytes": out_bytes},
        "collective_bytes": coll[0],
        "collective_count": coll[1],
        "gaps": gaps,
    }


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: Path,
             dispatch: str = None) -> dict:
    cfg = get_config(arch)
    if dispatch and cfg.moe:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    case = get_shape(shape)
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell = f"{cfg.name}__{case.name}__{mesh_name}" + (
        f"__{dispatch}" if dispatch else "")
    rec = {"arch": cfg.name, "shape": case.name, "kind": case.kind,
           "mesh": mesh_name,
           "dispatch": dispatch or (cfg.moe.dispatch if cfg.moe else None),
           "seq_len": case.seq_len, "global_batch": case.global_batch,
           **analyze_cell(cfg, case, mesh)}
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{cell}.json").write_text(json.dumps(rec, indent=1))
    mb = rec["mem_per_device"]
    print(f"[OK] {cell}: trace={rec['trace_s']}s "
          f"flops={rec['flops']:.3e} "
          f"args/dev={_fmt_bytes(mb['argument_bytes'])} "
          f"peak_live={_fmt_bytes(rec['peak_live_bytes'])}", flush=True)
    return rec


def iter_cells():
    for name, cfg in ARCHS.items():
        for case in applicable_shapes(cfg):
            yield name, case.name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--dispatch", choices=["ellpack", "sort"])
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    if args.all:
        cells = list(iter_cells())
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")

    pods = []
    if not args.multi_pod_only:
        pods.append(False)
    if not args.single_pod_only:
        pods.append(True)
    if args.multi_pod:
        pods = [True]

    failures = []
    for arch, shape in cells:
        for mp in pods:
            mesh_name = "pod2x16x16" if mp else "pod16x16"
            suffix = f"__{args.dispatch}" if args.dispatch else ""
            done = out_dir / f"{arch}__{shape}__{mesh_name}{suffix}.json"
            if args.skip_done and done.exists():
                print(f"[skip] {done.name}", flush=True)
                continue
            try:
                run_cell(arch, shape, mp, out_dir, dispatch=args.dispatch)
            except Exception as e:  # record and continue the sweep
                failures.append((arch, shape, mesh_name, repr(e)))
                print(f"[FAIL] {arch}__{shape}__{mesh_name}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nAll dry-run cells traced successfully.")


if __name__ == "__main__":
    main()
