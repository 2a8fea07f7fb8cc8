"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
[--smoke] [--requests N] [--max-new N] [--model-parallel 1]
[--device cpu|cuda]``.

Batched prefill + decode with the engine's ``generate_batch``, the
reference's loop (``src/repro/launch/serve.py``): weights drawn from a
generator seeded 0 in the config's ``param_dtype``, prompts of 4-15 tokens
from ``numpy.random.default_rng(0)``, waves of ``max_batch``, all under
``sharding_rules(make_host_mesh(--model-parallel))`` as in the reference:
a ("data", "model") mesh over every card, or over ``devices``
(``main(argv, devices=...)``); a size that does not divide them raises
``ValueError``. Every config serves the partitioned program: the
engine lays the weights out on the mesh by the rules (each device its
blocks, no whole copy kept), prefill lays the caches out by batch and
sequence (the recurrent states by channel), and attention, the FFNs, the
MoE region, the SSM and RG-LRU mixers and the vocab run split, their
collectives counted (``parallel.mesh.collectives``). Returns the
engine.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_config
from ..models import build_model
from ..parallel.sharding import sharding_rules
from ..serve import ServeConfig, ServingEngine
from .mesh import launch_mesh


def main(argv=None, devices=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    model = build_model(cfg)
    mesh = launch_mesh(args.model_parallel, args.device, devices)
    dev = mesh.devices.flat[0]
    rng = np.random.default_rng(0)
    with sharding_rules(mesh):
        eng = ServingEngine(model, model.init(
            torch.Generator(device=dev).manual_seed(0), dev), ServeConfig(
                max_new_tokens=args.max_new))
        served = 0
        while served < args.requests:
            n = min(eng.cfg.max_batch, args.requests - served)
            prompts = [rng.integers(3, cfg.vocab, size=rng.integers(4, 16))
                       .astype(np.int32) for _ in range(n)]
            eng.generate_batch(prompts)
            served += n
    s = eng.stats
    print(f"[serve] {s['requests']} reqs, {s['tokens']} tokens, "
          f"decode {s['tokens']/max(s['decode_s'],1e-9):.1f} tok/s",
          flush=True)
    return eng


if __name__ == "__main__":
    main()
