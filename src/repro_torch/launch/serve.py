"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
[--smoke] [--requests N] [--max-new N] [--device cpu|cuda]``.

Batched prefill + decode with the engine's ``generate_batch``, the
reference's loop (``src/repro/launch/serve.py``): weights drawn from a
generator seeded 0 in the config's ``param_dtype``, prompts of 4-15 tokens
from ``numpy.random.default_rng(0)``, waves of ``max_batch``. One device
only: ``--model-parallel`` above 1 needs multi-axis meshes (ROADMAP queue 1
item 9).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_config
from ..core.formats import resolve_device
from ..models import build_model
from ..serve import ServeConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)
    if args.model_parallel != 1:
        raise NotImplementedError(
            "--model-parallel above 1 is not ported to repro_torch yet: "
            "ROADMAP queue 1 item 9 (meshes of more than one axis)")

    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    model = build_model(cfg)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    eng = ServingEngine(model, params, ServeConfig(
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
