"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--steps N] [--batch B] [--seq S] [--lr LR] [--ckpt-dir D]
[--ckpt-every N] [--model-parallel 1] [--no-resume] [--log-every N]
[--device cpu|cuda]``.

Runs the port's ``Trainer`` (checkpoint/restart, fault tolerance) with the
reference's flags and defaults (``src/repro/launch/train.py``), plus
``--log-every`` (``TrainerConfig.log_every``) and ``--device`` (the card
unless the caller asks for the CPU). On the CPU use the reduced config
(``--smoke``). The step runs on one device: the logical-axis rules lay
arguments out only for the dry run (``launch/dryrun.py``), and running the
LM sharded over a host mesh (``launch.mesh.make_host_mesh``) needs the
multi-process realization (ROADMAP queue 1 item 9), so
``--model-parallel`` other than 1 raises ``NotImplementedError``.

``main(argv)`` takes an argument list and returns the trainer's result
(``params``, ``opt_state``, ``history``, ``straggler``) with the
``trainer`` itself.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_config
from ..core.formats import resolve_device
from ..models import build_model
from ..optim import AdamWConfig
from ..runtime import Trainer, TrainerConfig
from ..runtime.trainer import default_ckpt_dir


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=default_ckpt_dir())
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    if args.model_parallel != 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel} ({cards} device(s) "
            "here): the LM's sharding over a mesh is not ported to "
            "repro_torch yet; it needs ROADMAP queue 1 item 9 (a "
            "multi-process realization over torch.distributed)")
    name = args.arch + ("-smoke" if args.smoke else "")
    cfg = get_config(name)
    model = build_model(cfg)
    print(f"[train] arch={cfg.name} params={model.n_params():,} "
          f"device={dev}", flush=True)

    def extra(step):
        """The modality stub's input a step, drawn as the reference's."""
        rng = np.random.default_rng(step)
        if cfg.family == "audio":
            name, shape = "frames", (args.batch, cfg.encoder_seq, cfg.d_model)
        else:
            name, shape = "patches", (args.batch, cfg.n_vision_tokens,
                                      cfg.d_model)
        return {name: torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev)}

    tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, log_every=args.log_every,
                         global_batch=args.batch, seq_len=args.seq)
    trainer = Trainer(model, tcfg, AdamWConfig(lr=args.lr),
                      extra_batch_fn=extra if cfg.family in ("audio", "vlm")
                      else None,
                      device=dev)
    out = trainer.run(resume=not args.no_resume)
    print(f"[train] done. final loss "
          f"{out['history'][-1]['loss']:.4f}", flush=True)
    return dict(out, trainer=trainer)


if __name__ == "__main__":
    main()
