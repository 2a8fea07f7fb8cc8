"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--steps N] [--batch B] [--seq S] [--lr LR] [--ckpt-dir D]
[--ckpt-every N] [--model-parallel 1] [--no-resume] [--log-every N]
[--device cpu|cuda]``.

Runs the port's ``Trainer`` (checkpoint/restart, fault tolerance) with the
reference's flags and defaults (``src/repro/launch/train.py``), plus
``--log-every`` (``TrainerConfig.log_every``) and ``--device`` (the card
unless the caller asks for the CPU). On the CPU use the reduced config
(``--smoke``). As the reference does, the trainer runs under
``sharding_rules(make_host_mesh(--model-parallel))``: a ("data", "model")
mesh over every card of this host, or over ``devices`` where the caller
passes them (``main(argv, devices=["cuda:0"] * 4)``: four shards of one
card; ``["cpu"] * 4`` in the tests). A model-parallel size that does not
divide the devices raises ``ValueError``. On a mesh of more than one
device every config trains partitioned (``runtime.Trainer``): parameters
placed by the logical-axis rules, the forward, the loss and the backward
run block by block with counted collectives (whisper's encoder and
cross-attention, the SSM and RG-LRU scans on each shard's channels
included), the ZeRO-1 moments split by ``opt_shard``, and a checkpoint
resumes onto the current mesh.

``main(argv, devices=None)`` takes an argument list and returns the
trainer's result (``params``, ``opt_state``, ``history``, ``straggler``)
with the ``trainer`` itself and the ``mesh``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_config
from ..models import build_model
from ..optim import AdamWConfig
from ..parallel.sharding import sharding_rules
from ..runtime import Trainer, TrainerConfig
from ..runtime.trainer import default_ckpt_dir
from .mesh import launch_mesh


def main(argv=None, devices=None):
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

    mesh = launch_mesh(args.model_parallel, args.device, devices)
    dev = mesh.devices.flat[0]
    name = args.arch + ("-smoke" if args.smoke else "")
    cfg = get_config(name)
    model = build_model(cfg)
    print(f"[train] arch={cfg.name} params={model.n_params():,} "
          f"device={dev} mesh={mesh.shape}", flush=True)

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
    with sharding_rules(mesh):
        trainer = Trainer(model, tcfg, AdamWConfig(lr=args.lr),
                          extra_batch_fn=extra
                          if cfg.family in ("audio", "vlm") else None,
                          device=dev)
        out = trainer.run(resume=not args.no_resume)
    print(f"[train] done. final loss "
          f"{out['history'][-1]['loss']:.4f}", flush=True)
    return dict(out, trainer=trainer, mesh=mesh)


if __name__ == "__main__":
    main()
