"""Training loop: checkpoint/restart, fault tolerance, metrics, mirroring
``src/repro/runtime/trainer.py``.

The loop is thin: the step (``launch.steps.make_train_step``) holds the
forward, the backward and the AdamW update; the host side feeds data,
times, checkpoints and wraps the step in the fault-tolerance primitives.
Restart-safety comes from stateless data × atomic checkpoints:
``Trainer.run()`` resumed from step k sees the stream it would have seen.

The step runs eagerly on ``device`` (the card unless the caller asks for
another); the reference's ``jax.jit(donate_argnums)`` has no counterpart,
the update being in place. Under ``sharding_rules(mesh)`` of more than one
device every config trains partitioned: params and moments placed on the
mesh (``init_state``), a checkpoint restored onto the current mesh
whatever mesh wrote it. ``history`` holds the reference's
``{"step", "loss"}`` at each logged step, plus its ``grad_norm`` and the
step's host-clock ``ms`` (batch to loss read, which waits for the
device).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..checkpoint import CheckpointManager
from ..data import DataConfig, SyntheticLMDataset
from ..launch.steps import make_train_step
from ..models import Model
from ..models.params import tree_leaves
from ..optim import AdamWConfig, adamw_init
from ..parallel.sharding import current_rules
from .fault import FaultTolerantStep


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=default_ckpt_dir)
    keep_n: int = 3
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128


class Trainer:
    def __init__(self, model: Model, tcfg: TrainerConfig,
                 opt_cfg: Optional[AdamWConfig] = None,
                 extra_batch_fn: Optional[Callable[[int], Dict]] = None,
                 device=None):
        from ..core.formats import resolve_device
        self.model = model
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep_n=tcfg.keep_n)
        self.data = SyntheticLMDataset(DataConfig(
            vocab=model.cfg.vocab, seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch, seed=tcfg.seed))
        self.extra_batch_fn = extra_batch_fn
        self._step = make_train_step(model, self.opt_cfg)
        self.history: list = []
        self.init_s = None

    def _batch(self, step: int) -> Dict[str, Any]:
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in self.data.batch(step).items()}
        if self.extra_batch_fn:
            batch.update(self.extra_batch_fn(step))
        return batch

    def partitioned(self) -> bool:
        """Whether the step runs partitioned: under rules whose mesh has
        more than one device (every config has a partitioned program)."""
        rules = current_rules()
        return (rules is not None and rules.mesh is not None
                and rules.mesh.size > 1)

    def init_state(self, generator: Optional[torch.Generator] = None):
        """Parameters drawn by ``Model.init`` from ``generator`` (default: a
        ``torch.Generator`` on the device seeded ``tcfg.seed``), made to
        require grad, and zero AdamW state. Partitioned (``partitioned``):
        the parameters placed on the mesh (``Model.place``), the moments
        laid out by their ZeRO-1 specs."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                self.tcfg.seed)
        params = self.model.init(generator, self.device)
        if self.partitioned():
            params = self.model.place(params)
            return params, adamw_init(params, self.model.specs())
        for p in tree_leaves(params):
            p.requires_grad_(True)
        return params, adamw_init(params)

    def run(self, resume: bool = True) -> Dict[str, Any]:
        t0 = time.perf_counter()
        params, opt_state = self.init_state()
        self.init_s = time.perf_counter() - t0
        start = 0
        if resume and self.ckpt.latest_step() is not None:
            step = self.ckpt.latest_step()
            params, opt_state, extra = self.ckpt.restore(
                step, params, opt_state, device=self.device)
            if not self.partitioned():
                for p in tree_leaves(params):
                    p.requires_grad_(True)
            start = extra.get("next_step", step)
            print(f"[trainer] resumed from checkpoint step {step}", flush=True)

        def on_preempt(_):
            print("[trainer] preemption notice — checkpointing", flush=True)

        ft_step = FaultTolerantStep(self._step, on_preempt=on_preempt)
        t_last = time.time()
        for step in range(start, self.tcfg.steps):
            t_step = time.perf_counter()
            batch = self._batch(step)
            params, opt_state, metrics = ft_step(params, opt_state, batch)
            if step % self.tcfg.log_every == 0 or step == self.tcfg.steps - 1:
                loss = float(metrics["loss"])
                gnorm = float(metrics["grad_norm"])
                ms = (time.perf_counter() - t_step) * 1e3
                dt = time.time() - t_last
                t_last = time.time()
                self.history.append({"step": step, "loss": loss,
                                     "grad_norm": gnorm, "ms": ms})
                print(f"[trainer] step {step:5d} loss {loss:.4f} "
                      f"gnorm {gnorm:.3f} ({dt:.2f}s)", flush=True)
            if (step + 1) % self.tcfg.ckpt_every == 0 or ft_step.preempted:
                self.ckpt.save(step + 1, params, opt_state,
                               extra={"next_step": step + 1})
                if ft_step.preempted:
                    print("[trainer] exiting after preemption save", flush=True)
                    break
        return {"params": params, "opt_state": opt_state,
                "history": self.history,
                "straggler": ft_step.detector.is_straggler}
