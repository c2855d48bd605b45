"""Preemption-safe training loop: the counterpart of the JAX package's
``training/trainer.py``.

- resume from the latest checkpoint on start;
- periodic asynchronous checkpoints, and a final blocking one at the end
  or when SIGTERM / SIGINT set the preemption flag (spot instances);
- the data pipeline is stateless (batch = f(seed, step)), so a resumed run
  draws the batches it would have drawn.

Parameters are drawn from a ``torch.Generator`` seeded ``rcfg.seed`` on the
device; a checkpoint holds ``{"params", "opt"}`` in the port's tree (one
dict per layer).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from pathlib import Path
from typing import Callable

from .._device import resolve_device
from ..configs.base import ModelConfig
from ..data.tokens import DataConfig, batch_at
from ..models import transformer as tf
from .checkpoint import CheckpointManager
from .optimizer import init_opt
from .train_loop import TrainConfig, make_train_step


@dataclasses.dataclass
class RunConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    log_every: int = 10
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, dcfg: DataConfig,
                 rcfg: RunConfig, *, device=None,
                 log_fn: Callable[[str], None] = print, params=None,
                 batch_fn: Callable[[int], dict] | None = None):
        """``params`` replaces the seeded initial weights and ``batch_fn``
        (step -> batch) the synthetic batches; a checkpoint in
        ``rcfg.ckpt_dir`` still takes precedence over ``params``."""
        import torch
        self.cfg, self.tcfg, self.dcfg, self.rcfg = cfg, tcfg, dcfg, rcfg
        self.device = resolve_device(device)
        self.log = log_fn
        self.ckpt = CheckpointManager(Path(rcfg.ckpt_dir) / cfg.name)
        self.step_fn = make_train_step(cfg, tcfg)
        self.batch_fn = batch_fn or (lambda step: batch_at(
            dcfg, step, frontend=cfg.frontend, d_model=cfg.d_model,
            device=self.device))
        self._preempted = False
        self.history: list[dict] = []

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(rcfg.seed)
            params = tf.init_params(gen, cfg)
        self.params = params
        self.opt = init_opt(self.params)
        self.start_step = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            state = self.ckpt.restore(
                latest, {"params": self.params, "opt": self.opt})
            self.params, self.opt = state["params"], state["opt"]
            self.start_step = latest
            self.log(f"[trainer] resumed from step {latest}")

    def _install_signal_handlers(self):
        def handler(signum, frame):
            self._preempted = True
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass  # not on the main thread

    def state(self) -> dict:
        return {"params": self.params, "opt": self.opt}

    def run(self) -> dict:
        self._install_signal_handlers()
        t0 = time.time()
        step = self.start_step
        while step < self.rcfg.steps and not self._preempted:
            batch = self.batch_fn(step)
            self.params, self.opt, metrics = self.step_fn(
                self.params, self.opt, batch)
            step += 1
            if step % self.rcfg.log_every == 0 or step == self.rcfg.steps:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["wall_s"] = round(time.time() - t0, 2)
                self.history.append(m)
                self.log(f"[trainer] step {step}: loss={m['loss']:.4f} "
                         f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e}")
            if step % self.rcfg.ckpt_every == 0:
                self.ckpt.save(step, self.state())
        # final (or preemption) checkpoint, blocking
        self.ckpt.save(step, self.state(), block=True)
        if self._preempted:
            self.log(f"[trainer] preempted at step {step}; state saved")
        return {"final_step": step, "history": self.history,
                "preempted": self._preempted}
