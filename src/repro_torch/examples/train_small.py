"""Train a ~100M-parameter LM for a few hundred steps on the port with the
production path: microbatched, checkpointed, preemption-safe.

    PYTHONPATH=src python -m repro_torch.examples.train_small --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_small --device cpu \\
        --steps 2 --seq 32 --batch 2

The weights come from a ``torch.Generator`` on the device seeded 0, the
batches from the port's stateless Zipf-Markov pipeline.  Attention runs
through the ``flash_attention`` custom op (the kernel's forward, the plain
version's backward).  A run resumes from the latest checkpoint under
``--ckpt-dir``/lm-100m; the default directory is the port's own, so it never
picks up a checkpoint of the JAX script.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from .._device import device_label, resolve_device
from ..configs.base import ModelConfig
from ..data.tokens import DataConfig
from ..training.optimizer import OptConfig
from ..training.train_loop import TrainConfig
from ..training.trainer import RunConfig, Trainer

CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_small")


def model_config(use_kernel=None, **model) -> ModelConfig:
    """lm-100m: 12 layers, d 768, untied head over a 32k vocab; ``model``
    overrides its fields (widths, depth, dtype)."""
    fields = dict(name="lm-100m", family="dense", n_layers=12, d_model=768,
                  n_heads=12, n_kv_heads=4, d_ff=2048, vocab=32_000,
                  mlp_act="swiglu", remat="none",
                  use_kernel=True if use_kernel is None else use_kernel)
    fields.update(model)
    return ModelConfig(**fields)


def run(device=None, use_kernel=None, *, steps: int = 200, seq: int = 256,
        batch: int = 8, ckpt_dir: str = CKPT_DIR, ckpt_every: int = 50,
        log_every: int = 10, params=None, batch_fn=None, log_fn=print,
        **model) -> dict:
    """Train and return the history, the final step and the trainer.
    ``model`` overrides lm-100m's config fields; ``params`` and
    ``batch_fn`` go to the :class:`Trainer` (for tests)."""
    dev = resolve_device(device)
    cfg = model_config(use_kernel, **model)
    tcfg = TrainConfig(microbatches=2,
                       opt=OptConfig(lr=3e-4, warmup_steps=20,
                                     total_steps=steps))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    rcfg = RunConfig(steps=steps, ckpt_every=ckpt_every,
                     log_every=log_every, ckpt_dir=ckpt_dir)
    trainer = Trainer(cfg, tcfg, dcfg, rcfg, device=dev, log_fn=log_fn,
                      params=params, batch_fn=batch_fn)
    t0 = time.perf_counter()
    out = trainer.run()
    wall = time.perf_counter() - t0
    ran = out["final_step"] - trainer.start_step
    return dict(out, n_params=cfg.n_params(), start_step=trainer.start_step,
                wall_s=wall, tokens_s=ran * batch * (seq - 1) / wall,
                where=device_label(dev), trainer=trainer)


def report(out: dict) -> None:
    h = out["history"]
    if not h:
        print(f"loss: no step run (resumed at step {out['start_step']})")
        return
    print(f"loss: {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f} "
          f"over {out['final_step']} steps ({out['tokens_s']:.0f} train "
          f"tokens/s on {out['where']}, checkpoints included)")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--device", default=None)
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    resolve_device(args.device)
    print(f"model: {model_config().n_params() / 1e6:.1f}M params")
    out = run(device=args.device, steps=args.steps, seq=args.seq,
              batch=args.batch, ckpt_dir=args.ckpt_dir)
    report(out)
    return out


if __name__ == "__main__":
    main()
