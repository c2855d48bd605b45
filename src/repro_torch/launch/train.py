"""Training entry point of the port: random weights, synthetic Zipf-Markov
tokens, AdamW, checkpoints (:class:`repro_torch.training.trainer.Trainer`).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch phi3.5-moe-42b-a6.6b --smoke --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch phi3.5-moe-42b-a6.6b --smoke --steps 20   # on the card

The flags are the JAX package's ``launch/train.py``'s, plus ``--device``
(without it the run is on the card and raises if there is none).
``--smoke`` runs without remat, as the reference's does.  Checkpoints go
under ``--ckpt-dir``/<arch>.
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    from ..configs import registry
    from ..data.tokens import DataConfig
    from ..training.optimizer import OptConfig
    from ..training.train_loop import TrainConfig
    from ..training.trainer import RunConfig, Trainer

    cfg = registry.smoke(args.arch) if args.smoke else registry.get(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(cfg, remat="none")
    tcfg = TrainConfig(
        microbatches=args.microbatches,
        compress_grads=args.compress_grads,
        opt=OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    rcfg = RunConfig(steps=args.steps, ckpt_every=max(args.steps // 2, 1),
                     log_every=max(args.steps // 10, 1),
                     ckpt_dir=args.ckpt_dir)
    out = Trainer(cfg, tcfg, dcfg, rcfg, device=args.device).run()
    print(f"[train] done at step {out['final_step']} "
          f"(preempted={out['preempted']})")
    return out


if __name__ == "__main__":
    main()
