"""Serving entry point of the port: continuous batching over a model with
random weights (the dense-block, MoE, xLSTM and Hymba families).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --smoke --device cpu                       # tiny, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch phi3.5-moe-42b-a6.6b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b
                                                   # full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch phi3.5-moe-42b-a6.6b --layers 8     # 8 of its 32 layers

``--layers`` cuts the depth of a config (phi3.5-MoE's 32 layers are about
84 GB in bf16, more than one 80 GB card holds).

A config with meta tokens (Hymba) is served with the batcher's position
offset set to ``cfg.meta_tokens``: its caches hold the meta tokens beside
the prompt and the new tokens, and it decodes at ``pos0 = meta + S + i``,
the positions ``forward`` counts.  (The JAX package's batcher has no
offset, so its serve script decodes Hymba at the wrong positions.)

Without ``--device`` it runs on the card and raises if there is none.
Prompts of 4-15 tokens come from ``numpy.random.default_rng(0)``, as in
the JAX package's serve script; the weights from a ``torch.Generator``
seeded 0 on the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .._device import device_label, resolve_device
from ..configs import registry
from ..models import transformer as tf
from ..serving.scheduler import ContinuousBatcher, Request, SchedulerConfig
from ..training.train_loop import make_serve_steps


def build(arch: str, *, smoke: bool = False, device=None,
          n_layers: int | None = None):
    """The config (or its smoke reduction, cut to ``n_layers`` if given)
    and random parameters on ``device`` (None: the card), drawn from a
    generator seeded 0."""
    dev = resolve_device(device)
    cfg = registry.smoke(arch) if smoke else registry.get(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, tf.init_params(gen, cfg)


def random_prompts(cfg, n: int, lo: int, hi: int):
    """``n`` prompts of ``lo <= length < hi`` random token ids, from
    ``numpy.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, int(rng.integers(lo, hi)))
            for _ in range(n)]


def serve(cfg, params, prompts, max_new: int, *, device=None) -> dict:
    """Serve ``prompts`` through a :class:`ContinuousBatcher` of 4 slots;
    returns the requests and the host-clock time spent in prefill and in
    decode calls (each call ends in a device synchronisation)."""
    if cfg.out_heads > 1:
        raise ValueError(f"{cfg.name} has {cfg.out_heads} codebook heads: "
                         f"the scheduler's greedy argmax feeds back one "
                         f"token id, which only a single head defines")
    dev = resolve_device(device)
    prefill, decode = make_serve_steps(cfg)
    spent = {"prefill": 0.0, "decode": 0.0}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(name, fn):
        def call(*a):
            sync()
            t0 = time.perf_counter()
            out = fn(*a)
            sync()
            spent[name] += time.perf_counter() - t0
            return out
        return call

    batcher = ContinuousBatcher(
        SchedulerConfig(max_batch=4),
        prefill_step=timed("prefill", lambda c, b: prefill(params, c, b)),
        decode_step=timed("decode", lambda c, t, p: decode(
            params, c, tokens=t, pos0=p)),
        init_cache=lambda b, cap: tf.init_cache(cfg, b, cap, dev),
        device=dev, pos_offset=cfg.meta_tokens)
    reqs = [Request(rid=i, tokens=np.asarray(p), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        batcher.submit(r)
    t0 = time.perf_counter()
    done = batcher.drain()
    wall = time.perf_counter() - t0
    return {"requests": reqs, "done": done, "wall_s": wall,
            "prefill_s": spent["prefill"], "decode_s": spent["decode"],
            "prefill_tokens": sum(len(r.tokens) for r in reqs),
            # the first token of a request comes from its prefill
            "decode_tokens": sum(len(r.out) - 1 for r in reqs)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, params = build(args.arch, smoke=args.smoke, device=dev,
                        n_layers=args.layers)
    prompts = random_prompts(cfg, args.requests, 4, 16)
    r = serve(cfg, params, prompts, args.max_new, device=dev)
    print(f"[serve] {cfg.name} on {device_label(dev)}: {r['done']} "
          f"requests, {r['prefill_tokens']} prompt tokens in "
          f"{r['prefill_s']:.3f} s "
          f"({r['prefill_tokens'] / r['prefill_s']:.1f} tok/s), "
          f"{r['decode_tokens']} decoded tokens in {r['decode_s']:.3f} s "
          f"({r['decode_tokens'] / max(r['decode_s'], 1e-9):.1f} tok/s), "
          f"wall {r['wall_s']:.2f} s")
    return r


if __name__ == "__main__":
    main()
