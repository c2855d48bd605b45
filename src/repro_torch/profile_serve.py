#!/usr/bin/env python3
"""Where the port's LM serve path spends its time on the card.

    PYTHONPATH=src python3 -m repro_torch.profile_serve [--arch xlstm-350m]

Builds ``--arch`` (default StableLM-2-1.6B, ``stablelm-1.6b``) at full
width with random weights (bf16), then for one request of 2048 prompt
tokens times its
prefill and 32 decode steps (host clock, each step ending in the
scheduler's host argmax) and profiles the same work again with
``torch.profiler``.  Prints one JSON
line per phase (prefill, decode) with:

- wall seconds, tokens per second, and per-step milliseconds;
- device busy seconds (summed CUDA kernel and copy time of the profiled
  run) and the idle share ``1 - busy / wall`` against the unprofiled wall;
- the share of the device time in the port's own kernels (attention and
  GLA), and the top device operations by time.

A config with meta tokens (Hymba) is prefilled and decoded at
``pos0 = meta + S + i``, as ``forward`` counts positions.

Prints the card's name and power limit (as nvidia-smi gives them) first.
Needs one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

PROMPT, DECODE = 2048, 32
# the port's LM kernels, by their CUDA function names (every __global__
# function of csrc/flash_attention.cu, decode_attention.cu, gla_chunk.cu)
KERNELS = ("flash_kernel", "flash_mma_kernel", "decode_split_kernel",
           "gla_kernel", "gla_state_kernel", "gla_scan_kernel",
           "gla_score_kernel", "gla_out_kernel")


def is_port_kernel(op: str) -> bool:
    """Whether a profiler op name (``void (anonymous namespace)::name<...>
    (...)``, or ``::name(...)`` for a kernel that is no template) is one of
    :data:`KERNELS`."""
    return any(f"::{n}<" in op or f"::{n}(" in op for n in KERNELS)


def _run(params, cfg, tokens, n_decode):
    """One request: prefill, then ``n_decode`` greedy decode steps; returns
    (prefill seconds, decode seconds)."""
    import torch
    from .models import transformer as tf
    from .training.train_loop import make_serve_steps
    prefill, decode = make_serve_steps(cfg)
    s = cfg.meta_tokens + tokens.shape[1]
    cache = tf.init_cache(cfg, 1, s + n_decode + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cache, {"tokens": tokens})
    nxt = int(torch.argmax(logits[0, -1]))
    t1 = time.perf_counter()
    for j in range(n_decode):
        tok = torch.tensor([[nxt]], device="cuda")
        logits, cache = decode(params, cache, tokens=tok, pos0=s + j)
        nxt = int(torch.argmax(logits[0, -1]))
    t2 = time.perf_counter()
    return t1 - t0, t2 - t1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="stablelm-1.6b")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    from .launch.serve import build
    from .profile_replay import _device_seconds

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    cfg, params = build(args.arch)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (1, PROMPT)),
                             device="cuda")
    _run(params, cfg, tokens, 2)                          # warm-up
    wall = _run(params, cfg, tokens, DECODE)
    busy = []
    for phase in range(2):
        # profile the prefill alone, then a whole request (its decode part
        # is the difference)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _run(params, cfg, tokens, DECODE if phase else 0)
            torch.cuda.synchronize()
        ops = {}
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                ops[e.key] = (e.self_device_time_total / 1e6, e.count)
        busy.append((_device_seconds(prof), ops))
    for name, (w, n_tok) in (("prefill", (wall[0], PROMPT)),
                             ("decode", (wall[1], DECODE))):
        if name == "prefill":
            b, ops = busy[0]
        else:
            b = busy[1][0] - busy[0][0]
            ops = {k: (s - busy[0][1].get(k, (0.0, 0))[0],
                       c - busy[0][1].get(k, (0.0, 0))[1])
                   for k, (s, c) in busy[1][1].items()}
        mine = sum(s for k, (s, _) in ops.items() if is_port_kernel(k))
        top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:8]
        print(json.dumps({
            "phase": name, "arch": cfg.name, "tokens": n_tok,
            "wall_s": w, "tokens_per_s": n_tok / w,
            "ms_per_step": w * 1e3 / (1 if name == "prefill" else n_tok),
            "device_busy_s": b, "idle_share": 1.0 - b / w,
            "port_kernels_s": mine,
            "top_device_ops": [{"op": k[:80], "s": s, "count": c}
                               for k, (s, c) in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
