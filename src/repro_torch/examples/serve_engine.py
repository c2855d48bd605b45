"""End-to-end serving driver on the port: batched requests against a real
(smoke-scale) model through the continuous batcher, plus a policy A/B on
the delayed-hit prefix cache with stochastic prefill latency.

    PYTHONPATH=src python -m repro_torch.examples.serve_engine   # the card
    PYTHONPATH=src python -m repro_torch.examples.serve_engine --device cpu

The model's weights come from a ``torch.Generator`` on the device seeded
0; the prompts and the A/B trace from ``numpy.random.default_rng`` seeded
0 and 1, as in the JAX script.  Its prefill runs the ``flash_attention``
kernel and its decode the ``decode_attention`` kernel; eq. 16's
admissions rank through the ranking kernel and the cache's mirror is
flushed by the lane scatter.  The steps run eagerly (the JAX script
compiles them), so the real-model line gives the first prefill call, which
pays the first use of the kernels (loading, and building them if no build
is cached), apart from the rest.
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
from ..serving.engine import LatencyModel, ServeEngine
from ..serving.scheduler import ContinuousBatcher, Request, SchedulerConfig
from ..training.train_loop import make_serve_steps

ARCH = "stablelm-1.6b"
N_PROMPTS = 8
MAX_NEW = 8
AB_POLICIES = ("lru", "lhd", "vacdh", "stoch_vacdh")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def smoke_model(device=None, use_kernel=None, dtype: str | None = None):
    """The demo's config (smoke StableLM, ``dtype`` replacing its own) and
    its weights, drawn from a generator on the device seeded 0."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(
        registry.smoke(ARCH), use_kernel=True if use_kernel is None
        else use_kernel, **({} if dtype is None else {"dtype": dtype}))
    return cfg, tf.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)


def real_model_demo(device=None, use_kernel=None, *, params=None,
                    dtype: str | None = None) -> dict:
    """The smoke model behind a 4-slot batcher: 8 prompts of 4-11 tokens,
    8 new tokens each.  ``params`` (the port's tree) replaces the seeded
    weights."""
    dev = resolve_device(device)
    cfg, seeded = smoke_model(dev, use_kernel, dtype)
    params = seeded if params is None else params
    prefill, decode = make_serve_steps(cfg)
    first = []

    def prefill_step(c, b):
        out = prefill(params, c, b)
        if not first:
            _sync(dev)
            first.append(time.perf_counter())
        return out

    batcher = ContinuousBatcher(
        SchedulerConfig(max_batch=4), prefill_step=prefill_step,
        decode_step=lambda c, t, p: decode(params, c, tokens=t, pos0=p),
        init_cache=lambda b, cap: tf.init_cache(cfg, b, cap, dev),
        device=dev)
    rng = np.random.default_rng(0)
    _sync(dev)
    t0 = time.perf_counter()
    reqs = []
    for i in range(N_PROMPTS):
        toks = rng.integers(0, cfg.vocab, rng.integers(4, 12))
        reqs.append(Request(rid=i, tokens=toks, max_new=MAX_NEW))
        batcher.submit(reqs[-1])
    done = batcher.drain()
    _sync(dev)
    t1 = time.perf_counter()
    tokens = done * MAX_NEW
    return dict(done=done, tokens=tokens, wall_s=t1 - t0,
                tok_s=tokens / (t1 - t0), first_call_s=first[0] - t0,
                later_tok_s=(tokens - 1) / (t1 - first[0]),
                prompts=[r.tokens for r in reqs],
                outputs=[list(r.out) for r in reqs], where=device_label(dev))


def ab_trace(n_requests: int = 20_000, n_prefix: int = 200):
    """The A/B's requests: Poisson arrivals (mean gap 2 ms) over
    ``n_prefix`` Zipf(0.9) prefixes of 128-4095 tokens, from
    ``numpy.random.default_rng(1)``."""
    rng = np.random.default_rng(1)
    probs = (np.arange(1, n_prefix + 1) ** -0.9)
    probs /= probs.sum()
    lengths = rng.integers(128, 4096, n_prefix)
    times, keys, lens = [], [], []
    t = 0.0
    for _ in range(n_requests):
        t += rng.exponential(0.002)
        k = int(rng.choice(n_prefix, p=probs))
        times.append(t); keys.append(f"p{k}"); lens.append(int(lengths[k]))
    return times, keys, lens


def policy_ab_demo(device=None, use_kernel=None, *, n_requests: int = 20_000,
                   n_prefix: int = 200) -> dict:
    """Each policy's ``EngineStats`` over the same trace."""
    dev = resolve_device(device)
    times, keys, lens = ab_trace(n_requests, n_prefix)
    out = {}
    for policy in AB_POLICIES:
        eng = ServeEngine(capacity=60_000.0, policy=policy,
                          latency=LatencyModel(base_s=0.03, per_token_s=2e-5),
                          state_size_fn=lambda n: float(n), seed=7,
                          device=dev, use_kernel=use_kernel)
        out[policy] = eng.run_trace(times, keys, lens).as_dict()
    return out


def run(device=None, use_kernel=None, *, n_requests: int = 20_000,
        n_prefix: int = 200, params=None, dtype: str | None = None) -> dict:
    """Both demos' numbers.  ``use_kernel`` goes to the model's attention
    (True or 'ref'; None is True) and to the prefix cache's scoring."""
    return dict(
        real_model=real_model_demo(device, use_kernel, params=params,
                                   dtype=dtype),
        ab=policy_ab_demo(device, use_kernel, n_requests=n_requests,
                          n_prefix=n_prefix),
        n_requests=n_requests, n_prefix=n_prefix)


def report(out: dict) -> None:
    r = out["real_model"]
    print(f"[real model] served {r['done']} requests, {r['tokens']} tokens "
          f"in {r['wall_s']:.2f}s ({r['tok_s']:.1f} tok/s on "
          f"{r['where']} smoke model; the first prefill call "
          f"{r['first_call_s']:.2f}s, the other "
          f"{r['tokens'] - 1} tokens {r['later_tok_s']:.1f} tok/s)")
    print(f"[prefix cache A/B] {out['n_requests'] / 1000:g}k requests, "
          f"{out['n_prefix']} Zipf prefixes, stochastic prefill latency:")
    for policy, s in out["ab"].items():
        print(f"  {policy:12s} total_latency={s['total_latency']:9.2f}s "
              f"hits={s['hits']:6d} delayed={s['delayed_hits']:5d} "
              f"misses={s['misses']:5d} hedges={s['hedges']}")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    out = run(device=args.device)
    report(out)
    return out


if __name__ == "__main__":
    main()
