"""Quickstart: the paper in 60 seconds, on the port.

1. Validate Theorem 2 against Monte Carlo.
2. Run the delayed-hit cache simulator on a synthetic Zipf trace with
   stochastic fetch latency, comparing the paper's variance-aware policy
   (eq. 16) against LRU and VA-CDH.
3. Go beyond the paper: aggregate-delay moments for Erlang / hyper-
   exponential fetch latency through the pluggable distribution layer.

    PYTHONPATH=src python -m repro_torch.examples.quickstart    # the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The Monte-Carlo draws and the trace come from ``torch.Generator``s on the
device, seeded 0 and 1, so the numbers match the JAX script's in
distribution, not draw for draw.  Eq. 16 under the Exponential law ranks
through the ranking kernel; under Erlang moments it takes the epilogue,
and its line says so.
"""
from __future__ import annotations

import argparse

import torch

from .._device import resolve_device
from ..core import (Erlang, Exponential, Hyperexponential, PolicyParams,
                    Trace, resolve_score_mode, simulate, stoch_mean,
                    stoch_var)
from ..core.delay_stats import mc_moments
from ..core.simulator import ranks_through_kernel
from ..data.traces import SyntheticSpec, synthetic_trace
from . import result_row

POLICIES = ("lru", "vacdh", "stoch_vacdh")
LAM, Z = 5.0, 0.3
CAPACITY = 500.0


def score_route(policy: str, params: PolicyParams, use_kernel,
                dev: torch.device) -> str:
    """How ``simulate`` scores a lane of ``policy`` under ``params``."""
    mode = resolve_score_mode(use_kernel, dev)
    if not ranks_through_kernel(policy, params, mode):
        return "epilogue"
    return "ranking kernel" if mode == "kernel" else "plain ranking"


def run(device=None, use_kernel=None, *, n_mc: int = 200_000,
        n_requests: int = 30_000, trace: Trace | None = None,
        counters: dict | None = None) -> dict:
    """Every number the script prints.  ``trace`` replaces the synthetic
    trace (then ``n_requests`` is unused); ``counters`` accumulates the
    replays' counters (:func:`repro_torch.core.simulate`)."""
    dev = resolve_device(device)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    m_mc, v_mc = mc_moments(gen(0), LAM, Z, n=n_mc)
    out = {"theorem2": dict(mean=float(stoch_mean(LAM, Z)),
                            mean_mc=float(m_mc), var=float(stoch_var(LAM, Z)),
                            var_mc=float(v_mc))}

    if trace is None:
        spec = SyntheticSpec(n_objects=100, n_requests=n_requests,
                             rate=2000.0, latency_base=0.005,
                             latency_per_mb=2e-4, stochastic=True)
        trace = synthetic_trace(gen(1), spec, device=dev)
    params = PolicyParams(omega=1.0)
    sim = {}
    for pol in POLICIES:
        r = simulate(trace, CAPACITY, pol, params, use_kernel=use_kernel,
                     device=dev, counters=counters)
        sim[pol] = dict(result_row(r),
                        route=score_route(pol, params, use_kernel, dev))
    out["sim"] = sim
    out["improvement"] = ((sim["lru"]["total_latency"]
                           - sim["stoch_vacdh"]["total_latency"])
                          / sim["lru"]["total_latency"])

    laws = (Exponential(), Erlang(k=3.0), Hyperexponential(p=0.9,
                                                           mu_fast=0.3))
    out["laws"] = [dict(name=d.name, agg_mean=float(d.agg_mean(LAM, Z)),
                        agg_var=float(d.agg_var(LAM, Z))) for d in laws]
    erl = PolicyParams(omega=1.0, dist=Erlang(k=3.0))
    r = simulate(trace, CAPACITY, "stoch_vacdh", erl, use_kernel=use_kernel,
                 device=dev, counters=counters)
    out["erlang"] = dict(result_row(r), route=score_route(
        "stoch_vacdh", erl, use_kernel, dev))
    return out


def report(out: dict) -> None:
    t2 = out["theorem2"]
    print(f"Theorem 2 (lambda={LAM:g}, z={Z:g}):")
    print(f"  E[D]  analytic={t2['mean']:.4f}  "
          f"monte-carlo={t2['mean_mc']:.4f}")
    print(f"  VarD  analytic={t2['var']:.4f}  monte-carlo={t2['var_mc']:.4f}")
    print("\nSynthetic Zipf trace, C=500MB, Exp fetch latency:")
    for pol, s in out["sim"].items():
        print(f"  {pol:12s} total_latency={s['total_latency']:10.2f}s  "
              f"hit_ratio={s['hit_ratio']:.3f}  "
              f"delayed={s['n_delayed']}")
    print(f"\nOurs vs LRU: {out['improvement']:.1%} latency reduction "
          f"(paper reports 3-30% on synthetic data)")
    print(f"\nAggregate-delay moments beyond Theorem 2 (lambda={LAM:g}, "
          f"z={Z:g}):")
    for d in out["laws"]:
        print(f"  {d['name']:12s} E[D]={d['agg_mean']:7.4f}  "
              f"Var[D]={d['agg_var']:8.4f}")
    e = out["erlang"]
    print(f"  eq. 16 ranked with Erlang(3) moments: "
          f"total_latency={e['total_latency']:.2f}s  (scored by the "
          f"{e['route']}; the ranking kernel takes the Exponential law)")


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
