"""Trace-driven cache policy comparison (the paper's §5 experiment driver)
on the port.

    PYTHONPATH=src python -m repro_torch.examples.trace_sim --trace wiki2018 \\
        --policies lru,lhd,vacdh,stoch_vacdh --capacity-frac 0.1
    PYTHONPATH=src python -m repro_torch.examples.trace_sim --device cpu \\
        --n-requests 2000

The surrogate is the port's (:func:`repro_torch.data.traces.surrogate_trace`,
seeded by the CRC-32 of its name), so its numbers differ from a JAX run,
whose surrogate seed is Python's per-process ``hash`` of the name.  One
``simulate`` a policy, each with ``estimate_z=True``.
"""
from __future__ import annotations

import argparse

from .._device import resolve_device
from ..core import PolicyParams, Trace, simulate
from ..data.traces import SURROGATES, surrogate_trace
from . import result_row

DEFAULT_POLICIES = "lru,lfu,lhd,lac,cala,vacdh,stoch_vacdh"


def run(device=None, use_kernel=None, *, trace_name: str = "wiki2018",
        policies: str = DEFAULT_POLICIES, capacity_frac: float = 0.1,
        n_requests: int = 50_000, omega: float = 1.0,
        resid: str = "recency", trace: Trace | None = None,
        counters: dict | None = None) -> dict:
    """Every number the script prints.  ``trace`` replaces the surrogate
    (then ``n_requests`` is unused); ``counters`` accumulates the replays'
    counters."""
    dev = resolve_device(device)
    if trace is None:
        trace = surrogate_trace(trace_name, n_requests=n_requests,
                                device=dev)
    # the script's footprint: numpy's f32 sum of the sizes
    cap = capacity_frac * float(trace.sizes.cpu().numpy().sum())
    params = PolicyParams(omega=omega, resid=resid)
    rows, base = {}, None
    for pol in policies.split(","):
        r = simulate(trace, cap, pol, params, estimate_z=True,
                     use_kernel=use_kernel, device=dev, counters=counters)
        lat = float(r.total_latency)
        if pol == "lru":
            base = lat
        rows[pol] = dict(result_row(r),
                         improvement=(base - lat) / base if base else None)
    return dict(trace=trace_name, n_requests=trace.n_requests,
                n_objects=trace.n_objects, capacity=cap, resid=resid,
                policies=rows)


def report(out: dict) -> None:
    print(f"trace={out['trace']} requests={out['n_requests']} "
          f"objects={out['n_objects']} capacity={out['capacity']:.0f}MB "
          f"resid={out['resid']}")
    for pol, r in out["policies"].items():
        imp = r["improvement"]
        imp = "" if imp is None else f" improvement={imp:+.2%}"
        print(f"  {pol:12s} latency={r['total_latency']:10.2f}s "
              f"hit={r['hit_ratio']:.3f} "
              f"delayed={r['n_delayed']:6d} evict={r['n_evictions']:6d}"
              f"{imp}")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", default="wiki2018", choices=list(SURROGATES))
    ap.add_argument("--policies", default=DEFAULT_POLICIES)
    ap.add_argument("--capacity-frac", type=float, default=0.1)
    ap.add_argument("--n-requests", type=int, default=50_000)
    ap.add_argument("--omega", type=float, default=1.0)
    ap.add_argument("--resid", default="recency", choices=["recency", "rate"])
    ap.add_argument("--device", default=None)
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    out = run(device=args.device, trace_name=args.trace,
              policies=args.policies, capacity_frac=args.capacity_frac,
              n_requests=args.n_requests, omega=args.omega,
              resid=args.resid)
    report(out)
    return out


if __name__ == "__main__":
    main()
