"""Two-tier hierarchy quickstart on the port: L1 edge shards -> shared L2
-> origin.

Runs the same Zipf workload through four L1 edge shards fronting a shared
L2, comparing the paper's variance-aware policy against LRU at the L1
tier, then shows the batched hierarchy sweep over an L2-capacity grid.

    PYTHONPATH=src python -m repro_torch.examples.hierarchy_sim   # the card
    PYTHONPATH=src python -m repro_torch.examples.hierarchy_sim --device cpu

The trace and the routing come from ``torch.Generator``s on the device,
seeded 0 and 7.  The hierarchy scores through the policies' epilogues, as
the reference does; ``use_kernel`` picks its state writes (the point
journal, or its plain version).
"""
from __future__ import annotations

import argparse

import torch

from .._device import resolve_device
from ..core import (Erlang, HierTrace, PolicyParams, make_hier_trace,
                    simulate_hier, sweep_hier_grid)
from ..data.traces import SyntheticSpec, synthetic_trace

N_SHARDS = 4
L1_CAPACITY = 400.0
L2_CAPACITY = 2000.0
POLICIES = ("lru", "vacdh", "stoch_vacdh")
L2_GRID = (0.0, 1000.0, 2000.0, 4000.0)


def make_trace(n_requests: int = 30_000, device=None) -> HierTrace:
    """The script's workload: 120 Zipf objects, 4 randomly routed shards,
    Erlang(4) hops of mean 10 ms."""
    dev = resolve_device(device)
    spec = SyntheticSpec(n_objects=120, n_requests=n_requests, rate=2000.0,
                         latency_base=0.02, latency_per_mb=2e-4,
                         stochastic=True)
    base = synthetic_trace(torch.Generator(device=dev).manual_seed(0), spec,
                           device=dev)
    # 4 edge shards, skew-oblivious routing, Erlang(4) hop delay ~ 10 ms
    return make_hier_trace(base, N_SHARDS, hop_mean=0.01,
                           hop_dist=Erlang(k=4.0), route="random",
                           generator=torch.Generator(device=dev)
                           .manual_seed(7))


def run(device=None, use_kernel=None, *, n_requests: int = 30_000,
        trace: HierTrace | None = None, counters: dict | None = None) -> dict:
    """Every number the script prints.  ``trace`` replaces the workload
    (then ``n_requests`` is unused); ``counters`` accumulates the
    replays' counters."""
    dev = resolve_device(device)
    ht = make_trace(n_requests, dev) if trace is None else trace
    single = {}
    for pol in POLICIES:
        r = simulate_hier(ht, N_SHARDS, L1_CAPACITY, L2_CAPACITY, pol,
                          l2_policy="lru", use_kernel=use_kernel, device=dev,
                          counters=counters)
        single[pol] = dict(total_latency=float(r.total_latency),
                           hit_ratio=float(r.hit_ratio),
                           l2_hits=int(r.l2.n_hits),
                           l2_delayed=int(r.l2.n_delayed), result=r)

    # the same comparison as one batched sweep over an L2-capacity grid
    g = sweep_hier_grid(ht, N_SHARDS, L1_CAPACITY, list(L2_GRID),
                        ["lru", "stoch_vacdh"], PolicyParams(omega=1.0),
                        use_kernel=use_kernel, device=dev, counters=counters)
    tot = g.result.total_latency  # [traces, policies, params, C1, C2, seeds]
    grid = []
    for c2i, c2 in enumerate(L2_GRID):
        lru = float(tot[0, 0, 0, 0, c2i, 0])
        ours = float(tot[0, 1, 0, 0, c2i, 0])
        grid.append(dict(l2_capacity=c2, lru=lru, stoch_vacdh=ours,
                         improvement=(lru - ours) / lru))
    return dict(single=single, grid=grid, sweep=g)


def report(out: dict) -> None:
    print(f"{N_SHARDS} L1 shards ({L1_CAPACITY:.0f} each) + shared L2 "
          f"({L2_CAPACITY:.0f}), origin ~ Exp:")
    for pol, r in out["single"].items():
        print(f"  {pol:12s} total latency {r['total_latency']:8.2f}  "
              f"L1 hit {r['hit_ratio']:.3f}  "
              f"L2 hits {r['l2_hits']}  "
              f"L2 delayed {r['l2_delayed']}")
    print("\nimprovement vs LRU as the shared L2 grows:")
    for row in out["grid"]:
        print(f"  L2={row['l2_capacity']:6.0f}  "
              f"{100.0 * row['improvement']:5.1f}%")


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
