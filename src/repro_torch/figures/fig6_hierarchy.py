"""Fig. 6 (beyond the paper): when does variance-aware L1 ranking pay off in
a two-tier hierarchy?

The L1's fetch law in a hierarchy is hop + R_L2(t), a state-dependent
mixture no closed form covers.  This driver sweeps

    route x hop-delay law (by CV) x n_shards x L2 capacity x L1 policy

through :func:`repro_torch.core.sweep_hier_grid` (one grid per (route,
n_shards); the hop laws are the grid's traces, which share one engine pair
since they differ only in their hop draws) and reports each policy's
improvement over an LRU L1 under the same L2.  ``compare`` times the
per-point loop (one ``simulate_hier`` call for each of a grid's points)
against the grid.  The draws come from torch generators, so the rows differ from the JAX
package's fig6 in their draws, not in their method."""
from __future__ import annotations

import argparse
import time

import torch

from ..core import (Deterministic, Erlang, Exponential, Hyperexponential,
                    PolicyParams, make_hier_trace, simulate_hier,
                    sweep_hier_grid)
from ..data.traces import SyntheticSpec, synthetic_trace
from .common import emit

POLICIES = ("lru", "vacdh", "stoch_vacdh")

# Hop-delay laws ordered by coefficient of variation (the fig6 x-axis).
HOP_DISTS = (
    ("det", Deterministic()),
    ("erlang4", Erlang(k=4.0)),
    ("exp", Exponential()),
    ("hyperexp", Hyperexponential(p=0.9, mu_fast=0.25)),
)


def _cv(dist) -> float:
    c2 = torch.as_tensor(dist.shape_moments()[1], dtype=torch.float32)
    return float(torch.sqrt(torch.clamp(c2 - 1.0, min=0.0)))


def _spec(full: bool, n_requests: int | None) -> SyntheticSpec:
    return SyntheticSpec(
        n_objects=200 if full else 120,
        n_requests=n_requests or (100_000 if full else 30_000),
        rate=2000.0, latency_base=0.02, latency_per_mb=2e-4,
        size_min=1.0, size_max=100.0, stochastic=True)


def run(full: bool = False, seed: int = 0, compare: bool = False,
        device=None, use_kernel=None, n_requests: int | None = None,
        counters: dict | None = None, grids: list | None = None,
        timings: list | None = None) -> list[dict]:
    """The figure's rows.  ``n_requests`` cuts the trace; ``use_kernel``
    and ``counters`` are passed to every grid, and ``grids``, when given,
    receives each :class:`HierSweepGrid`.  With ``compare`` each (route,
    n_shards) grid is timed against its points as ``simulate_hier``
    calls; ``timings``, when given, receives those rows."""
    spec = _spec(full, n_requests)
    base = synthetic_trace(torch.Generator().manual_seed(seed), spec,
                           device=device)
    shard_counts = (1, 2, 4, 8) if full else (1, 4)
    l1_cap = 400.0                     # per shard
    l2_caps = (0.0, 1500.0, 4000.0) if full else (0.0, 2000.0)
    hop_mean = 0.01
    params = PolicyParams(omega=1.0)

    rows: list[dict] = []
    for route in ("hash", "random"):
        for S in shard_counts:
            traces = [make_hier_trace(
                base, S, generator=torch.Generator().manual_seed(7),
                hop_mean=hop_mean, hop_dist=d, route=route)
                for _, d in HOP_DISTS]
            t0 = time.perf_counter()
            g = sweep_hier_grid(traces, S, l1_cap, l2_caps, list(POLICIES),
                                params, estimate_z=True,
                                use_kernel=use_kernel, device=device,
                                counters=counters)
            tot = g.result.total_latency.cpu()
            sweep_s = time.perf_counter() - t0
            if grids is not None:
                grids.append(g)
            lru_li = POLICIES.index("lru")
            for ti, (dname, d) in enumerate(HOP_DISTS):
                for c2i, c2 in enumerate(l2_caps):
                    lru_lat = float(tot[ti, lru_li, 0, 0, c2i, 0])
                    for li, pol in enumerate(POLICIES):
                        r = g.point(ti, li, 0, 0, c2i, 0)
                        lat = float(r.total_latency)
                        n_req = float(r.n_requests)
                        l2_arr = float(r.l2.n_hits + r.l2.n_delayed
                                       + r.l2.n_misses)
                        rows.append(dict(
                            route=route, n_shards=S, hop_dist=dname,
                            hop_cv=round(_cv(d), 3), l2_capacity=c2,
                            policy=pol, total_latency=round(lat, 4),
                            improvement_vs_lru=round(
                                (lru_lat - lat) / max(lru_lat, 1e-9), 5),
                            l1_hit_ratio=round(float(r.n_hits) / n_req, 4),
                            l2_hit_ratio=round(
                                float(r.l2.n_hits) / max(l2_arr, 1.0), 4),
                            sweep_s=round(sweep_s, 2)))
            if compare:
                t0 = time.perf_counter()
                for tr in traces:
                    for pol in POLICIES:
                        for c2 in l2_caps:
                            r = simulate_hier(tr, S, l1_cap, c2, pol,
                                              params=params,
                                              use_kernel=use_kernel,
                                              device=device)
                            r.per_shard.total_latency.cpu()
                loop_s = time.perf_counter() - t0
                n_pts = len(traces) * len(POLICIES) * len(l2_caps)
                print(f"compare route={route} S={S}: grid {sweep_s:.2f}s "
                      f"vs per-point {loop_s:.2f}s for {n_pts} points",
                      flush=True)
                if timings is not None:
                    timings.append(dict(
                        route=route, n_shards=S, grid_s=round(sweep_s, 2),
                        per_point_s=round(loop_s, 2), n_points=n_pts,
                        speedup=round(loop_s / sweep_s, 2),
                        n_req=spec.n_requests))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--compare", action="store_true",
                    help="also time the per-point loop")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    timings = []
    emit(run(full=args.full, compare=args.compare, device=args.device,
             timings=timings), "fig6_hierarchy")
    if args.compare:
        emit(timings, "fig6_sweep_speedup")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
