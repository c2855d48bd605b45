"""Paper Fig. 4: sensitivity to omega (the variance weight) and to the
estimation window (the per-object EWMA factor 1/W), L = 5 ms as in §5.4;
beyond the paper, the residual estimator and ranking with matched vs
mismatched miss-latency laws on Erlang / hyperexponential traces.

Each sweep is one :func:`repro_torch.core.sweep_grid` call.  ``--compare``
times the per-point loop (one ``simulate`` call per point) against the
grids over the omega and window sweeps."""
from __future__ import annotations

import argparse
import time

import torch

from ..core import Erlang, Hyperexponential, PolicyParams
from ..data.traces import SyntheticSpec, synthetic_trace
from .common import emit, improvement_table, sweep_improvement_table


def _spec(n_req: int, **kw) -> SyntheticSpec:
    return SyntheticSpec(n_objects=100, n_requests=n_req, rate=2000.0,
                         latency_base=0.005, latency_per_mb=2e-4,
                         stochastic=True, **kw)


def _grids(full: bool):
    omegas = (0.0, 0.25, 0.5, 1.0, 2.0, 4.0) if full else (0.0, 1.0, 2.0)
    windows = (4, 16, 64, 256, 1024) if full else (4, 64, 1024)
    return omegas, windows


def _omega_window(trace, omegas, windows, kw) -> list[dict]:
    rows = sweep_improvement_table(
        trace, 500.0, policies=["vacdh", "stoch_vacdh"],
        params=[PolicyParams(omega=o) for o in omegas],
        extra=dict(sweep="omega"),
        extra_fn=lambda p: dict(omega=p.omega, window=p.window), **kw)
    rows += sweep_improvement_table(
        trace, 500.0, policies=["stoch_vacdh"],
        params=[PolicyParams(omega=1.0, window=w) for w in windows],
        extra=dict(sweep="window"),
        extra_fn=lambda p: dict(omega=p.omega, window=p.window), **kw)
    return rows


def run(full: bool = False, seed: int = 0, device=None,
        n_requests: int | None = None) -> list[dict]:
    n_req = n_requests or (100_000 if full else 30_000)
    trace = synthetic_trace(torch.Generator().manual_seed(seed),
                            _spec(n_req), device=device)
    omegas, windows = _grids(full)
    kw = dict(device=device)
    rows = _omega_window(trace, omegas, windows, kw)
    # residual-estimator ablation: both estimators on one params axis
    rows += sweep_improvement_table(
        trace, 500.0, policies=["stoch_vacdh", "vacdh", "lac"],
        params=[PolicyParams(omega=1.0, resid=m)
                for m in ("rate", "recency")],
        extra=dict(sweep="resid", omega=1.0, window=64),
        extra_fn=lambda p: dict(
            resid="rate" if float(p.resid_rate) > 0.5 else "recency"), **kw)
    # distribution sensitivity: the trace's latency follows Erlang /
    # hyperexponential; rank with the Exponential-equivalent law vs the
    # matched one through the same eq.-16 form
    dist_pairs = (
        ("erlang", dict(k=3), [Erlang(k=1.0), Erlang(k=3.0)]),
        ("hyperexp", dict(p=0.9, mu_fast=0.3),
         [Hyperexponential(p=0.9, mu_fast=1.0),
          Hyperexponential(p=0.9, mu_fast=0.3)]),
    )
    for dist_name, dkw, assumed in dist_pairs:
        tr = synthetic_trace(
            torch.Generator().manual_seed(seed),
            _spec(n_req, latency_dist=dist_name,
                  dist_kwargs=tuple(dkw.items())), device=device)
        labels = {0: "exponential-equivalent", 1: dist_name}
        idx = {id(d): i for i, d in enumerate(assumed)}
        rows += sweep_improvement_table(
            tr, 500.0, policies=["stoch_vacdh"],
            params=[PolicyParams(omega=1.0, dist=d) for d in assumed],
            extra=dict(sweep="dist", trace_dist=dist_name, omega=1.0,
                       window=64),
            extra_fn=lambda p, labels=labels, idx=idx: dict(
                assumed_dist=labels[idx[id(p.dist)]]), **kw)
    return rows


def run_compare(full: bool = False, seed: int = 0, device=None,
                n_requests: int | None = None) -> list[dict]:
    """Wall time of the omega and window sweeps as one ``simulate`` call
    per point (LRU once per params point, as improvement_table runs it)
    against the grids, each ending in a device sync."""
    n_req = n_requests or (100_000 if full else 30_000)
    trace = synthetic_trace(torch.Generator().manual_seed(seed),
                            _spec(n_req), device=device)
    omegas, windows = _grids(full)
    kw = dict(device=device)

    def per_point():
        rows = []
        for omega in omegas:
            rows += improvement_table(
                trace, 500.0, policies=["vacdh", "stoch_vacdh"],
                params=PolicyParams(omega=omega),
                extra=dict(sweep="omega", omega=omega, window=64), **kw)
        for w in windows:
            rows += improvement_table(
                trace, 500.0, policies=["stoch_vacdh"],
                params=PolicyParams(omega=1.0, window=w),
                extra=dict(sweep="window", omega=1.0, window=w), **kw)
        return rows

    out = []
    for name, fn in (("per_point_simulate", per_point),
                     ("sweep_grid", lambda: _omega_window(
                         trace, omegas, windows, kw))):
        t0 = time.perf_counter()
        rows = fn()
        dt = time.perf_counter() - t0
        out.append(dict(path=name, wall_s=round(dt, 2), n_rows=len(rows),
                        n_req=n_req))
    out.append(dict(path="speedup",
                    wall_s=round(out[0]["wall_s"] / out[1]["wall_s"], 2),
                    n_rows=0, n_req=n_req))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--compare", action="store_true",
                    help="time the per-point loop against the grids")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    if args.compare:
        emit(run_compare(full=args.full, device=args.device),
             "fig4_sweep_speedup")
    else:
        emit(run(full=args.full, device=args.device), "fig4_sensitivity")


if __name__ == "__main__":
    main()
