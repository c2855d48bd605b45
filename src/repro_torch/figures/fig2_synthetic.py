"""Paper Fig. 2: latency improvement vs the §5.1 baselines on the synthetic
workload.

100 objects, Zipf 0.9, sizes U[1,100] MB, C = 500 MB, miss latency
L + c*size with Exponential realizations, Poisson and Pareto arrivals;
30,000 requests (100,000 and three values of L with ``--full``).  Per
(arrival, L) cell one grid runs the 11-policy roster with the recency
residual and one the rate residual's three policies, each over the
``--seeds`` trace replicas."""
from __future__ import annotations

import argparse

import torch

from ..core import PolicyParams
from ..data.traces import SyntheticSpec, synthetic_trace
from .common import POLICY_SET, emit, sweep_improvement_table


def run(full: bool = False, seed: int = 0, n_seeds: int = 1, device=None,
        use_kernel=None, n_requests: int | None = None,
        counters: dict | None = None,
        grids: list | None = None) -> list[dict]:
    """The figure's rows; ``n_requests`` cuts it to size, ``counters``
    and ``grids`` are passed to every grid."""
    n_req = n_requests or (100_000 if full else 30_000)
    rows = []
    for arrival in ("poisson", "pareto"):
        for latency_base in ((0.001, 0.005, 0.02) if full else (0.005,)):
            spec = SyntheticSpec(
                n_objects=100, n_requests=n_req, zipf_alpha=0.9,
                rate=2000.0, arrival=arrival, latency_base=latency_base,
                latency_per_mb=2e-4, stochastic=True)
            # CPU generators: the same traces on every device
            traces = [synthetic_trace(torch.Generator().manual_seed(seed + s),
                                      spec, device=device)
                      for s in range(n_seeds)]
            kw = dict(device=device, use_kernel=use_kernel,
                      counters=counters, grids=grids)
            # the paper's substrate (recency residual, online z)
            rows += sweep_improvement_table(
                traces, 500.0, policies=POLICY_SET,
                params=PolicyParams(omega=1.0, resid="recency"),
                extra=dict(arrival=arrival, latency_base=latency_base,
                           n_requests=n_req, resid="recency"), **kw)
            # beyond the paper: the rate residual
            rows += sweep_improvement_table(
                traces, 500.0, policies=["lac", "vacdh", "stoch_vacdh"],
                params=PolicyParams(omega=1.0, resid="rate"),
                extra=dict(arrival=arrival, latency_base=latency_base,
                           n_requests=n_req, resid="rate"), **kw)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seeds", type=int, default=1,
                    help="trace replicas per cell (one grid)")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions there (default: "
                         "the card)")
    args = ap.parse_args()
    emit(run(full=args.full, n_seeds=args.seeds, device=args.device),
         "fig2_synthetic")


if __name__ == "__main__":
    main()
