"""Paper Fig. 5: latency improvement on the four surrogate traces, the
cache at 10% of each surrogate's footprint (5%, 10%, 20% with ``--full``)
and L = 5 ms (2, 5, 20 ms with ``--full``); 40,000 requests each
(200,000 with ``--full``).  Per surrogate and L, one grid runs the
11-policy roster with the recency residual over the capacities, one the
rate residual's three policies.  The reference pads every surrogate to
one universe to share a compiled graph; nothing here compiles, so each
keeps its own."""
from __future__ import annotations

import argparse

from ..core import PolicyParams
from ..data.traces import SURROGATES, surrogate_trace
from .common import POLICY_SET, emit, sweep_improvement_table


def run(full: bool = False, device=None,
        n_requests: int | None = None) -> list[dict]:
    rows = []
    n_req = n_requests or (200_000 if full else 40_000)
    for name in SURROGATES:
        ratios = (0.05, 0.1, 0.2) if full else (0.1,)
        for lb in ((0.002, 0.005, 0.02) if full else (0.005,)):
            tr = surrogate_trace(name, device=device, latency_base=lb,
                                 n_requests=n_req)
            # latency overrides keep the sizes; summed on the CPU, so the
            # capacities are the same on every device
            footprint = float(tr.sizes.cpu().sum())
            capacities = [r * footprint for r in ratios]
            common = dict(trace=name, latency_base=lb,
                          footprint_mb=round(footprint, 1))
            kw = dict(device=device)
            rows += sweep_improvement_table(
                tr, capacities, policies=POLICY_SET,
                params=PolicyParams(omega=1.0, resid="recency"),
                extra=dict(resid="recency", **common), **kw)
            rows += sweep_improvement_table(
                tr, capacities, policies=["lac", "vacdh", "stoch_vacdh"],
                params=PolicyParams(omega=1.0, resid="rate"),
                extra=dict(resid="rate", **common), **kw)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    emit(run(full=args.full, device=args.device), "fig5_real_traces")


if __name__ == "__main__":
    main()
