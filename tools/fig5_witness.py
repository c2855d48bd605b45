"""Two CPU readings that tell a fault of the port's fig5 from the
surrogates' calibration.

``port-traces``: the port's four surrogate traces (``repro_torch``'s
``surrogate_trace``, seeded by crc32 of the name) converted to JAX
``Trace``s and run through the JAX package's ``sweep_improvement_table``
with fig5's roster, residuals, L = 5 ms and capacity 10% of each
footprint.  Equal rows mean the port's engine is not at fault.

``jax``: the JAX package's own ``benchmarks.fig5_real_traces.run()``.
Its surrogates are seeded by ``hash(name)``, so set ``PYTHONHASHSEED`` to
pin them.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/fig5_witness.py port-traces
    PYTHONHASHSEED=0 PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/fig5_witness.py jax

Prints one line per surrogate with each policy's improvement over LRU
(recency residual, then the rate residual's trio) and, with ``--out``,
writes every row as JSON.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def port_traces(n_requests: int) -> list[dict]:
    import jax.numpy as jnp

    from benchmarks.common import POLICY_SET, sweep_improvement_table
    from repro.core import PolicyParams
    from repro.core.trace import Trace
    from repro_torch.data.traces import SURROGATES, surrogate_trace

    rows = []
    for name in SURROGATES:
        t = surrogate_trace(name, device="cpu", n_requests=n_requests,
                            latency_base=0.005)
        tr = Trace(*(jnp.asarray(getattr(t, f).numpy()) for f in
                     ("times", "objs", "sizes", "z_mean", "z_draw")))
        footprint = float(np.asarray(tr.sizes).sum())
        common = dict(trace=name, latency_base=0.005,
                      footprint_mb=round(footprint, 1))
        rows += sweep_improvement_table(
            tr, [0.1 * footprint], policies=POLICY_SET,
            params=PolicyParams(omega=1.0, resid="recency"),
            extra=dict(resid="recency", **common), unified=False)
        rows += sweep_improvement_table(
            tr, [0.1 * footprint], policies=["lac", "vacdh", "stoch_vacdh"],
            params=PolicyParams(omega=1.0, resid="rate"),
            extra=dict(resid="rate", **common), unified=False)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("port-traces", "jax"))
    ap.add_argument("--out", default=None, help="write every row as JSON")
    args = ap.parse_args()
    if args.mode == "port-traces":
        rows = port_traces(40_000)
    else:
        from benchmarks import fig5_real_traces
        rows = fig5_real_traces.run()
    print(f"mode {args.mode}, PYTHONHASHSEED "
          f"{os.environ.get('PYTHONHASHSEED', 'unset')}")
    for name in dict.fromkeys(r["trace"] for r in rows):
        cells = [f"{r['resid']}/{r['policy']} "
                 f"{r['improvement_vs_lru'] * 100:.3f}%"
                 for r in rows if r["trace"] == name]
        print(f"{name}: " + ", ".join(cells), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, default=float, indent=1)


if __name__ == "__main__":
    main()
