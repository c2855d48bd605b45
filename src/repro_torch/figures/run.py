"""Figure driver: one job per paper figure, run on the card unless
``--device cpu``.

    python3 -m repro_torch.figures.run [--only fig2,fig3,fig4,fig5,fig6]
        [--full] [--compare] [--device cpu]

Prints each job's rows as CSV lines and writes them to
``repro_torch/figures/results/<job>.csv``; ``--compare`` adds fig4's and
fig6's per-point-loop vs grid timings (``fig4_sweep_speedup.csv``,
``fig6_sweep_speedup.csv``).  Prints the
card's name and power limit first when it runs on one.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time

JOBS = ("fig3", "fig2", "fig4", "fig5", "fig6")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma list of " + ",".join(JOBS))
    ap.add_argument("--full", action="store_true",
                    help="paper-scale sizes (slower)")
    ap.add_argument("--compare", action="store_true",
                    help="with fig4 and fig6: time the per-point loop vs "
                         "the grids")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions on the CPU "
                         "(default: the card)")
    args = ap.parse_args(argv)
    want = set(args.only.split(",")) if args.only else set(JOBS)
    unknown = want - set(JOBS)
    if unknown:
        ap.error(f"unknown jobs {sorted(unknown)}; known: {list(JOBS)}")

    from .._device import resolve_device
    from . import (fig2_synthetic, fig3_trace_stats, fig4_sensitivity,
                   fig5_real_traces, fig6_hierarchy)
    from .common import emit

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(smi.stdout.strip(), flush=True)
    d, full = args.device, args.full
    fig6_timings = []
    jobs = {
        "fig3": lambda: emit(fig3_trace_stats.run(device=d),
                             "fig3_trace_stats"),
        "fig2": lambda: emit(fig2_synthetic.run(full=full, device=d),
                             "fig2_synthetic"),
        "fig4": lambda: emit(fig4_sensitivity.run(full=full, device=d),
                             "fig4_sensitivity"),
        "fig5": lambda: emit(fig5_real_traces.run(full=full, device=d),
                             "fig5_real_traces"),
        "fig6": lambda: emit(fig6_hierarchy.run(
            full=full, compare=args.compare, device=d,
            timings=fig6_timings), "fig6_hierarchy"),
    }
    for name in JOBS:
        if name not in want:
            continue
        print(f"\n=== {name} ===", flush=True)
        t0 = time.perf_counter()
        jobs[name]()
        if name == "fig4" and args.compare:
            emit(fig4_sensitivity.run_compare(full=full, device=d),
                 "fig4_sweep_speedup")
        if name == "fig6" and args.compare:
            emit(fig6_timings, "fig6_sweep_speedup")
        print(f"[{name}] done in {time.perf_counter() - t0:.1f}s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
