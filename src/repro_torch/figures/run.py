"""Figure runner: one job per paper figure, and the benchmarks, run on
the card unless ``--device cpu``.

    python3 -m repro_torch.figures.run
        [--only fig2,fig3,fig4,fig5,fig6,kernels,sweep,serving,memory,
                realworld]
        [--full] [--smoke] [--compare] [--exact-full] [--requests N]
        [--device cpu]

Prints each job's rows as CSV lines and writes them to
``repro_torch/figures/results/<job>.csv``; ``--compare`` adds fig4's and
fig6's per-point-loop vs grid timings (``fig4_sweep_speedup.csv``,
``fig6_sweep_speedup.csv``).  ``kernels`` times the six kernels
(``bench_kernels``), ``sweep`` the grids against their loops and the
fabric (``bench_sweep``), ``serving`` the SLO bench (``bench_serving``);
each also writes ``results/<bench>.json``, and ``--smoke`` sizes
``sweep`` and ``serving`` small.  ``memory`` (the dense-vs-slots probe,
one child process a cell) and ``realworld`` (the million-request
streaming replay of ``fig_realworld``, ``results/bench_stream.json``;
``--full`` 5M requests, ``--exact-full`` the whole trace through the slot
table too, ``--requests`` a cut trace) run only when named.  Prints the card's name and power limit
first when it runs on one.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

JOBS = ("fig3", "fig2", "fig4", "fig5", "fig6", "kernels", "sweep",
        "serving", "memory", "realworld")
# jobs that run only when named
NAMED_ONLY = ("memory", "realworld")


def _memory(device) -> None:
    """The dense-vs-slots probe as a process of its own, so that its
    cells' ``ru_maxrss`` does not carry this process's peak."""
    from .probe_memory import SRC
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    cmd = [sys.executable, "-m", "repro_torch.figures.probe_memory",
           "--simstate"] + ([] if device is None else ["--device", device])
    rc = subprocess.run(cmd, env=env).returncode
    if rc != 0:
        raise RuntimeError(f"probe_memory --simstate exited {rc}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma list of " + ",".join(JOBS))
    ap.add_argument("--full", action="store_true",
                    help="paper-scale sizes (slower)")
    ap.add_argument("--smoke", action="store_true",
                    help="sweep and serving at small sizes")
    ap.add_argument("--compare", action="store_true",
                    help="with fig4 and fig6: time the per-point loop vs "
                         "the grids")
    ap.add_argument("--exact-full", action="store_true",
                    help="with realworld: also replay the whole trace "
                         "aliasing-free through the slot table")
    ap.add_argument("--requests", type=int, default=None,
                    help="with realworld: cut the trace to this many "
                         "requests (default 1,000,000; 5,000,000 --full)")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions on the CPU "
                         "(default: the card)")
    args = ap.parse_args(argv)
    want = (set(args.only.split(",")) if args.only
            else set(JOBS) - set(NAMED_ONLY))
    unknown = want - set(JOBS)
    if unknown:
        ap.error(f"unknown jobs {sorted(unknown)}; known: {list(JOBS)}")

    from .._device import resolve_device
    from . import (bench_kernels, bench_serving, bench_sweep,
                   fig2_synthetic, fig3_trace_stats, fig4_sensitivity,
                   fig5_real_traces, fig6_hierarchy, fig_realworld)
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
        "kernels": lambda: emit(bench_kernels.run(device=d),
                                "bench_kernels"),
        "sweep": lambda: emit(bench_sweep.run(
            full=full, smoke=args.smoke, device=d), "bench_sweep"),
        "serving": lambda: emit(bench_serving.run(
            full=full, smoke=args.smoke, device=d), "bench_serving"),
        "memory": lambda: _memory(d),
        "realworld": lambda: emit(fig_realworld.run(
            full=full, exact_full=args.exact_full, device=d,
            n_requests=args.requests), "fig_realworld"),
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
