#!/usr/bin/env python3
"""Where the port's replay and serving engine spend their time on the card.

    PYTHONPATH=src python3 -m repro_torch.profile_replay [--requests N]
    PYTHONPATH=src python3 -m repro_torch.profile_replay --grid [--requests N]
    PYTHONPATH=src python3 -m repro_torch.profile_replay --serving [--requests N]

For the two one-lane cells of chip_smoke.py (fig2: eq. 16 vs LRU as two
lanes over 100 objects; deploy: eq.-16 simulate over 2^20 objects), with
``--grid`` for its phase-9(b) grid (lru / vacdh / stoch_vacdh x omega
{0.5, 1, 2} x capacity {5%, 10%}: 18 lanes over 2^20 objects), or with
``--serving`` for phase 13(b)'s prefix table (the flash crowd over
200,000 keys through a 2^18-object ``ServeEngine``, eq. 16 and LRU),
replays a window of requests and prints one JSON line per cell with:

- wall seconds and requests per second (host clock, ending in a sync),
  device syncs and kernel launches per request (and, for the grid,
  lane-requests per second and syncs per lane-request);
- device busy seconds: the sum of CUDA kernel and memcpy time in a
  ``torch.profiler`` trace of a second replay of the same window, and the
  idle share ``1 - busy / wall`` against the unprofiled wall time;
- host seconds inside the replay engine's parts (gather = read-back,
  scatter = packing + the batched lane-scatter launch, select = the
  scoring pass + victim order, rest = host control flow), or the prefix
  cache's (flush = the mirror's lane-scatter batch, ranks = the
  substrate + the rank's launches, victims = the read-back, rest = the
  event loop), from wrappers around their methods; they include the time
  spent waiting on the device at each read-back.

Prints the card's name and power limit (as nvidia-smi gives them) first.
Needs one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def _timed(cls, name, acc):
    fn = getattr(cls, name)

    def wrapper(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
    setattr(cls, name, wrapper)
    return fn


def _device_seconds(prof) -> float:
    """Summed duration of the device-side events (kernels, copies) of one
    stream; falls back to the operators' self device time."""
    total_us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                   if ev.device_type.name == "CUDA")
    if total_us == 0:
        total_us = sum(e.self_device_time_total
                       for e in prof.key_averages())
    return total_us / 1e6


def profile_cell(label, run, cls=None, names=("_gather", "_scatter",
                                              "_select"), nested=False):
    """Profile ``run()`` (which returns its counters) as one cell; host
    parts are the seconds inside ``cls``'s methods ``names`` (default the
    replay engine's), or, when ``nested``, each method less the one
    before it (``names`` from the innermost call out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from .core import simulator
    from .kernels import launch_counts, reset_launch_counts

    cls = simulator._Engine if cls is None else cls
    run()                                    # warm-up: builds, allocator
    acc = {}
    orig = {n: _timed(cls, n, acc) for n in names}
    try:
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counts = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = launch_counts()
    finally:
        for n, fn in orig.items():
            setattr(cls, n, fn)
    # the device work of a second, profiled replay (the profiler slows the
    # host, so wall time comes from the unprofiled one above)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    busy = _device_seconds(prof)
    top = sorted(((e.key, e.self_device_time_total / 1e6, e.count)
                  for e in prof.key_averages()
                  if e.self_device_time_total > 0),
                 key=lambda x: -x[1])[:8]
    if nested:
        inner = [0.0] + [acc.get(n, 0.0) for n in names]
        acc = {n: inner[k + 1] - inner[k] for k, n in enumerate(names)}
    parts = {k.lstrip("_"): round(v, 6) for k, v in acc.items()}
    parts["rest"] = round(wall - sum(acc.values()), 6)
    out = {"cell": label, "requests": counts["requests"],
           "wall_s": wall, "req_per_s": counts["requests"] / wall,
           "syncs_per_request": counts["syncs"] / counts["requests"],
           "launches_per_request": {
               k: v / counts["requests"]
               for k, v in launched.items() if v},
           "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
           "host_s": parts,
           "top_device_ops": [{"op": k, "s": s, "count": c}
                              for k, s, c in top]}
    if "lane_requests" in counts:
        out["lane_requests_per_s"] = counts["lane_requests"] / wall
        out["syncs_per_lane_request"] = (counts["syncs"]
                                         / counts["lane_requests"])
    print(json.dumps(out), flush=True)


def profile_serving(n_requests: int) -> None:
    """Phase 13(b)'s prefix table, cut to ``n_requests``, as two cells."""
    from .data.scenarios import make_scenario
    from .figures import bench_serving as bs
    from .serving.engine import DelayedHitPrefixCache

    w = make_scenario("flash_crowd", seed=0, n_requests=n_requests,
                      n_keys=200_000)
    reqs = [(float(t), f"p{k}", int(n))
            for t, k, n in zip(w.times, w.keys, w.n_tokens)]
    for policy in ("stoch_vacdh", "lru"):
        def run(policy=policy):
            eng = bs._make_engine(w, hedging=True, hier=False, policy=policy,
                                  max_objects=1 << 18)
            for q in reqs:
                eng.serve(*q)
            c = eng.cache.counters
            return {"requests": len(reqs), "syncs": c["syncs"],
                    "admissions": c["admits"]}
        profile_cell(f"serving_{policy}", run, DelayedHitPrefixCache,
                     ("flush", "ranks", "_victims"), nested=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=3000)
    ap.add_argument("--grid", action="store_true",
                    help="profile the 18-lane 2^20 grid instead of the "
                         "one-lane cells")
    ap.add_argument("--serving", action="store_true",
                    help="profile the serving engine's 2^18-object prefix "
                         "table instead")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_replay: no CUDA device", file=sys.stderr)
        return 2
    from .core import PolicyParams, latency_improvement, simulate, sweep_grid
    from .data.traces import SyntheticSpec, synthetic_trace

    params = PolicyParams(omega=1.0, resid="recency")
    fig2 = synthetic_trace(torch.Generator().manual_seed(0), SyntheticSpec(
        n_objects=100, n_requests=args.requests, zipf_alpha=0.9,
        rate=2000.0, latency_base=0.005, latency_per_mb=2e-4))

    def run_fig2():
        c = {}
        latency_improvement(fig2, 500.0, "stoch_vacdh", "lru", params,
                            estimate_z=True, use_kernel=True, counters=c)
        return c

    deploy = synthetic_trace(torch.Generator().manual_seed(7), SyntheticSpec(
        n_objects=1 << 20, n_requests=args.requests, zipf_alpha=0.9,
        rate=2000.0, latency_base=0.005, latency_per_mb=2e-4))
    touched = torch.unique(deploy.objs.long())
    foot = float(deploy.sizes[touched].sum())
    cap = float(0.1 * deploy.sizes[touched].sum())

    def run_deploy():
        c = {}
        simulate(deploy, cap, "stoch_vacdh", params, estimate_z=True,
                 use_kernel=True, counters=c)
        return c

    def run_grid():
        c = {}
        sweep_grid(deploy, [0.05 * foot, 0.10 * foot],
                   ["lru", "vacdh", "stoch_vacdh"],
                   [PolicyParams(omega=o, resid="recency")
                    for o in (0.5, 1.0, 2.0)],
                   estimate_z=True, use_kernel=True, counters=c)
        return c

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if args.serving:
        profile_serving(args.requests)
    elif args.grid:
        profile_cell("grid", run_grid)
    else:
        profile_cell("fig2", run_fig2)
        profile_cell("deploy", run_deploy)
    return 0


if __name__ == "__main__":
    sys.exit(main())
