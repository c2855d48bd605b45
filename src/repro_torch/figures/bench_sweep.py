"""Sweep-engine benchmark: one grid against a loop of its points, and the
grid's lanes split over devices by the fabric.

    python3 -m repro_torch.figures.bench_sweep [--smoke | --full]
        [--device cpu]

Three questions, each answered with host-clock wall time (each call ends
in a read-back of its results):

* **roster**: one 11-policy grid against a loop of 11 single-policy
  grids, at N = 100 objects and (not in ``--smoke``) at N = 3000;
* **omega**: one 6-point omega grid against a loop of 6 ``simulate``
  calls;
* **device scaling**: the 24-lane omega x capacity grid of
  :func:`scaling_workload` with its lanes over ``d`` devices for each
  ``d`` of ``SCALING_COUNTS`` (``d = 1`` is the in-process grid), and
  through a one-device mesh (``fabric_mesh1``: one worker, the fabric's
  own cost).  Every fabric grid must equal the in-process grid bit for
  bit.  A count the machine cannot run (more CUDA devices than visible)
  is printed as not run; it is never timed on fewer devices or on the
  CPU.

Each row has ``first_call_s`` (the first call: with the kernels' build
and the warm-up; the port compiles nothing else), ``warm_s`` and
``warm_min_s`` (mean and least of the next ``ITERS`` calls) and
``req_per_s`` (lane-requests per warm second).  Writes
``results/bench_sweep.{csv,json}`` beside this module.
"""
from __future__ import annotations

import argparse
import time

import torch

from .._device import resolve_device
from ..core import PolicyParams, simulate, sweep_grid
from ..data.traces import SyntheticSpec, synthetic_trace
from .common import POLICY_SET, emit, write_bench_json

ITERS = 3
SCALING_COUNTS = (1, 2, 4)


def _spec(n_objects: int, n_requests: int) -> SyntheticSpec:
    return SyntheticSpec(n_objects=n_objects, n_requests=n_requests,
                         rate=2000.0, latency_base=0.02,
                         latency_per_mb=5e-4, stochastic=True)


def scaling_workload(full: bool = False, n_requests: int | None = None,
                     device=None):
    """A lane-rich omega x capacity grid (24 lanes, divisible by every
    ``SCALING_COUNTS`` entry): (trace, capacities, params, n_requests)."""
    n_req = n_requests or (30_000 if full else 10_000)
    trace = synthetic_trace(torch.Generator().manual_seed(5),
                            _spec(100, n_req), device=device)
    plist = [PolicyParams(omega=o)
             for o in (0.0, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0)]
    caps = [300.0, 500.0, 800.0]
    return trace, caps, plist, n_req


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev, iters: int | None = None):
    """(first_call_s, warm_mean_s, warm_min_s, the first call's result)
    over ``iters`` (default ``ITERS``) warm calls."""
    iters = ITERS if iters is None else iters
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    first = time.perf_counter() - t0
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        samples.append(time.perf_counter() - t0)
    return first, sum(samples) / iters, min(samples), out


def _trow(name, mode, timing, sims, **extra) -> dict:
    first, warm, wmin, _ = timing
    return dict(name=name, mode=mode, **extra, first_call_s=round(first, 3),
                warm_s=round(warm, 3), warm_min_s=round(wmin, 3),
                req_per_s=int(sims / warm))


def _same(a, b) -> bool:
    """Every field of two SweepGrids' results, bit for bit."""
    import dataclasses
    for f in dataclasses.fields(a.result):
        x, y = getattr(a.result, f.name), getattr(b.result, f.name)
        if x.shape != y.shape or not torch.equal(x.view(torch.int32),
                                                 y.view(torch.int32)):
            return False
    return True


def run_scaling(full: bool = False, n_requests: int | None = None,
                device=None, grids: dict | None = None) -> list[dict]:
    """The device-scaling rows (and ``fabric_mesh1``); ``grids``, when
    given, receives each row's grid by name."""
    from ..launch.mesh import make_data_mesh
    dev = resolve_device(device)
    trace, caps, plist, n_req = scaling_workload(full, n_requests, dev)
    lanes = len(plist) * len(caps)
    visible = (torch.cuda.device_count() if dev.type == "cuda"
               else max(SCALING_COUNTS))
    runs = [(f"fabric_d{d}", f"lane axis over {d} device(s)", d,
             dict(devices=d, device=device)) for d in SCALING_COUNTS]
    runs.append(("fabric_mesh1", "one worker through a one-device mesh", 1,
                 dict(mesh=make_data_mesh(
                     1, None if dev.type == "cuda" else [dev]))))
    rows, base = [], None
    for name, mode, d, kw in runs:
        if d > visible:
            rows.append(dict(name=name, mode=mode, n_lanes=lanes, devices=d,
                             status=f"not run: {visible} CUDA device(s)"))
            print(f"# {name}: not run ({visible} CUDA device(s) visible)",
                  flush=True)
            continue
        counters = {}
        timing = _timed(lambda: sweep_grid(
            trace, caps, "stoch_vacdh", plist, counters=counters, **kw),
            dev)
        g = timing[3]
        if base is None:
            base = g
        elif not _same(g, base):
            raise AssertionError(f"{name}: the fabric grid differs from the "
                                 f"in-process grid")
        if grids is not None:
            grids[name] = g
        row = _trow(name, mode, timing, lanes * n_req, n_lanes=lanes,
                    devices=d, status="ok")
        if counters.get("workers"):
            row["worker_start_s"] = round(counters["worker_start_s"]
                                          / counters["workers"], 3)
        rows.append(row)
    return rows


def run(full: bool = False, smoke: bool = False,
        n_requests: int | None = None, device=None,
        grids: dict | None = None) -> list[dict]:
    """Every row (see the module doc) on ``device`` (None: the card).
    ``n_requests`` overrides the size (30,000 full, 4,000 smoke, else
    10,000); ``grids``, when given, receives the scaling rows' grids."""
    dev = resolve_device(device)
    n_req = n_requests or (30_000 if full else (4_000 if smoke else 10_000))
    gen = lambda: torch.Generator().manual_seed(5)
    trace = synthetic_trace(gen(), _spec(100, n_req), device=dev)
    cap = 500.0
    params = PolicyParams(omega=1.0)
    names = list(POLICY_SET)
    kw = dict(device=device)
    rows = []

    def roster(tr, c, prefix, n_iters):
        uni = _timed(lambda: sweep_grid(tr, c, names, [params], **kw), dev,
                     n_iters)
        seq = _timed(lambda: [sweep_grid(tr, c, pol, [params], **kw)
                              for pol in names], dev, n_iters)
        sims = len(names) * n_req
        return [_trow(f"{prefix}_unified", "one multi-policy call", uni,
                      sims, n_policies=len(names)),
                _trow(f"{prefix}_sequential", "per-policy loop", seq, sims,
                      n_policies=len(names))]

    rows += roster(trace, cap, "roster", None)
    if not smoke:
        # the large-N roster (fig2 / fig5's regime): 2 warm iterations
        ntrace = synthetic_trace(gen(), _spec(3000, n_req), device=dev)
        rows += roster(ntrace, 1500.0, "roster3000", min(ITERS, 2))

    omegas = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0)
    plist = [PolicyParams(omega=o) for o in omegas]
    batched = _timed(lambda: sweep_grid(trace, cap, "stoch_vacdh", plist,
                                        **kw), dev)
    per_point = _timed(lambda: [simulate(trace, cap, "stoch_vacdh", p,
                                         device=device) for p in plist],
                       dev)
    sims = len(omegas) * n_req
    rows += [_trow("omega_batched", "one batched grid", batched, sims,
                   n_points=len(omegas)),
             _trow("omega_sequential", "per-point loop", per_point, sims,
                   n_points=len(omegas))]

    by = {r["name"]: r for r in rows}
    ratio = lambda num, den: round(by[num]["warm_s"]
                                   / max(by[den]["warm_s"], 1e-9), 3)
    summary = dict(
        roster_unified_over_sequential=ratio("roster_sequential",
                                             "roster_unified"),
        omega_batched_over_sequential=ratio("omega_sequential",
                                            "omega_batched"))
    if "roster3000_unified" in by:
        summary["roster3000_unified_over_sequential"] = ratio(
            "roster3000_sequential", "roster3000_unified")

    srows = run_scaling(full, n_requests and n_req, device, grids)
    rows += srows
    warm = {r["name"]: r["warm_s"] for r in srows if r["status"] == "ok"}
    top = f"fabric_d{max(SCALING_COUNTS)}"
    if "fabric_d1" in warm and top in warm and top != "fabric_d1":
        summary[f"{top}_speedup_over_d1"] = round(
            warm["fabric_d1"] / max(warm[top], 1e-9), 3)
    if "fabric_d1" in warm and "fabric_mesh1" in warm:
        summary["fabric_mesh1_over_d1"] = round(
            warm["fabric_d1"] / max(warm["fabric_mesh1"], 1e-9), 3)

    headline = dict(summary)
    if "roster3000_unified" in by:
        headline["roster3000_unified_req_per_s"] = \
            by["roster3000_unified"]["req_per_s"]
    write_bench_json("bench_sweep.json", dict(
        benchmark="bench_sweep", device=str(dev),
        workload=dict(n_objects=100, n_objects_large=None if smoke else 3000,
                      n_requests=n_req, capacity=cap, roster=names,
                      omegas=list(omegas),
                      scaling_counts=list(SCALING_COUNTS), iters=ITERS),
        rows=rows, summary=summary), headline=headline)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="4,000 requests, no N=3000 roster")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    emit(run(full=args.full, smoke=args.smoke, device=args.device),
         "bench_sweep")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
