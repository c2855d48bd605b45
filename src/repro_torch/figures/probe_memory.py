"""Memory probe of the replay state: dense against slot tables.

    python3 -m repro_torch.figures.probe_memory --simstate
        [--requests N] [--device cpu]

For each universe size N in ``SIMSTATE_SIZES`` and each ``state_mode``
(``dense``, ``slots``) a child process streams ``SIMSTATE_REQUESTS``
requests of :func:`_simstate_stream` (Zipf 0.9 over N keys, numpy, seeded)
through ``simulate_stream`` (eq. 16, capacity 10% of the touched
footprint, chunks of 16,384) and reports its host peak (``ru_maxrss``)
and, on the card, its device peak (``torch.cuda.max_memory_allocated``).
Each cell is its own process, so each peak belongs to that cell.  A first
``baseline`` child makes the same imports and (on the card) the CUDA
context but replays nothing; every cell also reports its peaks less the
baseline's (``rss_over_baseline_mb``, ``device_over_baseline_mb``), the
part that the stream, the state and the kernels' libraries add.  On
Linux ``ru_maxrss`` also carries the spawning process's peak across the
fork and exec, so the cells are spawned from a small parent: run the
probe as its own process (``figures.run --only memory`` starts it so),
not from a process that has held large state.  The
dense state holds 14 ``[N]`` columns on the device and scores all N
objects a commit; a slot table is sized by the keys the stream touches.

A cell that fails or passes its time limit becomes a labelled row.  Rows
go to ``results/probe_memory_simstate.csv`` beside this module.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

SIMSTATE_SIZES = (10_000, 100_000, 1_000_000)
SIMSTATE_REQUESTS = 60_000
SRC = Path(__file__).resolve().parents[2]       # the directory of the package


def _simstate_stream(n_keys: int, n_requests: int, seed: int = 0):
    """A Zipf(0.9) stream over ``n_keys`` keys as a host
    :class:`repro_torch.core.trace.RequestStream`: the hot head re-hits,
    the cold tail spreads touches over the universe."""
    import numpy as np

    from ..core.trace import RequestStream
    rng = np.random.default_rng(seed)
    r = np.arange(1, n_keys + 1, dtype=np.float64)
    p = r ** -0.9
    p /= p.sum()
    objs = rng.choice(n_keys, size=n_requests, p=p).astype(np.int32)
    times = np.cumsum(rng.exponential(1.0 / 2000.0, n_requests))
    sizes = np.minimum(rng.lognormal(0.0, 1.2, n_keys), 512.0).astype(
        np.float32)
    z_mean = (0.005 + 2e-4 * sizes).astype(np.float32)
    z_draw = (z_mean[objs] * rng.exponential(1.0, n_requests)).astype(
        np.float32)
    return RequestStream(times=times, objs=objs, sizes=sizes,
                         z_mean=z_mean, z_draw=z_draw)


def simstate_child_row(n_keys: int, mode: str, n_requests: int,
                       device=None) -> dict:
    """One (universe size, state_mode) cell, measured in this process."""
    import resource
    import time

    import numpy as np
    import torch

    from .._device import resolve_device
    from ..core import PolicyParams, simulate_stream
    from ..core.state import slot_table_size

    dev = resolve_device(device)
    stream = _simstate_stream(n_keys, n_requests)
    touched = np.unique(stream.objs)
    distinct = int(touched.size)
    # 10% of the touched footprint, so the cache fills and evicts
    capacity = 0.1 * float(stream.sizes[touched].sum())
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    r = simulate_stream(stream, capacity, "stoch_vacdh",
                        PolicyParams(omega=1.0), estimate_z=True,
                        chunk_size=16_384, state_mode=mode, device=dev)
    lat = float(r.total_latency)
    wall = time.perf_counter() - t0
    return dict(
        n_keys=n_keys, mode=mode, n_requests=n_requests,
        distinct_touched=distinct,
        n_slots=slot_table_size(distinct) if mode == "slots" else "",
        capacity=round(capacity, 1), latency=lat,
        hit_ratio=float(r.hit_ratio),
        **{f: int(getattr(r, f)) for f in ("n_hits", "n_delayed",
                                           "n_misses", "n_evictions")},
        wall_s=round(wall, 1), req_per_s=int(n_requests / wall),
        peak_rss_mb=round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0, 1),
        peak_device_mb=(round(torch.cuda.max_memory_allocated(dev) / 2**20,
                              1) if dev.type == "cuda" else ""),
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu")


def baseline_child_row(device=None) -> dict:
    """The cells' common floor, measured in this process: the cells'
    imports and, on the card, the CUDA context with one allocation; no
    stream, no state, no replay."""
    import resource

    import torch

    from .._device import resolve_device
    from ..core import PolicyParams, simulate_stream  # noqa: F401

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    return dict(
        n_keys="", mode="baseline", n_requests=0,
        peak_rss_mb=round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0, 1),
        peak_device_mb=(round(torch.cuda.max_memory_allocated(dev) / 2**20,
                              1) if dev.type == "cuda" else ""),
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu")


def run_simstate_probe(sizes=SIMSTATE_SIZES, n_requests=SIMSTATE_REQUESTS,
                       timeout_s: float = 1800.0,
                       device=None) -> list[dict]:
    """One child process for the baseline, then one a (N, mode) cell;
    returns and writes the rows (the baseline's first)."""
    from .._device import resolve_device
    from .common import emit
    resolve_device(device)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    rows, base = [], None
    cells = [(0, "baseline")] + [(n, m) for n in sizes
                                 for m in ("dense", "slots")]
    for n, mode in cells:
        cmd = [sys.executable, "-m", "repro_torch.figures.probe_memory",
               "--simstate-child", str(n), mode,
               "--requests", str(n_requests)]
        if device is not None:
            cmd += ["--device", str(device)]
        try:
            proc = subprocess.run(cmd, env=env, capture_output=True,
                                  text=True, timeout=timeout_s)
        except subprocess.TimeoutExpired:
            rows.append(dict(n_keys=n, mode=mode, n_requests=n_requests,
                             status="timeout", timeout_s=int(timeout_s)))
            print(f"# simstate N={n} {mode}: TIMEOUT after "
                  f"{timeout_s:.0f}s", flush=True)
            continue
        marked = [ln for ln in proc.stdout.splitlines()
                  if ln.startswith("SIMSTATE ")]
        if proc.returncode != 0 or not marked:
            tail = (proc.stderr or proc.stdout).strip().splitlines()
            rows.append(dict(n_keys=n, mode=mode, n_requests=n_requests,
                             status=f"exit {proc.returncode}"))
            print(f"# simstate N={n} {mode}: FAILED (exit "
                  f"{proc.returncode}): " + " | ".join(tail[-3:]),
                  flush=True)
            continue
        row = dict(json.loads(marked[-1][len("SIMSTATE "):]),
                   status="ok")
        rows.append(row)
        if mode == "baseline":
            base = row
            print(f"# simstate baseline: rss={row['peak_rss_mb']}MB "
                  f"device={row['peak_device_mb']}MB", flush=True)
            continue
        if base is not None:
            row["rss_over_baseline_mb"] = round(
                row["peak_rss_mb"] - base["peak_rss_mb"], 1)
            if row["peak_device_mb"] != "":
                row["device_over_baseline_mb"] = round(
                    row["peak_device_mb"] - base["peak_device_mb"], 1)
        print(f"# simstate N={n} {mode}: rss={row['peak_rss_mb']}MB "
              f"device={row['peak_device_mb']}MB wall={row['wall_s']}s "
              f"({row['req_per_s']} req/s, {row['distinct_touched']} "
              f"touched)", flush=True)
    emit(rows, "probe_memory_simstate")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--simstate", action="store_true",
                    help="run the dense-vs-slots memory probe")
    ap.add_argument("--simstate-child", nargs=2, metavar=("N", "MODE"),
                    default=None, help=argparse.SUPPRESS)
    ap.add_argument("--requests", type=int, default=SIMSTATE_REQUESTS)
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="each cell's wall-clock limit")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.simstate_child is not None:
        n, mode = args.simstate_child
        row = (baseline_child_row(args.device) if mode == "baseline" else
               simstate_child_row(int(n), mode, args.requests, args.device))
        print("SIMSTATE " + json.dumps(row), flush=True)
        return 0
    if args.simstate:
        rows = run_simstate_probe(n_requests=args.requests,
                                  timeout_s=args.timeout, device=args.device)
        return 0 if all(r.get("status") == "ok" for r in rows) else 1
    ap.error("pass --simstate (the model-stack HLO probe is XLA-only)")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
