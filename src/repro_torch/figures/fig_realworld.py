"""Real-world-scale replay (the paper's §5 setting at a million requests):
a generated CDN-like trace (epoch-scale f64 times, Zipf over 200,000 keys,
a diurnal rate, lognormal sizes) round-tripped through the packed binary
trace format, compacted to a dense universe (the top 4096 keys + a
recycled pool of 512 for the cold tail), and replayed through the whole
policy roster by the streaming engine, chunk by chunk.

Sections, as in the JAX package's ``benchmarks/fig_realworld.py``:

- ``roster``: every policy of ``POLICY_SET`` (LRU first) through
  ``simulate_stream`` in chunks of :data:`CHUNK_SIZE`, the cache at 10% of
  the footprint; req/s, sim_s and the process's peak RSS a row;
- ``overhead``: eq. 16 through ``simulate`` on the trace rebased to t = 0
  (``mode="device"``: the f32 clock cannot hold the epoch times), and
  through ``simulate_stream(chunk_size="auto")`` (``stream_auto``);
- ``compaction``: a 250,000-request prefix compacted at top_k 1024 / 4096
  / 16,384 at one fixed capacity (10% of the 4096 footprint), LRU and eq.
  16, and the same prefix with every key its own id through the slot
  table (``state_mode="slots"`` at 0.75 load): the aliasing delta of a
  top_k is its improvement minus the exact row's;
- ``scale_exact`` (``--exact-full`` only): the whole trace aliasing-free.

Rows go to ``results/fig_realworld.csv`` (through the runner) and the
summary to ``results/bench_stream.json`` beside this module.  Runs on the
card unless ``device="cpu"``; ``n_requests`` (and, for tests, ``n_keys``)
cut the trace for small runs.

    python3 -m repro_torch.figures.run --only realworld [--full]
        [--exact-full] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import resource
import time

from .._device import resolve_device
from ..core import PolicyParams, simulate, simulate_stream
from ..core.state import slot_table_size
from ..core.trace import auto_chunk_size, trace_of_stream
from ..data.traces import (RawTrace, RealWorldSpec, compact_requests,
                           exact_requests, load_trace_bin, realworld_raw,
                           save_trace_bin)
from .common import POLICY_SET, RESULTS_DIR, emit, write_bench_json

CHUNK_SIZE = 131_072
PROBE_REQUESTS = 250_000
PROBE_TOP_K = (1024, 4096, 16_384)


def _peak_rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def _timed(fn, n_requests: int, label: str, counters):
    """``fn(c)``'s result and wall seconds (the engines synchronise before
    they return their results); prints its req/s and syncs a request and
    adds its counters ``c`` to ``counters``."""
    c = {}
    t0 = time.perf_counter()
    r = fn(c)
    float(r.total_latency)
    wall = time.perf_counter() - t0
    print(f"# {label}: {n_requests / wall:.1f} req/s, "
          f"{c['syncs'] / max(c['requests'], 1):.4f} syncs/request",
          flush=True)
    if counters is not None:
        for k, v in c.items():
            counters[k] = counters.get(k, 0) + v
    return r, wall


def _replay_rows(stream, capacity, policies, *, extra, device, counters,
                 chunk_size=CHUNK_SIZE, state_mode="dense", n_slots=None,
                 results=None, key=()) -> list[dict]:
    """One streamed replay row per policy, LRU first.  The roster keeps
    the fixed :data:`CHUNK_SIZE`: under rebasing the chunk boundaries set
    the f32 offsets' rounding, so a fixed size keeps rows comparable
    across runs."""
    rows = []
    lru_lat = None
    for pol in ["lru"] + [p for p in policies if p != "lru"]:
        r, wall = _timed(lambda c: simulate_stream(
            stream, capacity, pol, PolicyParams(omega=1.0),
            estimate_z=True, chunk_size=chunk_size, state_mode=state_mode,
            n_slots=n_slots, device=device, counters=c),
            stream.n_requests, f"{extra['section']} {extra['mode']} "
            f"{extra.get('top_k', '')} {pol}", counters)
        if results is not None:
            results[key + (pol,)] = r
        lat = float(r.total_latency)
        if lru_lat is None:
            lru_lat = lat
        rows.append(dict(
            policy=pol,
            latency=round(lat, 4),
            improvement_vs_lru=round((lru_lat - lat) / lru_lat, 5),
            hit_ratio=round(float(r.hit_ratio), 4),
            delayed_ratio=round(float(r.n_delayed)
                                / max(float(r.n_requests), 1), 4),
            sim_s=round(wall, 2),
            req_per_s=int(stream.n_requests / wall),
            peak_rss_mb=round(_peak_rss_mb(), 1),
            **extra))
        print(f"# row {json.dumps(rows[-1])}", flush=True)
    return rows


def _overhead_row(fn, n_req, mode, meta, counters,
                  **extra) -> tuple[dict, object]:
    r, wall = _timed(fn, n_req, f"overhead {mode} stoch_vacdh", counters)
    return dict(policy="stoch_vacdh",
                latency=round(float(r.total_latency), 4),
                sim_s=round(wall, 2), req_per_s=int(n_req / wall),
                peak_rss_mb=round(_peak_rss_mb(), 1), **extra,
                section="overhead", mode=mode, **meta), r


def _summary(rows, n_req, stats, capacity, dev: str) -> None:
    """``results/bench_stream.json``: the roster, the overhead rows and
    the measured aliasing correction."""
    roster = [r for r in rows if r.get("section") == "roster"]
    over = [r for r in rows if r.get("section") == "overhead"]
    device = [r for r in over if r["mode"] == "device"]
    auto = [r for r in over if r["mode"] == "stream_auto"]
    stoch = [r for r in roster if r["policy"] == "stoch_vacdh"]
    keep = ("policy", "req_per_s", "sim_s", "peak_rss_mb",
            "improvement_vs_lru", "hit_ratio")
    # each top_k's improvement minus the exact (slot-table) row's: how far
    # pooling the cold tail inflates the recorded improvement
    comp = [r for r in rows if r.get("section") == "compaction"
            and r["policy"] == "stoch_vacdh"]
    exact_imp = next((r["improvement_vs_lru"] for r in comp
                      if r.get("top_k") == "exact"), None)
    aliasing = ([] if exact_imp is None else
                [dict(top_k=r["top_k"], tail_mass=r["tail_mass_probe"],
                      improvement_vs_lru=r["improvement_vs_lru"],
                      aliasing_delta=round(
                          r["improvement_vs_lru"] - exact_imp, 5))
                 for r in comp if r.get("top_k") != "exact"])
    aggregate = dict(
        total_sim_s=round(sum(r["sim_s"] for r in roster), 1),
        mean_req_per_s=int(sum(r["req_per_s"] for r in roster)
                           / max(len(roster), 1)),
        peak_rss_mb=max(r["peak_rss_mb"] for r in roster))
    write_bench_json("bench_stream.json", dict(
        benchmark="fig_realworld_stream", device=dev,
        workload=dict(n_requests=n_req, n_objects=stats.n_objects,
                      chunk_size=CHUNK_SIZE,
                      chunk_auto=auto_chunk_size(n_req),
                      tail_mass=round(stats.tail_mass, 4),
                      capacity=round(capacity, 1)),
        rows=[{k: r[k] for k in keep if k in r} for r in roster],
        device_mode=[{k: r[k] for k in ("policy", "mode", "req_per_s",
                                        "sim_s", "peak_rss_mb") if k in r}
                     for r in over],
        compaction_probe=dict(exact_improvement_vs_lru=exact_imp,
                              aliasing=aliasing),
        aggregate=aggregate,
    ), headline=dict(
        mean_req_per_s=aggregate["mean_req_per_s"],
        peak_rss_mb=aggregate["peak_rss_mb"],
        stream_req_per_s=stoch[0]["req_per_s"] if stoch else None,
        stream_auto_req_per_s=auto[0]["req_per_s"] if auto else None,
        device_req_per_s=device[0]["req_per_s"] if device else None,
        aliasing_delta_top4096=next(
            (a["aliasing_delta"] for a in aliasing
             if a["top_k"] == 4096), None)))


def run(full: bool = False, exact_full: bool = False, device=None,
        n_requests: int | None = None, n_keys: int = 200_000,
        counters: dict | None = None,
        results: dict | None = None) -> list[dict]:
    """Every section's rows (see the module doc) on ``device`` (None: the
    card).  ``counters`` accumulates every replay's requests, syncs,
    commits, scoring commits and argmins; ``results``, when given,
    receives each replay's unrounded :class:`~repro_torch.core.SimResult`
    by ``(section, mode, top_k, policy)`` and the roster's ``(stream,
    capacity)`` as ``"roster_stream"``."""
    n_req = n_requests or (5_000_000 if full else 1_000_000)
    spec = RealWorldSpec(n_requests=n_req, n_keys=n_keys, seed=0)
    t0 = time.perf_counter()
    raw = realworld_raw(spec)
    gen_s = time.perf_counter() - t0

    # the packed binary format round trip: the ingestion path under test
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    path = RESULTS_DIR / "realworld_trace.bin"
    t0 = time.perf_counter()
    save_trace_bin(path, raw)
    raw = load_trace_bin(path)
    io_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    stream, stats = compact_requests(raw, top_k=4096, n_recycle=512)
    compact_s = time.perf_counter() - t0
    footprint = float(stream.sizes.sum())
    capacity = 0.1 * footprint
    print(f"# trace: {n_req} requests, {stats.n_unique} unique keys -> "
          f"{stats.n_objects} dense objects (tail mass "
          f"{stats.tail_mass:.3f}); gen {gen_s:.1f}s, bin io {io_s:.1f}s, "
          f"compact {compact_s:.1f}s; cache = 10% of "
          f"{footprint:.0f} MB footprint", flush=True)
    meta = dict(n_requests=n_req, n_objects=stats.n_objects,
                tail_mass=round(stats.tail_mass, 4),
                capacity=round(capacity, 1))
    if results is not None:
        results["roster_stream"] = (stream, capacity)

    rows = _replay_rows(stream, capacity, POLICY_SET, device=device,
                        counters=counters,
                        extra=dict(section="roster", mode="stream", **meta),
                        results=results, key=("roster", "stream", None))

    # the streaming engine against the monolithic replay: the same
    # arithmetic on the trace rebased to t = 0
    trace = trace_of_stream(stream._replace(
        times=stream.times - stream.times[0]), device=device)
    row, r = _overhead_row(lambda c: simulate(
        trace, capacity, "stoch_vacdh", PolicyParams(omega=1.0),
        estimate_z=True, device=device, counters=c), n_req, "device", meta,
        counters)
    rows.append(row)
    # the chunk size 'auto' picks (its own rebasing, so its own results)
    row, r2 = _overhead_row(lambda c: simulate_stream(
        stream, capacity, "stoch_vacdh", PolicyParams(omega=1.0),
        estimate_z=True, chunk_size="auto", device=device, counters=c),
        n_req, "stream_auto", meta, counters,
        chunk_auto=auto_chunk_size(n_req))
    rows.append(row)
    if results is not None:
        results[("overhead", "device", None, "stoch_vacdh")] = r
        results[("overhead", "stream_auto", None, "stoch_vacdh")] = r2

    # the compaction probe on a prefix, at ONE absolute capacity (10% of
    # the middle top_k's footprint) so top_k is the only axis
    probe_n = min(PROBE_REQUESTS, n_req)
    praw = RawTrace(raw.times[:probe_n], raw.keys[:probe_n],
                    raw.sizes[:probe_n])
    probes = [compact_requests(praw, top_k=k, n_recycle=512)
              for k in PROBE_TOP_K]
    pcap = 0.1 * float(probes[1][0].sizes.sum())
    for (pstream, pstats), top_k in zip(probes, PROBE_TOP_K):
        rows += _replay_rows(
            pstream, pcap, ["lru", "stoch_vacdh"], device=device,
            counters=counters,
            extra=dict(section="compaction", mode="stream", top_k=top_k,
                       capacity_probe=round(pcap, 1),
                       n_objects_probe=pstats.n_objects,
                       tail_mass_probe=round(pstats.tail_mass, 4)),
            results=results, key=("compaction", "stream", top_k))

    # the aliasing-free end of that axis: every distinct key its own id,
    # through the slot table at 0.75 load (it never fills, so the replay is
    # exact) and the same capacity
    estream, estats = exact_requests(praw)
    eslots = slot_table_size(estats.n_unique, load=0.75)
    rows += _replay_rows(
        estream, pcap, ["lru", "stoch_vacdh"], device=device,
            counters=counters,
        state_mode="slots", n_slots=eslots,
        extra=dict(section="compaction", mode="stream_slots",
                   top_k="exact", capacity_probe=round(pcap, 1),
                   n_objects_probe=estats.n_objects, n_slots_probe=eslots,
                   tail_mass_probe=0.0),
        results=results, key=("compaction", "stream_slots", "exact"))

    if exact_full:
        fstream, fstats = exact_requests(raw)
        fslots = slot_table_size(fstats.n_unique, load=0.75)
        rows += _replay_rows(
            fstream, capacity, ["lru", "stoch_vacdh"], device=device,
            counters=counters,
            state_mode="slots", n_slots=fslots,
            extra=dict(section="scale_exact", mode="stream_slots",
                       top_k="exact", n_objects_probe=fstats.n_objects,
                       n_slots_probe=fslots, tail_mass_probe=0.0, **meta),
            results=results, key=("scale_exact", "stream_slots", "exact"))

    _summary(rows, n_req, stats, capacity, str(resolve_device(device)))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="5M requests instead of 1M")
    ap.add_argument("--exact-full", action="store_true",
                    help="also replay the whole trace aliasing-free")
    ap.add_argument("--requests", type=int, default=None,
                    help="cut the trace to this many requests")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions there (default: "
                         "the card)")
    args = ap.parse_args()
    emit(run(full=args.full, exact_full=args.exact_full,
             device=args.device, n_requests=args.requests), "fig_realworld")


if __name__ == "__main__":
    main()
