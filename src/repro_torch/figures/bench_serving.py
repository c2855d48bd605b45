"""Serving benchmark: SLO tail percentiles under adversarial open-loop
arrivals, on the port's serving engine.

The JAX package's ``benchmarks/bench_serving.py`` with the same constants,
configurations and rows: it drives :class:`repro_torch.serving.engine.
ServeEngine` (single tier and hierarchy, hedging on and off) with
open-loop arrivals from :mod:`repro_torch.data.scenarios` and reports, per
configuration:

* p50 / p95 / p99 / p99.9 user-perceived latency from the bounded-memory
  sketch (:mod:`repro_torch.core.percentile`), over the measured segment
  after an untimed warm-up of ``WARMUP_FRAC``, shed and failed requests
  kept out of the sketch and reported as rates;
* the delayed-hit waiter-depth distribution;
* sustained req/s at a fixed SLO: the largest arrival-rate multiplier
  whose p99 meets ``slo_ms`` with at most ``SLO_ERR_BUDGET`` shed or
  failed, by bounded bisection over time-compressed replays.

Beside the reference's fields each row carries what the card's path costs
over the measured segment: read-backs (each a host-device sync) per
request, and launches of ``ranking_victim_order`` and of the lane-scatter
kernel per request (:data:`MEASURED` lists the fields that differ between
runs of the same configuration).  Rows go to
``repro_torch/figures/results/bench_serving.json``.

    python3 -m repro_torch.figures.run --only serving [--smoke|--full]
        [--device cpu]
    python3 -m repro_torch.figures.bench_serving [--smoke|--full]
        [--device cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from .._device import resolve_device
from ..core.percentile import StreamingQuantile
from ..data.scenarios import make_scenario
from ..kernels import launch_counts
from ..serving.engine import LatencyModel, ReplicaSet, ServeEngine
from ..serving.faults import DegradePolicy, FaultPlan
from .common import emit, write_bench_json

SLO_MS_DEFAULT = 150.0
WARMUP_FRAC = 0.25
DEPTH_CAP = 64          # waiter depths >= cap share the overflow bucket
POLICY = "stoch_vacdh"
HEADLINE_SCENARIOS = ("flash_crowd", "brownout")
# scenarios that get a req/s-at-SLO bisection row
SLO_SCENARIOS = ("flash_crowd", "brownout", "degraded_replica",
                 "origin_outage")
# an SLO pass also requires the shed+failed fraction of measured requests
# to stay within this budget (shedding everything must not meet the SLO)
SLO_ERR_BUDGET = 0.01
# with independent replicas a hedge is cheap and lands elsewhere, so the
# client hedges earlier than the single origin's p95
REPLICA_HEDGE_QUANTILE = 0.85
# row fields that are measured, not computed: they differ between two
# runs of one configuration (the launches between kernel and plain runs)
MEASURED = ("wall_s", "drive_req_per_s", "rank_launches_per_req",
            "scatter_launches_per_req")


def _footprint(w) -> float:
    """Total token footprint of the distinct keys in the workload."""
    _, first = np.unique(w.keys, return_index=True)
    return float(np.sum(w.n_tokens[first], dtype=np.float64))


def _fault_kwargs(w, lat: LatencyModel, seed: int,
                  rate_scale: float) -> dict:
    """Replica set + fault plan + degrade policy for workloads with
    replica structure.  The replica models carry the scenario's
    per-replica health schedules (origin truth); the engine's own ``lat``
    stays the client's belief."""
    if w.n_replicas <= 1:
        return {}
    base = list(w.replica_scales) if w.replica_scales else \
        [w.latency_scale] * w.n_replicas
    scale_fns = [lambda t, f=f: f(t * rate_scale) for f in base]
    outages = tuple((r, t0 / rate_scale, t1 / rate_scale)
                    for r, t0, t1 in w.outages)
    return dict(
        replicas=ReplicaSet.uniform(w.n_replicas, lat, scale_fns=scale_fns,
                                    seed=seed),
        faults=FaultPlan(seed=seed, outages=outages),
        degrade=DegradePolicy())


def _make_engine(w, *, hedging: bool, hier: bool, seed: int = 0,
                 cap_frac: float = 0.25, rate_scale: float = 1.0,
                 device=None, use_kernel=None, policy: str = POLICY,
                 max_objects: int = 4096) -> ServeEngine:
    """Engine under test.  Single tier: one cache of ``cap_frac`` of the
    key footprint with its own (brownout-scaled) latency model.
    Hierarchy: a small L1 over a shared L2; only the L2's origin fetches
    hedge, and the origin latency and the L1<->L2 hop both degrade through
    ``latency_scale``.  Workloads with ``n_replicas > 1`` get a replica
    set, a fault plan and a degrade policy on the tier that fetches from
    the origin.  ``rate_scale`` compresses the clock (arrivals at
    ``t / rate_scale``) and every scenario schedule with it.  ``policy``
    and ``max_objects`` size a single tier beyond the reference's
    defaults."""
    foot = _footprint(w)
    m = rate_scale
    lat = LatencyModel(base_s=0.02, per_token_s=2e-5,
                       scale_fn=lambda t: w.latency_scale(t * m),
                       hedge_quantile=REPLICA_HEDGE_QUANTILE
                       if w.n_replicas > 1 else 0.95)
    size_fn = lambda n: float(n)
    fault_kw = _fault_kwargs(w, lat, seed, m)
    dev_kw = dict(device=device, use_kernel=use_kernel)
    if not hier:
        return ServeEngine(capacity=cap_frac * foot, policy=policy,
                           latency=lat, state_size_fn=size_fn,
                           hedging=hedging, seed=seed, max_objects=max_objects,
                           **fault_kw, **dev_kw)
    l2 = ServeEngine(capacity=0.5 * foot, policy=POLICY, latency=lat,
                     state_size_fn=size_fn, hedging=hedging, seed=seed,
                     **fault_kw, **dev_kw)
    hop = lambda t: 0.005 * w.latency_scale(t * m)
    return ServeEngine(capacity=0.15 * foot, policy=POLICY,
                       state_size_fn=size_fn, hedging=hedging,
                       seed=seed + 1, l2=l2, hop_s=hop, **dev_kw)


def _caches(eng):
    return [eng.cache] + ([eng.l2.cache] if eng.l2 is not None else [])


def _cost(eng) -> dict:
    """The engine's device-path counters (both tiers) and the kernels'
    launch counts, now."""
    out = {k: sum(c.counters[k] for c in _caches(eng))
           for k in ("admits", "ranks", "syncs", "flushes")}
    lc = launch_counts()
    out["rank_launches"] = lc["ranking_victim_order"]
    out["scatter_launches"] = lc["lane_scatter"]
    return out


def _drive(w, eng, *, rate_scale: float = 1.0, n_limit: int | None = None,
           counters: dict | None = None):
    """Open-loop replay: warm-up segment untimed, measured segment timed.
    Returns (latency sketch, depth histogram, measured wall seconds,
    number of measured requests, shed count, failed count).

    Shed and failed requests are kept out of the sketch and counted.
    ``counters``, when given, receives the measured segment's requests,
    seconds, admissions, ranks, read-backs (``syncs``), mirror flushes and
    kernel launches."""
    n = w.n_requests if n_limit is None else min(n_limit, w.n_requests)
    warm = int(WARMUP_FRAC * n)
    times = w.times / rate_scale
    keys, toks = w.keys, w.n_tokens
    sq = StreamingQuantile(rel_err=0.005, min_value=1e-6, max_value=1e5)
    depth = np.zeros(DEPTH_CAP + 1, np.int64)
    shed = failed = 0
    for i in range(warm):
        eng.serve(float(times[i]), f"p{keys[i]}", int(toks[i]))
    c0 = _cost(eng)
    t0 = time.perf_counter()
    for i in range(warm, n):
        before = eng.stats.delayed_hits
        outcome, lat = eng.serve(float(times[i]), f"p{keys[i]}",
                                 int(toks[i]))
        if outcome == "shed":
            shed += 1
        elif outcome == "failed":
            failed += 1
        else:
            sq.add(lat)
        if eng.stats.delayed_hits > before:
            depth[min(eng.pending[f"p{keys[i]}"].waiters, DEPTH_CAP)] += 1
    wall = time.perf_counter() - t0
    if counters is not None:
        c1 = _cost(eng)
        counters.update({k: c1[k] - c0[k] for k in c1}, requests=n - warm,
                        seconds=wall)
    return sq, depth, wall, n - warm, shed, failed


def _depth_summary(depth: np.ndarray) -> dict:
    total = int(depth.sum())
    if total == 0:
        return dict(delayed_obs=0, depth_p50=0, depth_p99=0, depth_max=0)
    cum = np.cumsum(depth)
    q = lambda p: int(np.searchsorted(cum, p * total))
    nz = np.nonzero(depth)[0]
    return dict(delayed_obs=total, depth_p50=q(0.50), depth_p99=q(0.99),
                depth_max=int(nz[-1]))


def _depth_hist(depth: np.ndarray) -> dict:
    return {str(d): int(c) for d, c in enumerate(depth.tolist()) if c}


def req_s_at_slo(w, *, hedging: bool, slo_s: float, n_probe: int,
                 n_iters: int = 5, seed: int = 0, device=None,
                 use_kernel=None) -> dict:
    """Largest sustained arrival rate whose p99 meets the SLO.

    Bisects the rate multiplier ``m`` over ``[1/8, 8] x`` the scenario's
    realized mean rate; each probe is a fresh single-tier engine over the
    first ``n_probe`` requests.  A probe passes when its p99 meets the SLO
    and its shed+failed fraction stays within ``SLO_ERR_BUDGET``.  Returns
    the highest passing multiplier, the implied req/s, its p99 and its
    shed+failed rate."""
    base_rate = w.n_requests / max(w.duration, 1e-9)
    lo, hi = 0.0, None
    m, best_p99, best_err = 1.0, float("nan"), float("nan")
    for _ in range(n_iters):
        eng = _make_engine(w, hedging=hedging, hier=False, seed=seed,
                           rate_scale=m, device=device,
                           use_kernel=use_kernel)
        sq, _, _, n_meas, shed, failed = _drive(w, eng, rate_scale=m,
                                                n_limit=n_probe)
        p99 = sq.quantile(0.99)
        err = (shed + failed) / max(n_meas, 1)
        if sq.summary().count > 0 and p99 <= slo_s \
                and err <= SLO_ERR_BUDGET:
            lo, best_p99, best_err = m, p99, err
            m = min(m * 2.0, 8.0) if hi is None else 0.5 * (m + hi)
        else:
            hi = m
            m = 0.5 * (lo + m) if lo > 0.0 else max(m * 0.5, 0.125)
        if hi is not None and hi - lo < 0.05:
            break
    return dict(slo_ms=round(slo_s * 1e3, 1),
                slo_err_budget=SLO_ERR_BUDGET,
                rate_mult_at_slo=round(lo, 3),
                req_s_at_slo=round(lo * base_rate, 1),
                n_replicas=w.n_replicas,
                # None, not NaN: NaN is not valid strict JSON
                p99_ms_at_slo=round(best_p99 * 1e3, 3)
                if lo > 0.0 else None,
                shed_rate_at_slo=round(best_err, 5) if lo > 0.0 else None)


def run(full: bool = False, smoke: bool = False,
        slo_ms: float = SLO_MS_DEFAULT, out: str | None = None,
        seed: int = 0, device=None, use_kernel=None,
        counters: dict | None = None) -> list[dict]:
    """The benchmark's rows (the reference's, plus each row's device-path
    costs); writes them to ``results/bench_serving.json`` (or ``out``).
    ``counters``, when given, receives the sums of the tail rows'
    measured-segment counters (:func:`_drive`; the SLO probes are not
    counted)."""
    if smoke:
        # flash_crowd keeps the legacy path; the two replica scenarios
        # drive the fault-injection path end to end
        scenarios = ["flash_crowd", "degraded_replica", "origin_outage"]
        slo_scen = ["flash_crowd", "degraded_replica"]
        n_req, n_probe, n_iters = 3000, 1500, 3
    elif full:
        scenarios = ["diurnal", "flash_crowd", "zipf_drift", "brownout",
                     "degraded_replica", "origin_outage"]
        slo_scen = [s for s in scenarios if s in SLO_SCENARIOS]
        n_req, n_probe, n_iters = 30_000, 8000, 5
    else:
        scenarios = ["diurnal", "flash_crowd", "zipf_drift", "brownout",
                     "degraded_replica", "origin_outage"]
        slo_scen = [s for s in scenarios if s in SLO_SCENARIOS]
        n_req, n_probe, n_iters = 8000, 4000, 5
    slo_s = slo_ms * 1e-3
    rows, depth_hists = [], {}
    total = {} if counters is None else counters
    dev = resolve_device(device)
    dev_kw = dict(device=dev, use_kernel=use_kernel)

    def one(scenario: str, hier: bool, hedging: bool) -> dict:
        w = make_scenario(scenario, seed=seed, n_requests=n_req, n_keys=800)
        eng = _make_engine(w, hedging=hedging, hier=hier, seed=seed,
                           **dev_kw)
        cost = {}
        sq, depth, wall, n_meas, shed, failed = _drive(w, eng,
                                                       counters=cost)
        for k, v in cost.items():
            total[k] = total.get(k, 0) + v
        s = sq.summary()
        st = eng.stats
        cfg = f"{scenario}/{'hier' if hier else 'single'}/" \
              f"{'hedged' if hedging else 'unhedged'}"
        depth_hists[cfg] = _depth_hist(depth)
        fst = eng.l2.stats if eng.l2 is not None else st
        per = lambda k: round(cost[k] / max(n_meas, 1), 4)
        row = dict(scenario=scenario, mode="hier" if hier else "single",
                   hedging=hedging, policy=POLICY, n_requests=n_req,
                   n_measured=n_meas, n_replicas=w.n_replicas,
                   p50_ms=round(s.p50 * 1e3, 3),
                   p95_ms=round(s.p95 * 1e3, 3),
                   p99_ms=round(s.p99 * 1e3, 3),
                   p999_ms=round(s.p999 * 1e3, 3),
                   mean_ms=round(s.mean * 1e3, 3),
                   max_ms=round(s.max * 1e3, 3),
                   hits=st.hits, delayed_hits=st.delayed_hits,
                   misses=st.misses, hedges=st.hedges,
                   shed=shed, failed=failed,
                   shed_rate=round(shed / max(n_meas, 1), 5),
                   fail_rate=round(failed / max(n_meas, 1), 5),
                   retries=fst.retries, timeouts=fst.timeouts,
                   fault_failures=fst.fault_failures, gaveup=fst.gaveup,
                   **_depth_summary(depth),
                   wall_s=round(wall, 2),
                   drive_req_per_s=int(n_meas / max(wall, 1e-9)),
                   admits=cost["admits"],
                   syncs_per_req=per("syncs"),
                   rank_launches_per_req=per("rank_launches"),
                   scatter_launches_per_req=per("scatter_launches"))
        if eng.l2 is not None:
            row["l2_hedges"] = eng.l2.stats.hedges
            row["l2_delayed"] = eng.l2.stats.delayed_hits
        rows.append(row)
        return row

    # --- tail percentiles: scenarios x {hedging} x {single, hier} -------
    for scenario in scenarios:
        for hedging in (True, False):
            one(scenario, hier=False, hedging=hedging)
    hier_scen = scenarios[:1] if smoke else \
        [s for s in scenarios if s in HEADLINE_SCENARIOS]
    for scenario in hier_scen:
        for hedging in (True, False):
            one(scenario, hier=True, hedging=hedging)

    # --- sustained req/s at the SLO (single tier) -----------------------
    for scenario in slo_scen:
        for hedging in (True, False):
            w = make_scenario(scenario, seed=seed, n_requests=n_req,
                              n_keys=800)
            r = req_s_at_slo(w, hedging=hedging, slo_s=slo_s,
                             n_probe=n_probe, n_iters=n_iters, seed=seed,
                             **dev_kw)
            rows.append(dict(scenario=scenario, mode="slo_search",
                             hedging=hedging, policy=POLICY,
                             n_requests=n_probe, **r))

    def _pick(scenario, mode, hedging, field):
        for r in rows:
            if (r["scenario"], r["mode"], r["hedging"]) == \
                    (scenario, mode, hedging):
                return r.get(field)
        return None

    headline = {k: v for k, v in dict(
        flash_hedged_p99_ms=_pick("flash_crowd", "single", True, "p99_ms"),
        flash_unhedged_p99_ms=_pick("flash_crowd", "single", False,
                                    "p99_ms"),
        brownout_hedged_p99_ms=_pick("brownout", "single", True, "p99_ms"),
        brownout_unhedged_p99_ms=_pick("brownout", "single", False,
                                       "p99_ms"),
        flash_hedged_req_s_at_slo=_pick("flash_crowd", "slo_search", True,
                                        "req_s_at_slo"),
        brownout_hedged_req_s_at_slo=_pick("brownout", "slo_search", True,
                                           "req_s_at_slo"),
        brownout_replicas_hedged_req_s_at_slo=_pick(
            "degraded_replica", "slo_search", True, "req_s_at_slo"),
        outage_hedged_req_s_at_slo=_pick(
            "origin_outage", "slo_search", True, "req_s_at_slo"),
        degraded_replica_hedged_p99_ms=_pick(
            "degraded_replica", "single", True, "p99_ms"),
        origin_outage_hedged_p99_ms=_pick(
            "origin_outage", "single", True, "p99_ms"),
    ).items() if v is not None}

    write_bench_json("bench_serving.json", dict(
        benchmark="bench_serving",
        device=str(dev),
        use_kernel=use_kernel,
        workload=dict(scenarios=scenarios, n_requests=n_req, n_keys=800,
                      policy=POLICY, slo_ms=slo_ms, warmup_frac=WARMUP_FRAC,
                      slo_err_budget=SLO_ERR_BUDGET,
                      smoke=smoke, full=full, seed=seed),
        rows=rows,
        depth_hists=depth_hists,
    ), path=out, headline=headline)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true", help="paper-scale sizes")
    ap.add_argument("--smoke", action="store_true",
                    help="3 scenarios (both fault-injection ones), small "
                         "traces")
    ap.add_argument("--slo-ms", type=float, default=SLO_MS_DEFAULT)
    ap.add_argument("--out", default=None,
                    help="write the JSON snapshot here instead of "
                         "results/bench_serving.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    emit(run(full=args.full, smoke=args.smoke, slo_ms=args.slo_ms,
             out=args.out, seed=args.seed, device=args.device),
         "bench_serving")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
