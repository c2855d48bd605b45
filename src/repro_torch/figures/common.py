"""Shared figure utilities: CSV output and the improvement tables.

Rows have the JAX package's schema (``benchmarks/common.py``): policy,
latency, improvement_vs_lru (paper eq. 17), hit_ratio, delayed_ratio,
sim_s, the caller's labels, then capacity (and trace_idx / seed on grids
with several).  CSVs go to ``results/`` beside this module.
"""
from __future__ import annotations

import csv
import time
from pathlib import Path

from ..core import PolicyParams, SimResult, Trace, simulate, sweep_grid

RESULTS_DIR = Path(__file__).parent / "results"

POLICY_SET = ["lru", "lfu", "lhd", "adaptsize", "lru_mad", "lhd_mad",
              "lac", "cala", "vacdh", "lrb_lite", "stoch_vacdh"]


def emit(rows: list[dict], name: str, echo: bool = True) -> Path:
    """Write ``rows`` to ``results/<name>.csv`` (and print them)."""
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    path = RESULTS_DIR / f"{name}.csv"
    if rows:
        fields = list(dict.fromkeys(k for r in rows for k in r))
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields, restval="")
            w.writeheader()
            w.writerows(rows)
    if echo:
        for r in rows:
            print(",".join(str(v) for v in r.values()), flush=True)
    return path


def _row(policy, r: SimResult, lru_lat: float, sim_s: float, extra):
    lat = float(r.total_latency)
    return dict(
        policy=policy,
        latency=round(lat, 4),
        improvement_vs_lru=round((lru_lat - lat) / lru_lat, 5),
        hit_ratio=round(float(r.hit_ratio), 4),
        delayed_ratio=round(float(r.n_delayed)
                            / max(float(r.n_requests), 1), 4),
        sim_s=round(sim_s, 3),
        **(extra or {}))


def improvement_table(trace, capacity, policies=POLICY_SET, params=None,
                      extra: dict | None = None, estimate_z: bool = True,
                      use_kernel=None, device=None) -> list[dict]:
    """Latency improvement vs LRU (eq. 17) for each policy, one
    :func:`simulate` call per point (the per-point loop)."""
    params = params or PolicyParams()
    base = simulate(trace, capacity, "lru", params, estimate_z=estimate_z,
                    use_kernel=use_kernel, device=device)
    lru_lat = float(base.total_latency)
    rows = []
    for pol in policies:
        t0 = time.perf_counter()
        r = simulate(trace, capacity, pol, params, estimate_z=estimate_z,
                     use_kernel=use_kernel, device=device)
        rows.append(_row(pol, r, lru_lat, time.perf_counter() - t0, extra))
    return rows


def _grid_rows(g, policies, names, per_pt, extra, extra_fn) -> list[dict]:
    """Flatten a SweepGrid into improvement_table-schema rows."""
    lru_li = names.index("lru")
    T, _, P, C, S = g.result.total_latency.shape
    rows = []
    for pol in policies:
        li = names.index(pol)
        for ti in range(T):
            for pi in range(P):
                for ci in range(C):
                    for si in range(S):
                        lb = float(g.result.total_latency[ti, lru_li, pi,
                                                          ci, si])
                        row = _row(pol, g.point(ti, li, pi, ci, si), lb,
                                   per_pt, dict(
                                       **(extra or {}),
                                       **(extra_fn(g.params[pi])
                                          if extra_fn else {})))
                        row["capacity"] = round(float(g.capacities[ci]), 1)
                        if T > 1:
                            row["trace_idx"] = ti
                        if S > 1:
                            row["seed"] = g.seeds[si]
                        rows.append(row)
    return rows


def sweep_improvement_table(traces, capacities, policies, params=None,
                            seeds=(0,), extra: dict | None = None,
                            extra_fn=None, estimate_z: bool = True,
                            use_kernel=None, device=None,
                            counters: dict | None = None,
                            grids: list | None = None) -> list[dict]:
    """:func:`improvement_table` over a whole grid: one
    :func:`repro_torch.core.sweep_grid` call whose lanes are the policies
    (with LRU as the baseline lane) x params x capacities x seeds, one
    engine per trace.

    ``extra_fn(params) -> dict`` labels rows per params point; ``extra``
    labels every row; ``counters`` is passed to the grid, and ``grids``,
    when given, receives the :class:`SweepGrid` (its unrounded results).
    The reference's ``unified``, ``graph_policies`` and ``lane_bucket``
    only shape XLA compiles (one engine runs a call's policies either way
    here), so they are not taken."""
    trace_list = [traces] if isinstance(traces, Trace) else list(traces)
    params_list = (list(params) if isinstance(params, (list, tuple))
                   else [params or PolicyParams()])
    policies = list(policies)
    names = policies if "lru" in policies else ["lru"] + policies
    t0 = time.perf_counter()
    g = sweep_grid(trace_list, capacities, names, params_list, seeds,
                   estimate_z=estimate_z, use_kernel=use_kernel,
                   device=device, counters=counters)
    if grids is not None:
        grids.append(g)
    n_pts = g.result.total_latency.numel()
    per_pt = (time.perf_counter() - t0) / max(n_pts, 1)
    return _grid_rows(g, policies, names, per_pt, extra, extra_fn)

