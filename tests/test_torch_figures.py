"""The port's figure drivers (repro_torch.figures) on the CPU at tiny sizes:
the JAX drivers' row schema, the improvement table against the JAX
package's on one trace, and surrogate traces that do not change from
process to process."""
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from benchmarks.common import sweep_improvement_table as jsweep_table
from repro.core import PolicyParams as JPP
from repro.data.traces import SyntheticSpec as JSpec
from repro.data.traces import synthetic_trace as jsynthetic_trace
from repro_torch.convert import trace_from_arrays
from repro_torch.core import PolicyParams
from repro_torch.data.traces import SURROGATES, surrogate_trace
from repro_torch.figures import (common, fig2_synthetic, fig3_trace_stats,
                                 fig4_sensitivity, fig5_real_traces,
                                 fig6_hierarchy, run)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASE = ["policy", "latency", "improvement_vs_lru", "hit_ratio",
        "delayed_ratio", "sim_s"]


def _keys(rows):
    return {tuple(r) for r in rows}


def test_fig2_rows_have_the_jax_drivers_keys():
    rows = fig2_synthetic.run(device="cpu", n_requests=400)
    want = tuple(BASE + ["arrival", "latency_base", "n_requests", "resid",
                         "capacity"])
    assert _keys(rows) == {want}
    assert len(rows) == 2 * (len(common.POLICY_SET) + 3)
    assert {r["arrival"] for r in rows} == {"poisson", "pareto"}
    assert all(np.isfinite(r["latency"]) for r in rows)


def test_fig2_seeds_stack_traces():
    rows = fig2_synthetic.run(device="cpu", n_requests=300, n_seeds=2)
    assert {r["trace_idx"] for r in rows} == {0, 1}
    assert {r["arrival"] for r in rows} == {"poisson", "pareto"}
    assert "trace_idx" in rows[0] and list(rows[0])[-1] == "trace_idx"


def test_fig3_rows_match_the_jax_drivers_keys():
    from benchmarks.fig3_trace_stats import run as jrun
    want = _keys(jrun())
    got = fig3_trace_stats.run(device="cpu")
    assert _keys(got) == want
    assert [r["trace"] for r in got] == list(SURROGATES)
    for r in got:
        assert r["n_objects"] == SURROGATES[r["trace"]].n_objects


def test_fig4_rows_have_the_jax_drivers_keys():
    rows = fig4_sensitivity.run(device="cpu", n_requests=300)
    by = {}
    for r in rows:
        by.setdefault(r["sweep"], set()).add(tuple(r))
    assert by == {
        "omega": {tuple(BASE + ["sweep", "omega", "window", "capacity"])},
        "window": {tuple(BASE + ["sweep", "omega", "window", "capacity"])},
        "resid": {tuple(BASE + ["sweep", "omega", "window", "resid",
                                "capacity"])},
        "dist": {tuple(BASE + ["sweep", "trace_dist", "omega", "window",
                               "assumed_dist", "capacity"])},
    }
    assert len(rows) == 3 * 2 + 3 + 3 * 2 + 2 * 2
    assert {r["assumed_dist"] for r in rows if r["sweep"] == "dist"} == {
        "exponential-equivalent", "erlang", "hyperexp"}


def test_fig4_compare_times_both_paths():
    rows = fig4_sensitivity.run_compare(device="cpu", n_requests=200)
    assert [r["path"] for r in rows] == ["per_point_simulate", "sweep_grid",
                                         "speedup"]
    assert rows[0]["n_rows"] == rows[1]["n_rows"] == 3 * 2 + 3
    assert rows[2]["wall_s"] > 0


def test_fig5_rows_have_the_jax_drivers_keys():
    rows = fig5_real_traces.run(device="cpu", n_requests=300)
    want = tuple(BASE + ["resid", "trace", "latency_base", "footprint_mb",
                         "capacity"])
    assert _keys(rows) == {want}
    assert len(rows) == len(SURROGATES) * (len(common.POLICY_SET) + 3)
    for r in rows:
        np.testing.assert_allclose(r["capacity"], 0.1 * r["footprint_mb"],
                                   rtol=1e-3)


FIG6_KEYS = ("route", "n_shards", "hop_dist", "hop_cv", "l2_capacity",
             "policy", "total_latency", "improvement_vs_lru", "l1_hit_ratio",
             "l2_hit_ratio", "sweep_s")


def test_fig6_rows_have_the_jax_drivers_keys_and_laws():
    from benchmarks import fig6_hierarchy as jfig6
    assert [n for n, _ in fig6_hierarchy.HOP_DISTS] == \
        [n for n, _ in jfig6.HOP_DISTS]
    for (_, d), (_, jd) in zip(fig6_hierarchy.HOP_DISTS, jfig6.HOP_DISTS):
        assert round(fig6_hierarchy._cv(d), 3) == round(jfig6._cv(jd), 3)
    timings, grids = [], []
    rows = fig6_hierarchy.run(device="cpu", n_requests=150, compare=True,
                              timings=timings, grids=grids)
    assert _keys(rows) == {FIG6_KEYS}
    assert len(rows) == 2 * 2 * 4 * 2 * 3
    assert {(r["route"], r["n_shards"]) for r in rows} == {
        ("hash", 1), ("hash", 4), ("random", 1), ("random", 4)}
    assert all(r["improvement_vs_lru"] == 0.0 for r in rows
               if r["policy"] == "lru")
    assert all(r["l2_hit_ratio"] == 0.0 for r in rows
               if r["l2_capacity"] == 0.0)
    assert [(t["route"], t["n_shards"]) for t in timings] == [
        ("hash", 1), ("hash", 4), ("random", 1), ("random", 4)]
    assert all(t["n_points"] == 24 and t["per_point_s"] > 0
               and t["speedup"] > 0 for t in timings)
    assert [g.n_shards for g in grids] == [1, 4, 1, 4]


def test_fig6_grid_matches_the_jax_grid_on_the_same_traces():
    """The JAX hierarchy grid on the port's fig6 traces (random route, four
    shards, the four hop laws) gives the port's grid: counters exactly,
    latency to rtol=1e-5."""
    from repro.core import PolicyParams as JPolicyParams
    from repro.core import sweep_hier_grid as jsweep_hier_grid
    from repro.core.hierarchy import HierTrace as JHierTrace
    grids = []
    fig6_hierarchy.run(device="cpu", n_requests=200, grids=grids)
    g = grids[3]
    # the traces the driver built for (random, 4), rebuilt the same way
    base = fig6_hierarchy.synthetic_trace(
        fig6_hierarchy.torch.Generator().manual_seed(0),
        fig6_hierarchy._spec(False, 200), device="cpu")
    traces = [fig6_hierarchy.make_hier_trace(
        base, 4, generator=fig6_hierarchy.torch.Generator().manual_seed(7),
        hop_mean=0.01, hop_dist=d, route="random")
        for _, d in fig6_hierarchy.HOP_DISTS]
    jtraces = [JHierTrace(*(jax.numpy.asarray(np.asarray(x)) for x in (
        t.times, t.objs, t.shards, t.sizes, t.z_mean, t.z_draw,
        t.hop_draw)), jax.numpy.float32(t.hop_mean)) for t in traces]
    jg = jsweep_hier_grid(jtraces, 4, 400.0, [0.0, 2000.0],
                          list(fig6_hierarchy.POLICIES),
                          JPolicyParams(omega=1.0), estimate_z=True)
    for tier in ("per_shard", "l2"):
        got, want = getattr(g.result, tier), getattr(jg.result, tier)
        for f in ("n_hits", "n_delayed", "n_misses", "n_evictions"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
        np.testing.assert_allclose(got.total_latency.numpy(),
                                   np.asarray(want.total_latency),
                                   rtol=1e-5)


def test_run_writes_results_and_rejects_unknown_jobs(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "RESULTS_DIR", tmp_path)
    assert run.main(["--only", "fig3", "--device", "cpu"]) == 0
    assert (tmp_path / "fig3_trace_stats.csv").read_text().startswith(
        "trace,n_objects,")
    with pytest.raises(SystemExit):
        run.main(["--only", "fig9", "--device", "cpu"])


def test_sweep_improvement_table_matches_jax():
    spec = JSpec(n_objects=30, n_requests=800, rate=400.0, size_min=1.0,
                 size_max=20.0, latency_base=0.01, latency_per_mb=1e-3)
    jt = jsynthetic_trace(jax.random.key(1), spec)
    tr = trace_from_arrays(*(np.asarray(x) for x in jt), device="cpu")
    policies = ["vacdh", "stoch_vacdh", "lac"]
    caps = [40.0, 90.0]
    label = lambda p: dict(omega=p.omega)
    want = jsweep_table(jt, caps, policies,
                        params=[JPP(omega=o) for o in (0.5, 2.0)],
                        extra=dict(sweep="x"), extra_fn=label)
    got = common.sweep_improvement_table(
        tr, caps, policies, params=[PolicyParams(omega=o) for o in (0.5, 2.0)],
        extra=dict(sweep="x"), extra_fn=label, use_kernel=False,
        device="cpu")
    assert len(got) == len(want) == 3 * 2 * 2
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in ("policy", "sweep", "omega", "capacity", "hit_ratio",
                  "delayed_ratio"):
            assert g[k] == w[k], k
        assert abs(g["improvement_vs_lru"] - w["improvement_vs_lru"]) \
            <= 1e-5 + 1e-12
    # the same rows from one simulate call per point
    per = common.improvement_table(tr, caps[0], policies,
                                   params=PolicyParams(omega=0.5),
                                   use_kernel=False, device="cpu")
    grid = [r for r in got if r["omega"] == 0.5 and r["capacity"] == 40.0]
    for a, b in zip(per, grid):
        assert (a["policy"], a["latency"], a["improvement_vs_lru"]) == \
            (b["policy"], b["latency"], b["improvement_vs_lru"])


def test_surrogate_trace_is_the_same_in_every_process():
    code = ("import sys, hashlib, numpy as np\n"
            "from repro_torch.data.traces import surrogate_trace\n"
            "t = surrogate_trace('wiki2018', device='cpu', n_requests=5000)\n"
            "h = hashlib.sha256()\n"
            "for x in (t.times, t.objs, t.sizes, t.z_draw):\n"
            "    h.update(x.numpy().tobytes())\n"
            "print(h.hexdigest())\n")
    outs = []
    for hash_seed in ("1", "2"):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   PYTHONHASHSEED=hash_seed)
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout.strip())
    assert outs[0] == outs[1] and len(outs[0]) == 64


def test_surrogate_overrides_keep_the_requests():
    a = surrogate_trace("cloud", device="cpu", n_requests=2000)
    b = surrogate_trace("cloud", device="cpu", n_requests=2000,
                        latency_base=0.02)
    assert np.array_equal(a.objs.numpy(), b.objs.numpy())
    assert np.array_equal(a.times.numpy(), b.times.numpy())
    assert not np.array_equal(a.z_mean.numpy(), b.z_mean.numpy())
