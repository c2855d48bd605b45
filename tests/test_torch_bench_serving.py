"""The port's serving benchmark against the JAX package's
``benchmarks/bench_serving.py``: its helpers, the measured segment of
``_drive``, the hierarchy engine, whole runs' rows (cut to a few hundred
requests) and one SLO bisection, equal apart from the measured fields."""
import json

import numpy as np
import pytest

from benchmarks import bench_serving as jb
from repro.data import scenarios as js
from repro_torch.data import scenarios as ts
from repro_torch.figures import bench_serving as tb


def test_same_constants():
    for k in ("SLO_MS_DEFAULT", "WARMUP_FRAC", "DEPTH_CAP", "POLICY",
              "HEADLINE_SCENARIOS", "SLO_SCENARIOS", "SLO_ERR_BUDGET",
              "REPLICA_HEDGE_QUANTILE"):
        assert getattr(tb, k) == getattr(jb, k), k


@pytest.mark.parametrize("name", ["zipf_drift", "flash_crowd",
                                  "origin_outage"])
def test_footprint_equals_reference(name):
    w = ts.make_scenario(name, seed=0, n_requests=1000, n_keys=50)
    wj = js.make_scenario(name, seed=0, n_requests=1000, n_keys=50)
    assert tb._footprint(w) == jb._footprint(wj)
    assert tb._footprint(w) < float(np.sum(w.n_tokens, dtype=np.float64))


@pytest.mark.parametrize("hist", [{}, {1: 90, 2: 9, 7: 1}, {0: 3},
                                  {64: 2, 5: 1}, {1: 1}])
def test_depth_summary_and_hist_equal_reference(hist):
    depth = np.zeros(tb.DEPTH_CAP + 1, np.int64)
    for d, c in hist.items():
        depth[d] = c
    assert tb._depth_summary(depth) == jb._depth_summary(depth)
    assert tb._depth_hist(depth) == jb._depth_hist(depth)


def _sketch(sq):
    s = sq.summary()
    return (sq.counts.tobytes(), sq.zero_count, sq.count, sq.sum, s.p50,
            s.p95, s.p99, s.p999, s.max)


@pytest.mark.parametrize("name,hedging,hier", [
    ("flash_crowd", False, False), ("origin_outage", True, False),
    ("degraded_replica", False, False), ("brownout", True, True)])
def test_drive_equals_reference(name, hedging, hier):
    """Only the measured segment is sketched and counted; shed and failed
    requests stay out of the sketch."""
    n = 400
    w = ts.make_scenario(name, seed=1, n_requests=n, n_keys=40)
    wj = js.make_scenario(name, seed=1, n_requests=n, n_keys=40)
    eng = tb._make_engine(w, hedging=hedging, hier=hier, device="cpu")
    ej = jb._make_engine(wj, hedging=hedging, hier=hier)
    cost = {}
    sq, depth, wall, n_meas, shed, failed = tb._drive(w, eng,
                                                      counters=cost)
    rj = jb._drive(wj, ej)
    assert _sketch(sq) == _sketch(rj[0])
    assert depth.tolist() == rj[1].tolist()
    assert (n_meas, shed, failed) == rj[3:]
    assert n_meas == n - int(tb.WARMUP_FRAC * n) and wall >= 0.0
    assert sq.count == n_meas - shed - failed
    assert eng.stats.as_dict() == ej.stats.as_dict()
    assert cost["requests"] == n_meas
    assert cost["syncs"] >= cost["admits"] > 0
    # the CPU runs the plain versions: nothing launches
    assert cost["rank_launches"] == cost["scatter_launches"] == 0
    if name == "origin_outage":
        assert eng.replicas is not None and eng.faults is not None
        assert eng.latency.hedge_quantile == tb.REPLICA_HEDGE_QUANTILE


def test_hier_engine_shares_one_l2_and_scales_hop():
    w = ts.make_scenario("brownout", seed=2, n_requests=300, n_keys=30)
    wj = js.make_scenario("brownout", seed=2, n_requests=300, n_keys=30)
    eng = tb._make_engine(w, hedging=True, hier=True, device="cpu")
    ej = jb._make_engine(wj, hedging=True, hier=True)
    assert eng.l2 is not None and eng.l2.l2 is None and callable(eng.hop_s)
    assert eng.cache.capacity == ej.cache.capacity
    assert eng.l2.cache.capacity == ej.l2.cache.capacity
    assert eng.cache.mirror_f is not eng.l2.cache.mirror_f
    for f in np.linspace(0.0, 1.2, 25) * w.duration:
        assert eng.hop_s(f) == ej.hop_s(f)
        assert eng.l2.latency.mean(100, f) == ej.l2.latency.mean(100, f)


@pytest.mark.parametrize("name,hedging", [("flash_crowd", True),
                                          ("degraded_replica", False)])
def test_req_s_at_slo_equals_reference(name, hedging):
    w = ts.make_scenario(name, seed=0, n_requests=600, n_keys=80)
    wj = js.make_scenario(name, seed=0, n_requests=600, n_keys=80)
    kw = dict(hedging=hedging, slo_s=0.15, n_probe=300, n_iters=4)
    assert tb.req_s_at_slo(w, device="cpu", **kw) == \
        jb.req_s_at_slo(wj, **kw)


def test_rows_equal_reference(monkeypatch, tmp_path):
    """Every scenario's rows, the hierarchy's and the SLO searches' of the
    default run, cut to 150 requests a workload, equal the reference's
    except the measured fields; the port's JSON lands where it is told."""
    cut = lambda mk: (lambda name, seed=0, **kw: mk(
        name, seed=seed, **{**kw, "n_requests": 150}))
    monkeypatch.setattr(jb, "make_scenario", cut(js.make_scenario))
    monkeypatch.setattr(tb, "make_scenario", cut(ts.make_scenario))
    out = tmp_path / "port.json"
    counters = {}
    rows = tb.run(out=str(out), device="cpu", counters=counters)
    ref = jb.run(out=str(tmp_path / "jax.json"))
    assert len(rows) == len(ref) == 6 * 2 + 2 * 2 + 4 * 2
    assert {r["scenario"] for r in rows} == set(ts.SCENARIOS)
    for r, q in zip(rows, ref):
        assert {k: r[k] for k in q if k not in tb.MEASURED} == \
            {k: v for k, v in q.items() if k not in tb.MEASURED}
        if r["mode"] != "slo_search":
            assert set(r) - set(q) == {"admits", "syncs_per_req",
                                       "rank_launches_per_req",
                                       "scatter_launches_per_req"}
            assert r["syncs_per_req"] > 0.0
    payload = json.loads(out.read_text())
    assert payload["rows"] == rows and payload["device"] == "cpu"
    assert payload["depth_hists"] == json.loads(
        (tmp_path / "jax.json").read_text())["depth_hists"]
    assert len(payload["history"]) == 1
    assert counters["requests"] == sum(r["n_measured"] for r in rows
                                       if r["mode"] != "slo_search")
