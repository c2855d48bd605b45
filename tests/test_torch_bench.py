"""The port's benchmark modules at tiny sizes on the CPU, against the JAX
package's ``benchmarks/`` where they share a definition:

* ``bench_sweep``: the reference's constants, scaling grid and row fields;
  its fabric grids (CPU workers) equal the in-process grid bit for bit;
* ``bench_kernels``: one row for each of the six kernels (plain versions
  timed on the host clock; the kernel column is not measured here);
* ``probe_memory``: the numpy stream equals the reference's, and a
  ``--simstate`` child's rows (dense and slots) hold against JAX's
  ``simulate_stream`` on it (counters exactly, latency to rtol=1e-5)."""
import dataclasses

import numpy as np
import pytest
import torch

from benchmarks import bench_sweep as jbs
from benchmarks.probe_memory import _simstate_stream as jstream
from repro.core import PolicyParams as JPP
from repro.core import simulate_stream as jsimulate_stream
from repro_torch.figures import bench_kernels, bench_sweep, probe_memory

RTOL = 1e-5
TIMED = ("first_call_s", "warm_s", "warm_min_s", "req_per_s")
KERNELS = {"ranking_victim_order", "ranking_scores", "lane_scatter",
           "point_update", "flash_attention", "decode_attention",
           "gla_chunk"}


def test_bench_sweep_shares_the_reference_workload():
    assert bench_sweep.ITERS == jbs.ITERS
    assert bench_sweep.SCALING_COUNTS == jbs.SCALING_COUNTS
    _, caps, plist, n = bench_sweep.scaling_workload(n_requests=50,
                                                     device="cpu")
    _, jcaps, jplist, _ = jbs._scaling_workload(False)
    assert caps == jcaps and n == 50
    assert [p.omega for p in plist] == [p.omega for p in jplist]
    assert len(plist) * len(caps) == 24


def test_bench_sweep_rows_and_fabric_grids(monkeypatch):
    monkeypatch.setattr(bench_sweep, "ITERS", 1)
    monkeypatch.setattr(bench_sweep, "SCALING_COUNTS", (1, 2))
    grids = {}
    rows = bench_sweep.run(smoke=True, n_requests=120, device="cpu",
                           grids=grids)
    by = {r["name"]: r for r in rows}
    assert set(by) == {"roster_unified", "roster_sequential",
                       "omega_batched", "omega_sequential", "fabric_d1",
                       "fabric_d2", "fabric_mesh1"}
    for r in rows:
        assert {"name", "mode", *TIMED} <= set(r), r
        assert r["warm_s"] > 0 and r["req_per_s"] > 0
    assert by["roster_unified"]["n_policies"] == 11
    assert by["omega_batched"]["n_points"] == 6
    assert by["fabric_d2"]["devices"] == 2
    assert by["fabric_d2"]["n_lanes"] == 24
    assert by["fabric_d2"]["worker_start_s"] > 0
    assert "worker_start_s" not in by["fabric_d1"]
    base = grids["fabric_d1"]
    for name in ("fabric_d2", "fabric_mesh1"):
        for f in dataclasses.fields(base.result):
            a = getattr(grids[name].result, f.name)
            b = getattr(base.result, f.name)
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                (name, f.name)


def test_bench_kernels_rows_on_the_cpu():
    rows = bench_kernels.run(device="cpu")
    assert {r["name"] for r in rows} == KERNELS
    for r in rows:
        assert r["device"] == "cpu" and r["us"] is None, r
        assert r["plain_us"] > 0 and r["bound_us"] > 0, r
        assert r["bound_by"] in ("bytes", "operations") and r["bound_how"]
        assert (r["library"] is None) == (r["library_us"] is None), r
    libs = {r["name"] for r in rows if r["library"]}
    assert libs == {"lane_scatter", "flash_attention", "decode_attention"}
    assert sum(r["name"] == "gla_chunk" for r in rows) == 2


def test_probe_memory_stream_is_the_reference_stream():
    s, p = jstream(10_000, 500, seed=3), probe_memory._simstate_stream(
        10_000, 500, seed=3)
    for f in ("times", "objs", "sizes", "z_mean", "z_draw"):
        a, b = getattr(s, f), getattr(p, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_probe_memory_child_rows_hold_against_jax():
    n, n_req = 10_000, 3_000
    rows = probe_memory.run_simstate_probe(sizes=(n,), n_requests=n_req,
                                           device="cpu")
    assert [(r["mode"], r["status"]) for r in rows] == [
        ("baseline", "ok"), ("dense", "ok"), ("slots", "ok")]
    base, rows = rows[0], rows[1:]
    assert base["peak_rss_mb"] > 0 and base["peak_device_mb"] == ""
    s = jstream(n, n_req)
    touched = np.unique(s.objs)
    cap = 0.1 * float(s.sizes[touched].sum())
    for r in rows:
        want = jsimulate_stream(s, cap, "stoch_vacdh", JPP(omega=1.0),
                                estimate_z=True, chunk_size=16_384,
                                state_mode=r["mode"])
        for f in ("n_hits", "n_delayed", "n_misses", "n_evictions"):
            assert r[f] == int(getattr(want, f)), (r["mode"], f)
        assert r["latency"] == pytest.approx(float(want.total_latency),
                                             rel=RTOL)
        assert r["hit_ratio"] == pytest.approx(float(want.hit_ratio),
                                               rel=RTOL)
        assert r["distinct_touched"] == touched.size
        assert r["peak_rss_mb"] > 0 and r["peak_device_mb"] == ""
        assert r["rss_over_baseline_mb"] == round(
            r["peak_rss_mb"] - base["peak_rss_mb"], 1)
        assert "device_over_baseline_mb" not in r
    assert rows[1]["n_slots"] == 4096
