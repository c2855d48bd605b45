"""The port's ``fig_realworld`` figure on the CPU at 3,000 requests over 800
keys: every section's rows, and its roster against the JAX package's
``simulate_stream`` on the same compacted stream (counters exactly,
latency to rtol=1e-5).  The JAX functions are called directly:
``benchmarks.fig_realworld.run`` writes the root's BENCH_stream.json.
Also the ``realworld`` job of ``figures/run.py``."""
import functools

import numpy as np
import pytest

from repro.core import PolicyParams as JPolicyParams
from repro.core import simulate_stream as jsimulate_stream
from repro_torch.figures import fig_realworld, run as runner

RTOL = 1e-5
N_REQUESTS, N_KEYS = 3000, 800
COUNTERS = ("n_hits", "n_delayed", "n_misses", "n_evictions")


@functools.lru_cache(maxsize=None)
def _run():
    res = {}
    rows = fig_realworld.run(device="cpu", n_requests=N_REQUESTS,
                             n_keys=N_KEYS, results=res)
    return rows, res


def test_every_section_has_its_rows():
    rows, res = _run()
    by = {}
    for r in rows:
        by.setdefault((r["section"], r["mode"]), []).append(r)
    assert [r["policy"] for r in by["roster", "stream"]] == \
        ["lru"] + [p for p in fig_realworld.POLICY_SET if p != "lru"]
    assert len(by["overhead", "device"]) == 1
    assert by["overhead", "stream_auto"][0]["chunk_auto"] == N_REQUESTS
    assert [(r["top_k"], r["policy"]) for r in by["compaction", "stream"]] \
        == [(k, p) for k in fig_realworld.PROBE_TOP_K
            for p in ("lru", "stoch_vacdh")]
    exact = by["compaction", "stream_slots"]
    assert [r["top_k"] for r in exact] == ["exact", "exact"]
    assert set(by) == {("roster", "stream"), ("overhead", "device"),
                       ("overhead", "stream_auto"), ("compaction", "stream"),
                       ("compaction", "stream_slots")}
    for r in rows:
        assert r["req_per_s"] > 0 and r["peak_rss_mb"] > 0
        assert np.isfinite(r["latency"])
    # the rebased device row and the one-chunk auto row replay the roster's
    # single chunk: the same eq.-16 result
    stoch = res["roster", "stream", None, "stoch_vacdh"]
    for mode in ("device", "stream_auto"):
        assert float(res["overhead", mode, None, "stoch_vacdh"]
                     .total_latency) == float(stoch.total_latency)
    # the exact slot rows see every key; compaction at top_k >= the
    # distinct keys aliases nothing, so the deltas are 0
    slots = res["compaction", "stream_slots", "exact", "stoch_vacdh"]
    full = res["compaction", "stream", 16_384, "stoch_vacdh"]
    assert float(slots.total_latency) == float(full.total_latency)


@pytest.mark.parametrize("policy", fig_realworld.POLICY_SET)
def test_roster_matches_jax_simulate_stream(policy):
    """One chunk holds the 3,000 requests, so the JAX stream replays them
    in one chunk of that size (its fixed 131,072 would only add padded
    steps)."""
    _, res = _run()
    stream, capacity = res["roster_stream"]
    want = jsimulate_stream(stream, capacity, policy,
                            JPolicyParams(omega=1.0), estimate_z=True,
                            chunk_size=N_REQUESTS)
    got = res["roster", "stream", None, policy]
    for f in COUNTERS:
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    np.testing.assert_allclose(float(got.total_latency),
                               float(want.total_latency), rtol=RTOL)


def test_realworld_job_runs_only_when_named(monkeypatch, capsys):
    calls = []
    for mod in ("fig2_synthetic", "fig3_trace_stats", "fig4_sensitivity",
                "fig5_real_traces", "fig6_hierarchy", "bench_kernels",
                "bench_sweep", "bench_serving", "fig_realworld"):
        monkeypatch.setattr(f"repro_torch.figures.{mod}.run",
                            lambda mod=mod, **kw: calls.append((mod, kw))
                            or [])
    monkeypatch.setattr(runner, "_memory", lambda d: calls.append(
        ("memory", {})))
    assert runner.main(["--device", "cpu"]) == 0
    names = [m for m, _ in calls]
    assert "fig_realworld" not in names and "memory" not in names
    assert len(names) == len(runner.JOBS) - len(runner.NAMED_ONLY)
    calls.clear()
    assert runner.main(["--only", "realworld", "--device", "cpu",
                        "--exact-full"]) == 0
    assert calls == [("fig_realworld", dict(full=False, exact_full=True,
                                            device="cpu", n_requests=None))]
    calls.clear()
    assert runner.main(["--only", "realworld", "--full", "--requests",
                        "2000", "--device", "cpu"]) == 0
    assert calls == [("fig_realworld", dict(full=True, exact_full=False,
                                            device="cpu", n_requests=2000))]
    with pytest.raises(SystemExit):
        runner.main(["--only", "realworld,fig9", "--device", "cpu"])
    assert "=== realworld ===" in capsys.readouterr().out
