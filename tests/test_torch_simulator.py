"""The port's simulator against the JAX package's on the same traces
(including the pre-drawn miss latencies): counters exactly, latency totals
to rtol=1e-5 (f32 sums of identically rounded terms, in the same Kahan
order).  AdaptSize draws its admission coin from the port's threefry
(repro_torch.core.prng), which reproduces jax.random's bits, so it is held
exactly as well as statistically."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PolicyParams as JPP
from repro.core import simulate as jsimulate
from repro.core import sweep_grid
from repro.core import latency_improvement as jlatency_improvement
from repro.core.trace import Trace as JTrace
from repro.data.traces import SyntheticSpec as JSpec
from repro.data.traces import synthetic_trace as jsynthetic_trace
from repro_torch.convert import trace_from_arrays
from repro_torch.core import (POLICIES, PolicyParams, latency_improvement,
                              simulate)
from repro_torch.core.simulator import _run
from repro_torch.data.traces import SyntheticSpec, synthetic_trace

RTOL = 1e-5
COUNTERS = ("n_hits", "n_delayed", "n_misses", "n_evictions")
POLS = sorted(p for p in POLICIES if p != "adaptsize")
SPEC = JSpec(n_objects=20, n_requests=400, rate=300.0, size_min=1.0,
             size_max=20.0, latency_base=0.01, latency_per_mb=1e-3,
             stochastic=True)
CAP = 50.0


def _port(jtrace):
    return trace_from_arrays(*(np.asarray(x) for x in jtrace), device="cpu")


@functools.lru_cache(maxsize=None)
def _reference(estimate_z: bool):
    """One JAX trace and one compiled grid over every policy (bitwise equal
    to per-policy simulate, as the JAX package pins)."""
    jt = jsynthetic_trace(jax.random.key(0), SPEC)
    grid = sweep_grid(jt, CAP, POLS, JPP(), estimate_z=estimate_z)
    return _port(jt), {p: grid.point(0, i, 0, 0, 0)
                       for i, p in enumerate(POLS)}


def _assert_matches(got, want, msg=""):
    for f in COUNTERS:
        assert int(getattr(got, f)) == int(getattr(want, f)), (msg, f)
    np.testing.assert_allclose(float(got.total_latency),
                               float(want.total_latency), rtol=RTOL,
                               err_msg=msg)


@pytest.mark.parametrize("policy", POLS)
@pytest.mark.parametrize("estimate_z", [False, True])
def test_simulate_matches_jax(policy, estimate_z):
    trace, want = _reference(estimate_z)
    got = simulate(trace, CAP, policy, estimate_z=estimate_z,
                   use_kernel=False, device="cpu")
    _assert_matches(got, want[policy], policy)
    assert int(got.n_evictions) > 0


@pytest.mark.parametrize("policy", POLS)
def test_legacy_eviction_loop_matches_jax(policy):
    """evict_top=0: the per-eviction argmin loop alone (phase 2)."""
    trace, want = _reference(True)
    got = simulate(trace, CAP, policy, estimate_z=True, use_kernel=False,
                   evict_top=0, device="cpu")
    _assert_matches(got, want[policy], policy)


@pytest.mark.parametrize("use_kernel", [None, True, "ref"])
@pytest.mark.parametrize("evict_top", [None, 0])
def test_kernel_scored_path_matches_jax(use_kernel, evict_top):
    """The eq.-16 kernel family's plain versions on the CPU, including tiny
    capacities where fewer objects are cached than the order holds."""
    jt = jsynthetic_trace(jax.random.key(6), SPEC)
    trace = _port(jt)
    for cap in (5.0, 12.0):
        want = jsimulate(jt, cap, "stoch_vacdh", use_kernel="ref")
        got = simulate(trace, cap, "stoch_vacdh", use_kernel=use_kernel,
                       evict_top=evict_top, device="cpu")
        _assert_matches(got, want, f"cap={cap}")


def test_phase2_fallback_beyond_order_length():
    """One admission that must evict more victims than ``evict_top``."""
    n = 24
    times = np.concatenate([np.arange(1, n + 1), [26.0]]).astype(np.float32)
    objs = np.concatenate([np.arange(1, n), [0, 1]]).astype(np.int32)
    sizes = np.ones(n, np.float32)
    sizes[0] = 18.0
    z_mean = np.full(n, 0.25, np.float32)
    z_draw = np.full(n + 1, 0.25, np.float32)
    want = jsimulate(JTrace(*(jnp.asarray(a) for a in
                              (times, objs, sizes, z_mean, z_draw))),
                     20.0, "lru")
    trace = trace_from_arrays(times, objs, sizes, z_mean, z_draw,
                              device="cpu")
    for top in (4, 0, None):
        got = simulate(trace, 20.0, "lru", evict_top=top, device="cpu")
        _assert_matches(got, want, f"evict_top={top}")
        assert int(got.n_evictions) >= 18


def _toy_trace():
    """Paper §2.2: cache size 1, z=4, A A A B A A A B B B B A A B B B B."""
    seq = "AAABAAABBBBAABBBB"
    objs = [0 if c == "A" else 1 for c in seq]
    times = np.arange(1, len(seq) + 1, dtype=np.float32)
    return trace_from_arrays(times, objs, [1.0, 1.0], [4.0, 4.0],
                             np.full(len(seq), 4.0, np.float32),
                             device="cpu")


@pytest.mark.parametrize("policy,total", [("toy_mean", 33.0),
                                          ("toy_meanstd", 30.0)])
def test_paper_toy_example_totals(policy, total):
    r = simulate(_toy_trace(), 1.0, policy, device="cpu")
    assert float(r.total_latency) == total
    if policy == "toy_mean":
        assert (int(r.n_misses), int(r.n_delayed), int(r.n_hits)) == (4, 8, 5)


def test_just_touched_incomer_does_not_steamroll_admission():
    times = np.array([0.5, 0.6, 1.0, 1.0, 2.0, 3.0], np.float32)
    objs = np.array([1, 1, 0, 1, 1, 0], np.int32)
    z_draw = np.array([0.05, 1.0, 0.0, 1.0, 1.0, 1.0], np.float32)
    trace = trace_from_arrays(times, objs, np.ones(2), np.ones(2), z_draw,
                              device="cpu")
    r = simulate(trace, 1.0, "stoch_vacdh", device="cpu")
    assert (int(r.n_evictions), int(r.n_hits), int(r.n_misses)) == (0, 3, 3)


def test_latency_improvement_lanes_bitwise_match_simulate():
    """Two lanes of one state == two single-lane runs, bit for bit (the
    AdaptSize lane too, given the same coin key), and the ratio
    matches JAX's eq. 17."""
    jt = jsynthetic_trace(jax.random.key(7), SPEC)
    trace = _port(jt)
    for pair in (("stoch_vacdh", "lru"), ("lru_mad", "adaptsize")):
        lanes = _run(trace, CAP, pair, None, (0, 3), True, None, None,
                     "cpu", None)
        impr = latency_improvement(trace, CAP, *pair, estimate_z=True,
                                   key=(0, 3), device="cpu")
        for lane, pol in zip(lanes, pair):
            single = simulate(trace, CAP, pol, estimate_z=True, key=(0, 3),
                              device="cpu")
            for f in ("total_latency",) + COUNTERS:
                assert float(getattr(lane, f)) == float(getattr(single, f))
        la, lb = lanes[0].total_latency, lanes[1].total_latency
        assert float(impr) == float((lb - la) / lb)
    want = jlatency_improvement(jt, CAP, "stoch_vacdh", "lru",
                                estimate_z=True)
    got = latency_improvement(trace, CAP, "stoch_vacdh", "lru",
                              estimate_z=True, device="cpu")
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_adaptsize_statistically():
    """Different coin bits, the same admission law: over a longer trace
    the hit ratios agree to within a few points."""
    spec = JSpec(n_objects=30, n_requests=2000, rate=300.0, size_min=1.0,
                 size_max=40.0, latency_base=0.01, latency_per_mb=1e-3)
    jt = jsynthetic_trace(jax.random.key(1), spec)
    want = jsimulate(jt, 80.0, "adaptsize", params=JPP(adapt_c=15.0))
    got = simulate(_port(jt), 80.0, "adaptsize",
                   params=PolicyParams(adapt_c=15.0),
                   device="cpu")
    assert int(got.n_requests) == 2000
    hr = lambda r: float(r.n_hits) / 2000
    assert abs(hr(got) - hr(want)) < 0.05


_ADAPT_SPEC = JSpec(n_objects=30, n_requests=600, rate=300.0, size_min=1.0,
                    size_max=40.0, latency_base=0.01, latency_per_mb=1e-3,
                    stochastic=True)


@pytest.mark.parametrize("seed", [0, 5, 2**32 - 1])
@pytest.mark.parametrize("estimate_z", [False, True])
def test_adaptsize_exactly_matches_jax(seed, estimate_z):
    """The coin stream is jax.random's: counters equal, latency to RTOL,
    for simulate and for the AdaptSize lane of latency_improvement."""
    jt = jsynthetic_trace(jax.random.key(1), _ADAPT_SPEC)
    jkey = jax.random.key(seed)
    key = tuple(int(k) for k in jax.random.key_data(jkey))
    jp, p = JPP(adapt_c=15.0), PolicyParams(adapt_c=15.0)
    want = jsimulate(jt, 80.0, "adaptsize", params=jp, key=jkey,
                     estimate_z=estimate_z)
    got = simulate(_port(jt), 80.0, "adaptsize", params=p, key=key,
                   estimate_z=estimate_z, device="cpu")
    _assert_matches(got, want, f"seed={seed}")
    assert 0 < int(got.n_misses) < 600 and int(got.n_hits) > 0
    jimpr = jlatency_improvement(jt, 80.0, "adaptsize", "lru", params=jp,
                                 key=jkey, estimate_z=estimate_z)
    impr = latency_improvement(_port(jt), 80.0, "adaptsize", "lru",
                               params=p, key=key, estimate_z=estimate_z,
                               device="cpu")
    np.testing.assert_allclose(float(impr), float(jimpr), rtol=RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 3, 2**32 - 1])
def test_prng_split_and_uniform_equal_jax_bits(seed):
    from repro_torch.core import prng
    jkey = jax.random.key(seed)
    key = tuple(int(k) for k in jax.random.key_data(jkey))
    for _ in range(4):
        jkey, jsub = jax.random.split(jkey)
        key, sub = prng.split(key)
        assert key == tuple(int(k) for k in jax.random.key_data(jkey))
        assert sub == tuple(int(k) for k in jax.random.key_data(jsub))
        want = np.asarray(jax.random.uniform(jsub), np.float32)
        got = prng.uniform(sub)
        assert isinstance(got, np.float32)
        assert got.view(np.uint32) == want.view(np.uint32)


def test_counters_report_syncs():
    trace, _ = _reference(False)
    c = {}
    simulate(trace, CAP, "lru", device="cpu", counters=c)
    assert c["requests"] == 400
    # serves and commits read nothing back: scoring commits and
    # per-eviction argmins are the only read-backs
    assert c["syncs"] == c["scoring_commits"] + c["argmins"]
    assert 0 < c["scoring_commits"] <= c["commits"]


@pytest.mark.parametrize("fn", ["simulate", "latency_improvement"])
@pytest.mark.parametrize("use_kernel", [True, "ref"])
def test_engine_scatter_is_one_batch_call(fn, use_kernel, monkeypatch):
    """The engine's cached-bit writes (evictions, admissions) are ops of
    the point-update journal beside its serves and commits, not
    ``lane_scatter_batch`` calls: each flush hands everything queued since
    the last device read to one block (one launch on the card), one flush
    a read-back plus one for the results.  On the CPU nothing launches."""
    from repro_torch.kernels import lane_scatter as ls
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels import point_update as pu
    flushes, sets = [], []
    flush, set_cached = pu.PointUpdate.flush, pu.PointUpdate.set_cached

    def counting(self):
        flushes.append(self.pending)
        blocks = self.n_blocks
        flush(self)
        assert self.pending == 0
        assert self.n_blocks - blocks == (1 if flushes[-1] else 0)

    def setting(self, *a):
        sets.append(1)
        return set_cached(self, *a)

    monkeypatch.setattr(pu.PointUpdate, "flush", counting)
    monkeypatch.setattr(pu.PointUpdate, "set_cached", setting)
    trace, _ = _reference(True)
    calls0, c = ls.calls["lane_scatter_batch"], {}
    if fn == "simulate":
        simulate(trace, CAP, "stoch_vacdh", estimate_z=True,
                 use_kernel=use_kernel, device="cpu", counters=c)
    else:
        latency_improvement(trace, CAP, "stoch_vacdh", "lru",
                            estimate_z=True, use_kernel=use_kernel,
                            device="cpu", counters=c)
    assert ls.calls["lane_scatter_batch"] == calls0
    assert len(flushes) == c["syncs"] + 1
    assert 0 < len(sets) and max(flushes) >= 3
    assert launch_counts()["lane_scatter"] == 0
    assert launch_counts()["point_update"] == 0


def test_synthetic_generator_statistics():
    spec = SyntheticSpec(n_objects=50, n_requests=20_000, zipf_alpha=0.9,
                         rate=2000.0)
    tr = synthetic_trace(torch.Generator().manual_seed(0), spec,
                         device="cpu")
    sizes = tr.sizes.numpy()
    assert sizes.min() >= 1.0 and sizes.max() <= 100.0
    assert np.all(sizes == np.floor(sizes))
    gaps = np.diff(tr.times.numpy().astype(np.float64))
    assert np.all(gaps >= 0)
    np.testing.assert_allclose(gaps.mean(), 1.0 / 2000.0, rtol=0.03)
    freq = np.bincount(tr.objs.numpy(), minlength=50) / 20_000
    p = np.arange(1, 51, dtype=np.float64) ** -0.9
    np.testing.assert_allclose(freq[:5], (p / p.sum())[:5], rtol=0.1)
    z = tr.z_mean.numpy()
    np.testing.assert_allclose(z, 0.005 + 2e-4 * sizes, rtol=1e-6)
    ratio = tr.z_draw.numpy() / z[tr.objs.numpy()]
    np.testing.assert_allclose(ratio.mean(), 1.0, rtol=0.03)
    pareto = synthetic_trace(torch.Generator().manual_seed(1),
                             SyntheticSpec(n_objects=10, n_requests=20_000,
                                           rate=100.0, arrival="pareto",
                                           pareto_shape=2.5),
                             device="cpu")
    g = np.diff(pareto.times.numpy().astype(np.float64))
    np.testing.assert_allclose(g.mean(), 0.01, rtol=0.05)


def test_state_init_and_shift_match_jax():
    """Dense state fields, the time rebase and the Kahan sum, field by
    field against the JAX package's state module."""
    from repro.core import state as jstate
    from repro_torch.core import state as pstate
    z = np.linspace(0.01, 0.05, 7).astype(np.float32)
    js = jstate.init_state(7, 30.0, jax.random.key(0), jnp.asarray(z))
    ps = pstate.init_state(7, 30.0, torch.from_numpy(z), n_lanes=2,
                           device="cpu")
    for name in ("cached", "in_flight") + pstate.F32_FIELDS:
        want = np.asarray(getattr(js.obj, name))
        for lane in range(2):
            np.testing.assert_array_equal(
                getattr(ps.obj, name)[lane].numpy(), want, err_msg=name)
    js = jstate.shift_times(js._replace(min_complete=jnp.float32(3.0)), 1.5)
    ps.min_complete.fill_(3.0)
    pstate.shift_times(ps, 1.5)
    for name in ("complete_t", "issue_t", "last_access", "first_access"):
        np.testing.assert_array_equal(getattr(ps.obj, name)[0].numpy(),
                                      np.asarray(getattr(js.obj, name)))
    assert float(ps.min_complete[1]) == float(js.min_complete)
    xs = np.random.default_rng(0).exponential(0.01, 5000).astype(np.float32)
    jt, jc = jnp.float32(0), jnp.float32(0)
    pt, pc = np.zeros(1, np.float32), np.zeros(1, np.float32)
    for x in xs[:300]:
        jt, jc = jstate.kahan_add(jt, jc, jnp.float32(x))
        pt, pc = pstate.kahan_add(pt, pc, np.array([x], np.float32))
    assert float(pt[0]) == float(jt) and float(pc[0]) == float(jc)
