"""The port's two-tier hierarchy and its grid against the JAX package's
(tests/test_hierarchy.py, the hierarchy cases of tests/test_sweep.py and
tests/test_streaming.py).

* ``simulate_hier`` equals JAX's on the same ``HierTrace`` arrays at every
  tier (counters exactly, latency to rtol=1e-5) and the event-driven
  oracle (counters exactly, latency to the reference's rtol=2e-4);
* the degenerate hierarchy is single-tier ``simulate`` bit for bit;
* every ``sweep_hier_grid`` point is its ``simulate_hier`` call bit for
  bit, and JAX's grid point with counters exactly equal;
* the chunked hierarchy is the single run bit for bit;
* the hash route equals the reference's bit for bit, and the hierarchy's
  key split equals ``jax.random.split``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sweep_hier_grid as jsweep_hier_grid
from repro.core.distributions import Erlang as JErlang
from repro.core.hierarchy import make_hier_trace as jmake_hier_trace
from repro.core.hierarchy import simulate_hier as jsimulate_hier
from repro.core.ranking import PolicyParams as JPolicyParams
from repro.core.trace import Trace as JTrace
from repro.data.traces import SyntheticSpec, synthetic_trace
from repro_torch.convert import hier_trace_from_arrays, trace_from_arrays
from repro_torch.core import (Erlang, PolicyParams, make_hier_trace, prng,
                              simulate, simulate_hier, simulate_hier_chunked,
                              sweep_hier_grid)
from repro_torch.core.hierarchy import hash_shards
from repro_torch.core.refsim import simulate_hier_ref

RTOL = 1e-5
FIELDS = ("total_latency", "n_hits", "n_delayed", "n_misses", "n_evictions")

SPEC = SyntheticSpec(n_objects=30, n_requests=900, rate=400.0,
                     size_min=1.0, size_max=12.0,
                     latency_base=0.01, latency_per_mb=2e-3)


@functools.lru_cache(maxsize=None)
def _jtrace(seed=0, n_requests=900):
    spec = dataclasses.replace(SPEC, n_requests=n_requests)
    return synthetic_trace(jax.random.key(seed), spec)


@functools.lru_cache(maxsize=None)
def _hier(seed=0, n_shards=3, route="random", hop_mean=0.004, key=99,
          n_requests=900):
    """(JAX HierTrace, the port's CPU HierTrace) on the same arrays."""
    jh = jmake_hier_trace(_jtrace(seed, n_requests), n_shards,
                          key=jax.random.key(key), hop_mean=hop_mean,
                          hop_dist=JErlang(k=4), route=route)
    return jh, hier_trace_from_arrays(*(np.asarray(x) for x in jh),
                                      device="cpu")


def _assert_bitwise(a, b, msg=""):
    """Two HierResults, every field of both tiers bit for bit."""
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a.per_shard, f).numpy(),
                                      getattr(b.per_shard, f).numpy(),
                                      err_msg=f"{msg} per_shard {f}")
        assert float(getattr(a.l2, f)) == float(getattr(b.l2, f)), \
            (msg, "l2", f)


def _assert_vs_jax(got, want, msg=""):
    for tier in ("per_shard", "l2"):
        g, w = getattr(got, tier), getattr(want, tier)
        for f in FIELDS[1:]:
            np.testing.assert_array_equal(
                getattr(g, f).numpy().astype(np.int64),
                np.asarray(getattr(w, f)).astype(np.int64),
                err_msg=f"{msg} {tier} {f}")
        np.testing.assert_allclose(g.total_latency.numpy(),
                                   np.asarray(w.total_latency), rtol=RTOL,
                                   err_msg=f"{msg} {tier}")


def test_degenerate_hierarchy_is_bitwise_single_tier():
    """n_shards=1, an empty L2 and a zero hop: the L2 passes through and
    the hierarchy is single-tier ``simulate`` bit for bit."""
    pt = trace_from_arrays(*(np.asarray(x) for x in _jtrace()),
                           device="cpu")
    ht = make_hier_trace(pt, 1, hop_mean=0.0)
    hr = simulate_hier(ht, 1, 100.0, 0.0, "stoch_vacdh", estimate_z=True,
                       device="cpu")
    sr = simulate(pt, 100.0, "stoch_vacdh", estimate_z=True, device="cpu")
    assert float(hr.total_latency) == float(sr.total_latency)
    for f in ("n_hits", "n_delayed", "n_misses"):
        assert float(getattr(hr, f)) == float(getattr(sr, f)), f
    assert float(hr.per_shard.n_evictions.sum()) == float(sr.n_evictions)


@pytest.mark.parametrize("policy", ["lru", "lhd", "vacdh", "stoch_vacdh",
                                    "lru_mad"])
@pytest.mark.parametrize("route", ["hash", "random"])
def test_hier_matches_jax_and_event_driven(policy, route):
    jh, ph = _hier(route=route)
    got = simulate_hier(ph, 3, 30.0, 90.0, policy, l2_policy="lru",
                        device="cpu")
    _assert_vs_jax(got, jsimulate_hier(jh, 3, 30.0, 90.0, policy,
                                       l2_policy="lru"), policy)
    ref = simulate_hier_ref(ph, 3, 30.0, 90.0, policy, l2_policy="lru")
    for f in FIELDS[1:]:
        assert int(getattr(got.per_shard, f).sum()) == ref[f], f
        assert int(getattr(got.l2, f)) == ref["l2"][f], ("l2", f)
    np.testing.assert_allclose(float(got.total_latency),
                               ref["total_latency"], rtol=2e-4)
    np.testing.assert_allclose(float(got.l2.total_latency),
                               ref["l2"]["total_latency"], rtol=2e-4)
    for s in range(3):
        for f in ("n_hits", "n_delayed", "n_misses"):
            assert int(getattr(got.per_shard, f)[s]) == \
                ref["per_shard"][s][f], (s, f)


def test_adaptsize_hierarchy_matches_jax():
    """The coin keys: one per shard and one for the L2, split from the
    hierarchy's key as ``jax.random.split(key, n_shards + 1)``."""
    jh, ph = _hier(route="hash")
    for s in (0, 5):
        got = simulate_hier(ph, 3, 30.0, 90.0, "adaptsize",
                            l2_policy="adaptsize", key=prng.key_data(s),
                            device="cpu")
        _assert_vs_jax(got, jsimulate_hier(jh, 3, 30.0, 90.0, "adaptsize",
                                           l2_policy="adaptsize",
                                           key=jax.random.key(s)), s)


def test_l2_arrivals_are_exactly_l1_misses():
    _, ph = _hier()
    r = simulate_hier(ph, 3, 25.0, 80.0, "stoch_vacdh", device="cpu")
    l2_arrivals = int(r.l2.n_hits) + int(r.l2.n_delayed) + int(r.l2.n_misses)
    assert l2_arrivals == int(r.n_misses)
    assert int(r.n_requests) == SPEC.n_requests


def test_l2_capacity_absorbs_latency():
    _, ph = _hier(n_shards=4)
    cold = simulate_hier(ph, 4, 20.0, 0.0, "lru", device="cpu")
    warm = simulate_hier(ph, 4, 20.0, 200.0, "lru", device="cpu")
    assert int(warm.l2.n_hits) > 0
    assert float(warm.total_latency) < float(cold.total_latency)


def test_hash_route_matches_jax_and_is_object_consistent():
    jh, ph = _hier(route="hash")
    np.testing.assert_array_equal(ph.shards.numpy(), np.asarray(jh.shards))
    pt = trace_from_arrays(*(np.asarray(x) for x in _jtrace()),
                           device="cpu")
    np.testing.assert_array_equal(make_hier_trace(pt, 3).shards.numpy(),
                                  np.asarray(jh.shards))
    objs, shards = ph.objs.numpy(), ph.shards.numpy()
    for o in np.unique(objs):
        assert len(np.unique(shards[objs == o])) == 1
    assert len(np.unique(shards)) == 3
    ids = torch.arange(0, 2 ** 31 - 1, 7_654_321, dtype=torch.int32)
    for n in (1, 2, 3, 4, 8):
        want = (np.asarray(ids).astype(np.uint32)
                * np.uint32(2654435761)) >> np.uint32(16)
        np.testing.assert_array_equal(hash_shards(ids, n).numpy(),
                                      (want % np.uint32(n)).astype(np.int32))


def test_hash_routing_mixes_structured_ids():
    times = np.arange(1.0, 201.0, dtype=np.float32)
    objs = (np.arange(200) % 50) * 2          # only even ids
    tr = trace_from_arrays(times, objs, np.ones(100), np.full(100, 0.01),
                           np.full(200, 0.01), device="cpu")
    jtr = JTrace(jnp.asarray(times), jnp.asarray(objs, jnp.int32),
                 jnp.ones(100), jnp.full(100, 0.01), jnp.full(200, 0.01))
    for n_shards in (2, 4):
        ht = make_hier_trace(tr, n_shards, route="hash")
        assert len(np.unique(ht.shards.numpy())) == n_shards
        np.testing.assert_array_equal(
            ht.shards.numpy(),
            np.asarray(jmake_hier_trace(jtr, n_shards).shards))


def test_random_route_and_hops_from_the_generator():
    pt = trace_from_arrays(*(np.asarray(x) for x in _jtrace()),
                           device="cpu")
    a = make_hier_trace(pt, 4, generator=torch.Generator().manual_seed(3),
                        hop_mean=0.01, hop_dist=Erlang(k=4.0),
                        route="random")
    b = make_hier_trace(pt, 4, generator=torch.Generator().manual_seed(3),
                        hop_mean=0.01, hop_dist=Erlang(k=4.0),
                        route="random")
    assert torch.equal(a.shards, b.shards) and torch.equal(a.hop_draw,
                                                           b.hop_draw)
    assert set(np.unique(a.shards.numpy())) == {0, 1, 2, 3}
    assert a.hop_mean == float(np.float32(0.01))
    np.testing.assert_allclose(float(a.hop_draw.mean()), 0.01, rtol=0.1)


def test_shard_count_mismatch_rejected():
    pt = trace_from_arrays(*(np.asarray(x) for x in _jtrace()),
                           device="cpu")
    ht = make_hier_trace(pt, 4, route="random")
    with pytest.raises(ValueError, match="n_shards=2"):
        simulate_hier(ht, 2, 10.0, 10.0, device="cpu")
    with pytest.raises(ValueError, match="n_shards=2"):
        sweep_hier_grid(ht, 2, 10.0, 10.0, "lru", device="cpu")


def test_bad_route_shards_and_policies_rejected():
    pt = trace_from_arrays(*(np.asarray(x) for x in _jtrace()),
                           device="cpu")
    with pytest.raises(ValueError, match="route"):
        make_hier_trace(pt, 2, route="round_robin")
    ht = make_hier_trace(pt, 2)
    with pytest.raises(ValueError, match="n_shards"):
        simulate_hier(ht, 0, 10.0, 10.0, device="cpu")
    with pytest.raises(ValueError, match="unknown policy"):
        simulate_hier(ht, 2, 10.0, 10.0, l2_policy="lur", device="cpu")
    with pytest.raises(ValueError, match="unknown policies"):
        sweep_hier_grid(ht, 2, 10.0, 10.0, "lru", l2_policy="lur",
                        device="cpu")
    # devices= / mesh= route through the fabric, which takes one of them
    from repro_torch.launch.mesh import make_data_mesh
    with pytest.raises(ValueError, match="not both"):
        sweep_hier_grid(ht, 2, 10.0, 10.0, "lru", devices=2,
                        mesh=make_data_mesh(1, ["cpu"]), device="cpu")
    with pytest.raises(ValueError, match="chunk_size"):
        simulate_hier_chunked(ht, 2, 10.0, 10.0, chunk_size=0, device="cpu")


def test_l2_params_default_is_decoupled_from_l1_params():
    _, ph = _hier()
    p = PolicyParams(omega=3.0, window=8)
    kw = dict(l2_policy="stoch_vacdh", params=p, device="cpu")
    a = simulate_hier(ph, 3, 30.0, 90.0, "stoch_vacdh", **kw)
    b = simulate_hier(ph, 3, 30.0, 90.0, "stoch_vacdh",
                      l2_params=PolicyParams(), **kw)
    assert float(a.total_latency) == float(b.total_latency)
    c = simulate_hier(ph, 3, 30.0, 90.0, "stoch_vacdh", l2_params=p, **kw)
    assert float(a.l2.total_latency) != float(c.l2.total_latency)


def test_plain_writes_equal_the_default_writes():
    _, ph = _hier(route="hash")
    a = simulate_hier(ph, 3, 30.0, 90.0, "stoch_vacdh", device="cpu")
    b = simulate_hier(ph, 3, 30.0, 90.0, "stoch_vacdh", use_kernel="ref",
                      device="cpu")
    c = simulate_hier(ph, 3, 30.0, 90.0, "stoch_vacdh", use_kernel=True,
                      device="cpu")
    _assert_bitwise(a, b)
    _assert_bitwise(a, c)


def test_counters_count_requests_once_and_both_tiers_syncs():
    _, ph = _hier()
    c = {}
    simulate_hier(ph, 3, 30.0, 90.0, "lru", device="cpu", counters=c)
    assert c["requests"] == SPEC.n_requests
    # the L1 read and both tiers' serves and commits read nothing back:
    # both tiers' scoring commits and argmins are the only read-backs
    assert c["syncs"] == c["scoring_commits"] + c["argmins"] > 0


# --- chunked == single ----------------------------------------------------------
@pytest.mark.parametrize("chunk_size", [7, 900, 2500])
def test_chunked_hierarchy_bitwise_matches_single(chunk_size):
    jh, ph = _hier(key=5, n_requests=2500)
    base = simulate_hier(ph, 3, 20.0, 90.0, "stoch_vacdh", device="cpu")
    got = simulate_hier_chunked(ph, 3, 20.0, 90.0, "stoch_vacdh",
                                chunk_size=chunk_size, device="cpu")
    _assert_bitwise(base, got, f"chunk {chunk_size}")
    if chunk_size == 900:
        _assert_vs_jax(got, jsimulate_hier(jh, 3, 20.0, 90.0,
                                           "stoch_vacdh"))


# --- the hierarchy grid ------------------------------------------------------------
def _assert_points(g, ph, n_shards, names, params_list, c1s, c2s, seeds,
                   l2_policy="lru", ti=0):
    for li, pol in enumerate(names):
        for pi, p in enumerate(params_list):
            for i1, c1 in enumerate(c1s):
                for i2, c2 in enumerate(c2s):
                    for si, s in enumerate(seeds):
                        ref = simulate_hier(ph, n_shards, c1, c2, pol,
                                            l2_policy=l2_policy, params=p,
                                            key=prng.key_data(s),
                                            device="cpu")
                        _assert_bitwise(g.point(ti, li, pi, i1, i2, si), ref,
                                        f"{pol} {pi} {c1} {c2} {s}")


def _jgrid_point(jg, ix):
    from repro.core.hierarchy import HierResult as JHierResult
    from repro.core.simulator import SimResult as JSimResult
    return JHierResult(
        per_shard=JSimResult(*(f[ix] for f in jg.result.per_shard)),
        l2=JSimResult(*(f[ix] for f in jg.result.l2)))


def test_hier_single_policy_grid_matches_simulate_hier_and_jax():
    jh, ph = _hier(key=5)
    omegas = (0.0, 1.0)
    params = [PolicyParams(omega=o) for o in omegas]
    c1s, c2s = [20.0, 40.0], [0.0, 90.0]
    g = sweep_hier_grid(ph, 3, c1s, c2s, "stoch_vacdh", params, seeds=(0, 4),
                        device="cpu")
    assert g.result.l2.total_latency.shape == (1, 1, 2, 2, 2, 2)
    assert g.result.per_shard.total_latency.shape == (1, 1, 2, 2, 2, 2, 3)
    _assert_points(g, ph, 3, ["stoch_vacdh"], params, c1s, c2s, (0, 4))
    jg = jsweep_hier_grid(jh, 3, c1s, c2s, "stoch_vacdh",
                          [JPolicyParams(omega=o) for o in omegas],
                          seeds=(0, 4))
    for ix in np.ndindex(*g.result.l2.total_latency.shape):
        _assert_vs_jax(g.point(*ix), _jgrid_point(jg, ix), str(ix))


def test_hier_multi_policy_grid_matches_simulate_hier_and_jax():
    jh, ph = _hier(n_shards=2, route="hash", hop_mean=0.002)
    names = ["lru", "vacdh", "stoch_vacdh"]
    g = sweep_hier_grid(ph, 2, 30.0, 90.0, names, [PolicyParams(omega=1.0)],
                        device="cpu")
    assert g.result.l2.total_latency.shape == (1, 3, 1, 1, 1, 1)
    _assert_points(g, ph, 2, names, [PolicyParams(omega=1.0)], [30.0],
                   [90.0], [0])
    jg = jsweep_hier_grid(jh, 2, 30.0, 90.0, names,
                          [JPolicyParams(omega=1.0)])
    for ix in np.ndindex(*g.result.l2.total_latency.shape):
        _assert_vs_jax(g.point(*ix), _jgrid_point(jg, ix), str(ix))


def test_hier_params_axis_with_params_sensitive_l2_stays_bitwise():
    _, ph = _hier(n_shards=2, key=1, hop_mean=0.003)
    params = [PolicyParams(omega=o) for o in (0.0, 2.0)]
    g = sweep_hier_grid(ph, 2, 25.0, 70.0, "stoch_vacdh", params,
                        l2_policy="stoch_vacdh", device="cpu")
    _assert_points(g, ph, 2, ["stoch_vacdh"], params, [25.0], [70.0], [0],
                   l2_policy="stoch_vacdh")


def test_hop_law_traces_share_one_engine_pair_bitwise():
    """Traces that differ only in their hops run in one engine pair; each
    trace's points equal its own grid and its simulate_hier calls."""
    pt = trace_from_arrays(*(np.asarray(x) for x in _jtrace()),
                           device="cpu")
    laws = [PolicyParams().dist, Erlang(k=4.0)]
    traces = [make_hier_trace(pt, 2, generator=torch.Generator()
                              .manual_seed(7), hop_mean=0.01, hop_dist=d,
                              route="random") for d in laws]
    assert not torch.equal(traces[0].hop_draw, traces[1].hop_draw)
    names = ["lru", "stoch_vacdh"]
    g = sweep_hier_grid(traces, 2, 30.0, [0.0, 90.0], names, device="cpu")
    for ti, tr in enumerate(traces):
        one = sweep_hier_grid(tr, 2, 30.0, [0.0, 90.0], names, device="cpu")
        for ix in np.ndindex(*one.result.l2.total_latency.shape[1:]):
            _assert_bitwise(g.point(ti, *ix), one.point(0, *ix), str(ix))
        _assert_points(g, tr, 2, names, [PolicyParams()], [30.0],
                       [0.0, 90.0], [0], ti=ti)


def test_grid_counters_count_points():
    _, ph = _hier()
    c = {}
    sweep_hier_grid(ph, 3, [20.0, 30.0], 90.0, ["lru", "stoch_vacdh"],
                    device="cpu", counters=c)
    assert c["requests"] == SPEC.n_requests
    assert c["lane_requests"] == 4 * SPEC.n_requests


# --- the key split -------------------------------------------------------------------
@pytest.mark.parametrize("n", [2, 3, 5, 9])
def test_prng_split_matches_jax(n):
    for seed in (0, 7, 2 ** 31 + 5):
        want = np.asarray(jax.random.key_data(
            jax.random.split(jax.random.key(seed), n)))
        got = np.array(prng.split(prng.key_data(seed), n), np.uint32)
        np.testing.assert_array_equal(got, want)
    assert prng.split((1, 2))[0] == prng.split((1, 2), n)[0]
