"""The replay engine's point update (``kernels/point_update.py``) and its
host mirror, on the CPU.

* Digests of the engines' final state, pinned: each case fixes the total
  latency's bits, every counter, the commits and scoring commits, and a
  sha256 of the final ``[12, L, N]`` f32 and ``[2, L, N]`` bool state of
  every engine the run built.  The values were captured from the engine
  that computed each point update on the host (gather, numpy f32, one
  ``lane_scatter_batch``), so they hold the point-update kernels' plain
  versions and the mirror-driven engine to that engine bit for bit.
* ``point_serve_ref`` / ``point_commit_ref`` against the JAX package's
  ``_serve`` and ``_commit_one`` field updates on random points.
* The host mirror (``cached``, ``in_flight``, ``complete_t``) equals the
  state after every request, and a replay's read-backs are its scoring
  commits plus its per-eviction argmins."""
import hashlib
import json

import numpy as np
import pytest
import torch

from repro_torch.core import (PolicyParams, latency_improvement,
                              make_hier_trace, simulate, simulate_hier,
                              simulate_stream, stream_of_trace, sweep_grid)
from repro_torch.core import simulator
from repro_torch.data.traces import SyntheticSpec, synthetic_trace
from repro_torch.figures.common import POLICY_SET

SPEC = SyntheticSpec(n_objects=60, n_requests=2000, zipf_alpha=0.9,
                     rate=2000.0, latency_base=0.005, latency_per_mb=2e-4,
                     stochastic=True)


def _trace(seed=0, **kw):
    spec = SPEC if not kw else SyntheticSpec(**{**SPEC.__dict__, **kw})
    return synthetic_trace(torch.Generator().manual_seed(seed), spec,
                           device="cpu")


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.fixture
def states(monkeypatch):
    """The digest of every engine's final state, in the order the run
    asks for its results."""
    seen = []
    orig = simulator._Engine.result

    def result(self):
        out = orig(self)
        seen.append(_digest(self.st.values, self.st.flags))
        return out

    monkeypatch.setattr(simulator._Engine, "result", result)
    return seen


def _bits(x) -> list[int]:
    a = np.asarray(torch.as_tensor(x).numpy(), np.float32).ravel()
    return a.view(np.int32).tolist()


def _pin(res) -> dict:
    return {f: _bits(getattr(res, f)) for f in
            ("total_latency", "n_hits", "n_delayed", "n_misses",
             "n_evictions")}


def _fig2_grid(c):
    g = sweep_grid(_trace(), 500.0, POLICY_SET, PolicyParams(omega=1.0),
                   estimate_z=True, device="cpu", counters=c)
    return _pin(g.result)


def _improvement(c):
    tr = _trace(1)
    out = {}
    for pol in ("lru_mad", "lhd_mad", "stoch_vacdh"):
        out[pol] = _bits(latency_improvement(
            tr, 400.0, pol, "lru", PolicyParams(omega=1.0),
            estimate_z=True, device="cpu", counters=c))
    return out


def _evict_top0(c):
    return _pin(simulate(_trace(2), 300.0, "stoch_vacdh",
                         PolicyParams(omega=1.0), estimate_z=True,
                         evict_top=0, device="cpu", counters=c))


def _stream(c):
    tr = _trace(3)
    st = stream_of_trace(tr)
    st = st._replace(times=np.asarray(st.times, np.float64) + 1.7e9)
    return _pin(simulate_stream(st, 500.0, "stoch_vacdh",
                                PolicyParams(omega=1.0), estimate_z=True,
                                chunk_size=333, rebase=True, device="cpu",
                                counters=c))


def _slots(c):
    out = _pin(simulate(_trace(4), 300.0, "lhd_mad", estimate_z=True,
                        state_mode="slots", n_slots=40, device="cpu",
                        counters=c))
    assert c["reclaims"] > 0
    return out


def _hier(c):
    tr = _trace(5)
    ht = make_hier_trace(tr, 4, generator=torch.Generator().manual_seed(5),
                         hop_mean=0.002, route="hash")
    r = simulate_hier(ht, 4, 60.0, 400.0, "stoch_vacdh", "lru",
                      PolicyParams(omega=1.0), device="cpu", counters=c)
    return {"l1": _pin(r.per_shard), "l2": _pin(r.l2)}


CASES = {"fig2_grid": _fig2_grid, "improvement": _improvement,
         "evict_top0": _evict_top0, "stream": _stream, "slots": _slots,
         "hier": _hier}

# Captured from the host-arithmetic engine (see the module doc): the sha256
# prefix of each case's pinned results (json, sorted keys) and of every
# engine's final state, with its commits and scoring commits.
PINNED = {
    "fig2_grid": dict(results="be68fe2438ba95e3",
                      states=["ec524928d41dee59"],
                      commits=926, scoring_commits=819),
    "improvement": dict(results="ed62a4d33cc61ad7",
                        states=["68044b0dd07e4afc", "2c19e4b245b9568f",
                                "1542763796459e95"],
                        commits=2558, scoring_commits=2148),
    "evict_top0": dict(results="48de973fc73b6900",
                       states=["76ec0e95b913eeea"],
                       commits=775, scoring_commits=618),
    "stream": dict(results="bf5a03a496257044", states=["d41a4e8215ad3898"],
                   commits=594, scoring_commits=402),
    "slots": dict(results="930a45d4a329db96", states=["cc8b905fbaa20e8f"],
                  commits=796, scoring_commits=515),
    "hier": dict(results="b7d17f4ba7ff8a6c",
                 states=["a18c8a0a67d8911e", "8d9c0774f050dd16"],
                 commits=1471, scoring_commits=1115),
}


def _hash(pins: dict) -> str:
    return hashlib.sha256(json.dumps(pins, sort_keys=True).encode()
                          ).hexdigest()[:16]


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_is_bitwise_the_host_arithmetic_engine(case, states):
    c = {}
    pins = CASES[case](c)
    want = PINNED[case]
    assert _hash(pins) == want["results"], pins
    assert states == want["states"]
    assert (c["commits"], c["scoring_commits"]) == (
        want["commits"], want["scoring_commits"])
    # the only read-backs left: scoring commits and per-eviction argmins
    assert c["syncs"] == c["scoring_commits"] + c["argmins"]


# --- the plain versions against the JAX reference's field updates -----------
POINT_POLICIES = ["lru", "lru_mad", "lhd_mad", "stoch_vacdh"]


def _random_point_state(seed, n=6):
    """A random one-lane state over ``n`` objects (numpy), with inf
    ``complete_t``, counts 0, 1 and more, and empty episode statistics."""
    from repro_torch.figures.bench_kernels import point_state
    values, flags = point_state(1, n, seed, "cpu")
    return values[:, 0].numpy().copy(), flags[:, 0].numpy().copy()


def _jax_state(values, flags, gd_clock, free=1e9):
    import jax
    import jax.numpy as jnp
    from repro.core.state import ObjStats, SimState
    f32 = lambda x: jnp.asarray(np.float32(x))
    obj = ObjStats(cached=jnp.asarray(flags[0]),
                   in_flight=jnp.asarray(flags[1]),
                   **{name: jnp.asarray(values[k]) for k, name in
                      enumerate(ObjStats._fields[2:])})
    return SimState(obj=obj, free=f32(free), gd_clock=f32(gd_clock),
                    min_complete=f32(np.inf), key=jax.random.key(0),
                    lat_sum=f32(0), lat_comp=f32(0), n_hits=f32(0),
                    n_delayed=f32(0), n_misses=f32(0), n_evictions=f32(0))


def _jax_fields(state):
    o = state.obj
    return (np.stack([np.asarray(getattr(o, f)) for f in o._fields[2:]]),
            np.stack([np.asarray(o.cached), np.asarray(o.in_flight)]))


def _lane(policy, params):
    from repro_torch.core.ranking import EPS, POLICIES
    q = POLICIES[policy]
    t = lambda x, dt: torch.tensor([x], dtype=dt)
    return (t(q.greedydual, torch.bool),
            t(q.gd_cost == "agg_rate", torch.bool),
            t(np.float32(params.cold_rate), torch.float32),
            t(np.float32(params.gap_alpha), torch.float32),
            float(np.float32(EPS)))


@pytest.mark.parametrize("policy", POINT_POLICIES)
@pytest.mark.parametrize("seed", range(4))
def test_point_serve_ref_matches_jax_serve(policy, seed):
    from repro.core import ranking as jranking
    from repro.core.simulator import _behavior_static, _serve
    from repro_torch.kernels.ref import point_serve_ref
    rng = np.random.default_rng(seed)
    values, flags = _random_point_state(seed)
    sizes = rng.uniform(1.0, 50.0, values.shape[1]).astype(np.float32)
    p = PolicyParams(omega=1.0)
    jp = jranking.PolicyParams(omega=1.0)
    clock = np.float32(rng.uniform(0.0, 3.0))
    for i in range(values.shape[1]):
        t = np.float32(rng.uniform(20.0, 60.0))
        z = np.float32(rng.uniform(1e-3, 0.05))
        js, jlat = _serve(_behavior_static(jranking.POLICIES[policy], jp,
                                           "rank"), jp,
                          _jax_state(values, flags, clock), sizes, t, i, z)
        want_v, want_b = _jax_fields(js)
        v = torch.from_numpy(values.copy())[:, None]
        b = torch.from_numpy(flags.copy())[:, None]
        point_serve_ref(v, b, torch.tensor([i]), torch.tensor(t),
                        torch.tensor([z]), torch.tensor([sizes[i]]),
                        torch.tensor([clock]), _lane(policy, p))
        np.testing.assert_array_equal(v[:, 0].numpy().view(np.int32),
                                      want_v.view(np.int32))
        np.testing.assert_array_equal(b[:, 0].numpy(), want_b)


@pytest.mark.parametrize("policy", POINT_POLICIES)
@pytest.mark.parametrize("estimate_z", [False, True])
def test_point_commit_ref_matches_jax_commit(policy, estimate_z):
    """The commit's field updates: the committing object is the one in
    flight; the cache has room, so JAX admits it (``cached`` is the
    engine's admission write, not the point update's)."""
    from repro.core import ranking as jranking
    import jax.numpy as jnp
    from repro.core.simulator import _behavior_static, _commit_one
    from repro_torch.kernels.ref import point_commit_ref
    rng = np.random.default_rng(7)
    p = PolicyParams(omega=1.0)
    jp = jranking.PolicyParams(omega=1.0)
    for seed in range(4):
        values, flags = _random_point_state(seed)
        n = values.shape[1]
        sizes = rng.uniform(1.0, 50.0, n).astype(np.float32)
        j = int(rng.integers(0, n))
        flags[1] = False
        flags[1, j] = True
        values[0, j] = np.float32(rng.uniform(30.0, 40.0))
        clock = np.float32(rng.uniform(0.0, 3.0))
        js = _commit_one(_behavior_static(jranking.POLICIES[policy], jp,
                                          "rank"), jp, estimate_z,
                         _jax_state(values, flags, clock),
                         jnp.asarray(sizes))
        want_v, want_b = _jax_fields(js)
        v = torch.from_numpy(values.copy())[:, None]
        b = torch.from_numpy(flags.copy())[:, None]
        point_commit_ref(v, b, torch.tensor([j]), torch.tensor([True]),
                         torch.tensor([sizes[j]]), torch.tensor([clock]),
                         _lane(policy, p), estimate_z)
        np.testing.assert_array_equal(v[:, 0].numpy().view(np.int32),
                                      want_v.view(np.int32))
        np.testing.assert_array_equal(b[1, 0].numpy(), want_b[1])
        want_b[0, j] = flags[0, j]
        np.testing.assert_array_equal(b[0, 0].numpy(), want_b[0])


def test_point_update_wrapper_splits_lanes_and_masks():
    """More lanes than one parameter block holds, masked lanes and lanes
    not due: the CPU route equals one plain call per lane."""
    from repro_torch.core.ranking import EPS
    from repro_torch.figures.bench_kernels import point_lanes, point_state
    from repro_torch.kernels import point_update as pu
    lanes, n = pu.MAX_LANES + 3, 16
    values, flags = point_state(lanes, n, 3, "cpu")
    lane = point_lanes(lanes, 3)
    rng = np.random.default_rng(3)
    idx = rng.integers(0, n, lanes)
    active = rng.random(lanes) < 0.7
    due = rng.random(lanes) < 0.5
    z = rng.uniform(1e-3, 0.05, lanes).astype(np.float32)
    size = rng.uniform(1.0, 9.0, lanes).astype(np.float32)
    clock = rng.uniform(0.0, 2.0, lanes).astype(np.float32)
    t = np.float32([45.0])
    want_v, want_b = values.clone(), flags.clone()
    for li in range(lanes):
        one = pu.PointUpdate(want_v[:, li:li + 1], want_b[:, li:li + 1],
                             *(x[li:li + 1] for x in lane), EPS, True)
        one.serve(idx[li:li + 1], t, z[li:li + 1], size[li:li + 1],
                  clock[li:li + 1], active[li:li + 1])
        one.commit(idx[li:li + 1], due[li:li + 1], size[li:li + 1],
                   clock[li:li + 1])
        one.flush()
    pu_all = pu.PointUpdate(values, flags, *lane, EPS, True)
    pu_all.serve(idx, t, z, size, clock, active)
    pu_all.commit(idx, due, size, clock)
    pu_all.flush()
    np.testing.assert_array_equal(values.numpy().view(np.int32),
                                  want_v.numpy().view(np.int32))
    np.testing.assert_array_equal(flags.numpy(), want_b.numpy())


# --- the host mirror -------------------------------------------------------
@pytest.mark.parametrize("case", ["grid", "stream", "slots", "hier"])
def test_mirror_equals_the_state_after_every_request(case, monkeypatch):
    serve = simulator._Engine._serve
    checked = []

    def checking(self, *a, **k):
        lat = serve(self, *a, **k)
        self._point.flush()
        np.testing.assert_array_equal(self.m_bits, self.st.flags.numpy())
        np.testing.assert_array_equal(
            self.m_ct.view(np.int32),
            self.st.values[0].numpy().view(np.int32))
        checked.append(1)
        return lat

    monkeypatch.setattr(simulator._Engine, "_serve", checking)
    tr = _trace(9, n_requests=300, n_objects=25)
    c = {}
    if case == "grid":
        sweep_grid(tr, [60.0, 150.0], ["lru", "lhd_mad", "stoch_vacdh"],
                   PolicyParams(omega=1.0), estimate_z=True, device="cpu")
    elif case == "stream":
        st = stream_of_trace(tr)
        st = st._replace(times=np.asarray(st.times, np.float64) + 1.7e9)
        simulate_stream(st, 80.0, "lru_mad", estimate_z=True, chunk_size=37,
                        device="cpu")
    elif case == "slots":
        simulate(tr, 80.0, "stoch_vacdh", estimate_z=True,
                 state_mode="slots", n_slots=16, device="cpu", counters=c)
        assert c["reclaims"] > 0
    else:
        ht = make_hier_trace(tr, 3, generator=torch.Generator()
                             .manual_seed(1), hop_mean=0.003, route="random")
        simulate_hier(ht, 3, 30.0, 90.0, "stoch_vacdh", "lru",
                      device="cpu")
    assert len(checked) >= tr.n_requests
