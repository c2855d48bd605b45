"""The port's slot-table state against the JAX package's (tests/test_slots.py's
cases) and against its own dense state.

* slot mode equals JAX's slot mode on the same trace for every policy
  (counters exactly, latency to rtol=1e-5), and the port's dense
  ``evict_top=0`` replay bit for bit whenever the table never fills: whole,
  chunked, rebased, under any hash seed and in a collision storm;
* the reclaim path (a table smaller than the touched keys) equals JAX's
  reclaim path on the same trace, not only itself;
* the table primitives (hash, home slot, probe, sizing, fresh state) equal
  the reference's bit for bit, with the reference's guards."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import simulate as jsimulate
from repro.core import simulate_stream as jsimulate_stream
from repro.core import state as jstate
from repro.core.trace import stream_of_trace as jstream_of_trace
from repro.data.traces import SyntheticSpec, synthetic_trace
from repro.kernels.ref import tiebreak_argmin_ref as jtiebreak
from repro_torch.convert import trace_from_arrays
from repro_torch.core import (POLICIES, PolicyParams, simulate,
                              simulate_chunked, simulate_stream,
                              stream_of_trace, sweep_grid)
from repro_torch.core import state as pstate
from repro_torch.kernels.ref import tiebreak_argmin_ref

RTOL = 1e-5
FIELDS = ("total_latency", "n_hits", "n_delayed", "n_misses", "n_evictions")
ALL_POLICIES = sorted(POLICIES)

SPEC = SyntheticSpec(n_objects=24, n_requests=500, rate=300.0,
                     size_min=1.0, size_max=20.0,
                     latency_base=0.01, latency_per_mb=1e-3,
                     stochastic=True)


@functools.lru_cache(maxsize=None)
def _traces(seed=0):
    """(JAX trace, the port's CPU trace) on the same arrays."""
    jt = synthetic_trace(jax.random.key(seed), SPEC)
    return jt, trace_from_arrays(*(np.asarray(x) for x in jt), device="cpu")


def _assert_same(a, b, msg=""):
    for f in FIELDS:
        assert float(getattr(a, f)) == float(getattr(b, f)), (msg, f)


def _assert_vs_jax(got, want, msg=""):
    for f in FIELDS[1:]:
        assert int(getattr(got, f)) == int(getattr(want, f)), (msg, f)
    np.testing.assert_allclose(float(got.total_latency),
                               float(want.total_latency), rtol=RTOL,
                               err_msg=msg)


# --- parity with JAX's slot mode and with the port's dense mode --------------
@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_slot_mode_matches_jax_and_dense_full_roster(policy):
    """Every policy, estimate_z on.  The dense oracle runs evict_top=0, the
    path the slot engine pins (itself bitwise invisible in dense)."""
    jt, pt = _traces()
    dense = simulate(pt, 60.0, policy, estimate_z=True, evict_top=0,
                     device="cpu")
    slots = simulate(pt, 60.0, policy, estimate_z=True, state_mode="slots",
                     device="cpu")
    _assert_same(dense, slots, policy)
    _assert_vs_jax(slots, jsimulate(jt, 60.0, policy, estimate_z=True,
                                    state_mode="slots"), policy)
    assert int(slots.n_evictions) > 0          # the eviction path ran


def test_slot_mode_parity_without_estimator():
    jt, pt = _traces(1)
    dense = simulate(pt, 60.0, "stoch_vacdh", evict_top=0, device="cpu")
    slots = simulate(pt, 60.0, "stoch_vacdh", state_mode="slots",
                     device="cpu")
    _assert_same(dense, slots)
    _assert_vs_jax(slots, jsimulate(jt, 60.0, "stoch_vacdh",
                                    state_mode="slots"))


@pytest.mark.parametrize("chunk_size", [7, 97, 500])
def test_slot_chunked_carry_parity(chunk_size):
    jt, pt = _traces(2)
    dense = simulate(pt, 60.0, "stoch_vacdh", estimate_z=True, evict_top=0,
                     device="cpu")
    got = simulate_chunked(pt, 60.0, "stoch_vacdh", estimate_z=True,
                           state_mode="slots", chunk_size=chunk_size,
                           device="cpu")
    _assert_same(dense, got, f"chunk={chunk_size}")


def test_slot_streamed_rebase_parity_with_dense_stream_and_jax():
    """Under rebase the chunk boundaries set the f32 offsets, so the oracle
    is the dense streamed run with the same chunking."""
    jt, pt = _traces(3)
    stream = stream_of_trace(pt)
    kw = dict(estimate_z=True, chunk_size=101, rebase=True)
    dense = simulate_stream(stream, 60.0, "stoch_vacdh", evict_top=0,
                            device="cpu", **kw)
    slots = simulate_stream(stream, 60.0, "stoch_vacdh", state_mode="slots",
                            device="cpu", **kw)
    _assert_same(dense, slots)
    want = jsimulate_stream(jstream_of_trace(jt), 60.0, "stoch_vacdh",
                            state_mode="slots", **kw)
    _assert_vs_jax(slots, want)


@pytest.mark.parametrize("seed", [7, 123])
def test_slot_seed_is_bitwise_invisible(seed):
    _, pt = _traces(4)
    base = simulate(pt, 60.0, "stoch_vacdh", estimate_z=True,
                    state_mode="slots", slot_seed=0, device="cpu")
    got = simulate(pt, 60.0, "stoch_vacdh", estimate_z=True,
                   state_mode="slots", slot_seed=seed, device="cpu")
    _assert_same(base, got, f"slot_seed={seed}")


def test_collision_storm_parity():
    """32 slots for 24 keys: long probe runs and wrapped clusters, but the
    table never fills."""
    jt, pt = _traces(5)
    dense = simulate(pt, 60.0, "lru_mad", estimate_z=True, evict_top=0,
                     device="cpu")
    got = simulate(pt, 60.0, "lru_mad", estimate_z=True, state_mode="slots",
                   n_slots=32, device="cpu")
    _assert_same(dense, got)
    _assert_vs_jax(got, jsimulate(jt, 60.0, "lru_mad", estimate_z=True,
                                  state_mode="slots", n_slots=32))


@pytest.mark.parametrize("policy", ["stoch_vacdh", "lru", "lru_mad",
                                    "adaptsize"])
def test_table_full_reclaim_matches_jax(policy):
    """16 slots for 24 keys: reclaim fires (cached occupants evicted,
    in-flight fetches dropped from the heap).  The port's reclaim path
    equals JAX's on the same trace, and its counters add up."""
    jt, pt = _traces(6)
    c = {}
    got = simulate(pt, 60.0, policy, estimate_z=True, state_mode="slots",
                   n_slots=16, device="cpu", counters=c)
    assert c["reclaims"] > 0
    _assert_vs_jax(got, jsimulate(jt, 60.0, policy, estimate_z=True,
                                  state_mode="slots", n_slots=16), policy)
    n = int(got.n_hits) + int(got.n_delayed) + int(got.n_misses)
    assert n == SPEC.n_requests
    assert np.isfinite(float(got.total_latency))
    assert float(got.total_latency) > 0.0


def test_reclaim_drops_in_flight_fetches_like_jax():
    """A table of 4 slots under a fast request rate: every slot is often in
    flight, so reclaim takes the home slot and drops its fetch."""
    jt, pt = _traces(7)
    c = {}
    got = simulate(pt, 30.0, "stoch_vacdh", estimate_z=True,
                   state_mode="slots", n_slots=4, device="cpu", counters=c)
    assert c["reclaims"] > 0
    _assert_vs_jax(got, jsimulate(jt, 30.0, "stoch_vacdh", estimate_z=True,
                                  state_mode="slots", n_slots=4))


def test_first_touch_costs_no_read_back():
    """A first touch writes its slot in the serve's own launch and reads
    nothing back: the slot replay makes exactly the dense replay's
    read-backs, its scoring commits and per-eviction argmins."""
    _, pt = _traces()
    cd, cs = {}, {}
    simulate(pt, 60.0, "lru", evict_top=0, device="cpu", counters=cd)
    simulate(pt, 60.0, "lru", state_mode="slots", device="cpu", counters=cs)
    assert cd["syncs"] == cs["syncs"] == (cs["scoring_commits"]
                                          + cs["argmins"]) > 0


# --- table primitives ---------------------------------------------------------
def test_hash_and_home_slot_match_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(-2 ** 31, 2 ** 31, 500).astype(np.int32)
    for seed in (0, 1, 7, 123456789, 2 ** 32 - 1):
        want = np.asarray(jstate._hash_u32(jnp.asarray(ids),
                                           jnp.uint32(seed)))
        got = pstate._hash_u32(ids, seed)
        np.testing.assert_array_equal(got, want)
        assert [int(pstate._hash_u32(x, seed)) for x in ids[:50]] == \
            [int(w) for w in want[:50]]
        for n in (8, 64, 1000, 1 << 19):
            np.testing.assert_array_equal(
                pstate.slot_home(ids, seed, n),
                np.asarray(jstate.slot_home(jnp.asarray(ids),
                                            jnp.uint32(seed), n)))


def test_slot_probe_found_empty_full():
    n = 8
    empty = np.full(n, pstate.SLOT_EMPTY, np.int32)
    h = int(pstate.slot_home(5, 0, n))
    assert pstate.slot_probe(empty, 5, 0) == (h, False, True)
    tab = empty.copy()
    tab[h] = 5
    assert pstate.slot_probe(tab, 5, 0) == (h, True, False)
    tab = empty.copy()
    tab[h], tab[(h + 1) % n] = 99, 5
    s, found, _ = pstate.slot_probe(tab, 5, 0)
    assert (s, found) == ((h + 1) % n, True)
    full = np.arange(100, 100 + n, dtype=np.int32)
    _, found, has_space = pstate.slot_probe(full, 5, 0)
    assert (found, has_space) == (False, False)


@pytest.mark.parametrize("seed", [0, 3])
def test_slot_probe_matches_jax_on_random_tables(seed):
    rng = np.random.default_rng(seed)
    n = 16
    for _ in range(20):
        tab = np.full(n, pstate.SLOT_EMPTY, np.int32)
        fill = rng.choice(n, rng.integers(0, n + 1), replace=False)
        tab[fill] = rng.integers(0, 40, fill.size)
        obj = int(rng.integers(0, 40))
        s, found, empty = jstate.slot_probe(jnp.asarray(tab), obj,
                                            jnp.uint32(seed))
        assert pstate.slot_probe(tab, obj, seed) == (int(s), bool(found),
                                                     bool(empty))


def test_slot_table_size_contract():
    assert pstate.slot_table_size(0) == 64
    assert pstate.slot_table_size(32) == 64
    assert pstate.slot_table_size(33) == 128
    assert pstate.slot_table_size(200_000) == 524_288
    assert pstate.slot_table_size(200_000, load=0.75) == 1 << 19
    assert pstate.slot_table_size(96, load=0.75) == 128
    for n in (0, 1, 63, 64, 65, 1000, 123_457):
        for load in (0.25, 0.5, 0.75, 1.0):
            assert pstate.slot_table_size(n, load) == \
                jstate.slot_table_size(n, load)
    with pytest.raises(ValueError, match="n_distinct"):
        pstate.slot_table_size(-1)
    with pytest.raises(ValueError, match="load"):
        pstate.slot_table_size(10, load=0.0)


def test_init_slot_state_validates():
    with pytest.raises(ValueError, match="n_slots"):
        pstate.init_slot_state(0, 10.0, device="cpu")
    st = pstate.init_slot_state(64, 10.0, seed=5, device="cpu")
    assert st.tab.key_tab.shape == (64,)
    assert bool((st.tab.key_tab == pstate.SLOT_EMPTY).all())
    assert float(st.tab.sizes.abs().sum()) == 0.0
    assert st.sim.values.shape[1:] == (1, 64)
    assert float(st.sim.free[0]) == 10.0 and st.tab.seed == 5


def test_tiebreak_argmin_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(50):
        n = int(rng.integers(1, 40))
        vals = rng.choice([0.5, 1.0, 2.0, np.inf], n).astype(np.float32)
        ids = rng.permutation(1000)[:n].astype(np.int32)
        want = int(jtiebreak(jnp.asarray(vals), jnp.asarray(ids)))
        got = int(tiebreak_argmin_ref(torch.from_numpy(vals),
                                      torch.from_numpy(ids)))
        assert got == want
    # the identity map is torch.argmin
    v = torch.tensor([3.0, 1.0, 1.0, 2.0])
    assert int(tiebreak_argmin_ref(v, torch.arange(4, dtype=torch.int32))) \
        == int(torch.argmin(v))


# --- guards -------------------------------------------------------------------
def test_slot_mode_guards():
    _, pt = _traces()
    with pytest.raises(ValueError, match="evict_top"):
        simulate(pt, 60.0, "lru", state_mode="slots", evict_top=4,
                 device="cpu")
    with pytest.raises(ValueError, match="n_slots"):
        simulate(pt, 60.0, "lru", n_slots=64, device="cpu")
    with pytest.raises(ValueError, match="n_slots"):
        simulate_stream(stream_of_trace(pt), 60.0, "lru", n_slots=64,
                        device="cpu")
    with pytest.raises(ValueError, match="state_mode"):
        simulate(pt, 60.0, "lru", state_mode="sparse", device="cpu")
    with pytest.raises(ValueError, match="n_slots"):
        simulate(pt, 60.0, "lru", state_mode="slots", n_slots=0,
                 device="cpu")


def test_sweep_grid_rejects_slot_mode():
    _, pt = _traces()
    with pytest.raises(ValueError, match="slots"):
        sweep_grid(pt, 60.0, ["lru", "stoch_vacdh"], [PolicyParams()],
                   state_mode="slots", device="cpu")
    with pytest.raises(ValueError, match="state_mode"):
        sweep_grid(pt, 60.0, ["lru", "stoch_vacdh"], [PolicyParams()],
                   state_mode="bogus", device="cpu")
