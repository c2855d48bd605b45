"""The port's event-driven oracle against the JAX package's, and the port's
engines against the port's oracle (tests/test_simulator.py's and
tests/test_streaming.py's refsim cases).

The oracle's arithmetic is the reference's (numpy f32 state, f64 event
times and latency sums); only the ranking runs through the port.  So on
the same inputs the port's oracle equals JAX's (counters exactly, latency
to rtol=1e-5), and the engines equal the oracle as the reference's do
(counters exactly, latency to the reference's rtol=2e-4)."""
import functools

import jax
import numpy as np
import pytest

from repro.core import refsim as jrefsim
from repro.core.distributions import Erlang as JErlang
from repro.core.hierarchy import make_hier_trace as jmake_hier_trace
from repro.data.traces import SyntheticSpec, synthetic_trace
from repro_torch.convert import hier_trace_from_arrays, trace_from_arrays
from repro_torch.core import refsim, simulate, simulate_stream
from repro_torch.core.trace import stream_of_trace

RTOL = 1e-5
COUNTERS = ("n_hits", "n_delayed", "n_misses", "n_evictions")
COIN_FREE = ["lru", "lfu", "lhd", "lac", "cala", "vacdh", "stoch_vacdh",
             "lru_mad", "lhd_mad", "lrb_lite"]


@functools.lru_cache(maxsize=None)
def _traces(seed=11, stochastic=True, n_requests=1500):
    spec = SyntheticSpec(n_objects=40, n_requests=n_requests, rate=300.0,
                         size_min=1.0, size_max=20.0, latency_base=0.01,
                         latency_per_mb=1e-3, stochastic=stochastic)
    jt = synthetic_trace(jax.random.key(seed), spec)
    return jt, trace_from_arrays(*(np.asarray(x) for x in jt), device="cpu")


def _same_dict(got: dict, want: dict, msg=""):
    for k in COUNTERS:
        assert got[k] == want[k], (msg, k)
    np.testing.assert_allclose(got["total_latency"], want["total_latency"],
                               rtol=RTOL, err_msg=msg)


@pytest.mark.parametrize("policy", COIN_FREE)
@pytest.mark.parametrize("stochastic", [False, True])
def test_oracle_matches_jax_oracle_and_engine(policy, stochastic):
    jt, pt = _traces(stochastic=stochastic)
    ref = refsim.simulate_ref(pt, 100.0, policy)
    _same_dict(ref, jrefsim.simulate_ref(jt, 100.0, policy), policy)
    got = simulate(pt, 100.0, policy, device="cpu")
    for k in COUNTERS:
        assert int(getattr(got, k)) == ref[k], (policy, k)
    np.testing.assert_allclose(float(got.total_latency),
                               ref["total_latency"], rtol=2e-4)


@pytest.mark.parametrize("policy", ["stoch_vacdh", "lru_mad", "cala"])
def test_oracle_with_estimator_matches_jax(policy):
    jt, pt = _traces(seed=3)
    _same_dict(refsim.simulate_ref(pt, 80.0, policy, estimate_z=True),
               jrefsim.simulate_ref(jt, 80.0, policy, estimate_z=True),
               policy)


def test_oracle_rejects_coin_policies():
    _, pt = _traces()
    with pytest.raises(NotImplementedError, match="coin-free"):
        refsim.simulate_ref(pt, 100.0, "adaptsize")


@pytest.mark.parametrize("rebase", [False, True])
def test_stream_oracle_matches_jax_and_whole(rebase):
    jt, pt = _traces(seed=5)
    times = np.asarray(jt.times, np.float64) + (1.7e9 if rebase else 0.0)
    objs, z_draw = np.asarray(jt.objs), np.asarray(jt.z_draw)

    def chunks():
        for lo in range(0, times.shape[0], 256):
            yield times[lo:lo + 256], objs[lo:lo + 256], z_draw[lo:lo + 256]

    args = (jt.n_objects, np.asarray(jt.sizes), np.asarray(jt.z_mean), 90.0,
            "stoch_vacdh")
    got = refsim.simulate_ref_stream(chunks(), *args, rebase=rebase)
    _same_dict(got, jrefsim.simulate_ref_stream(chunks(), *args,
                                                rebase=rebase))
    if not rebase:
        assert got == refsim.simulate_ref(pt, 90.0, "stoch_vacdh")


def test_rebased_stream_engine_matches_oracle():
    _, pt = _traces(seed=6)
    stream = stream_of_trace(pt)
    stream = stream._replace(times=stream.times + 1.7e9)
    got = simulate_stream(stream, 90.0, "stoch_vacdh", chunk_size=300,
                          rebase=True, device="cpu")
    times = np.asarray(stream.times, np.float64)
    chunks = ((times[lo:lo + 300], stream.objs[lo:lo + 300],
               stream.z_draw[lo:lo + 300])
              for lo in range(0, times.shape[0], 300))
    ref = refsim.simulate_ref_stream(chunks, stream.n_objects, stream.sizes,
                                     stream.z_mean, 90.0, "stoch_vacdh",
                                     rebase=True)
    for k in COUNTERS:
        assert int(getattr(got, k)) == ref[k], k
    np.testing.assert_allclose(float(got.total_latency),
                               ref["total_latency"], rtol=2e-4)


@pytest.mark.parametrize("route", ["hash", "random"])
@pytest.mark.parametrize("policy", ["lru", "stoch_vacdh", "lhd_mad"])
def test_hier_oracle_matches_jax_hier_oracle(route, policy):
    jt, _ = _traces(seed=2, n_requests=900)
    jh = jmake_hier_trace(jt, 3, key=jax.random.key(9), hop_mean=0.004,
                          hop_dist=JErlang(k=4), route=route)
    ph = hier_trace_from_arrays(*(np.asarray(x) for x in jh), device="cpu")
    got = refsim.simulate_hier_ref(ph, 3, 30.0, 90.0, policy)
    want = jrefsim.simulate_hier_ref(jh, 3, 30.0, 90.0, policy)
    _same_dict(got, want, "L1")
    _same_dict(got["l2"], want["l2"], "L2")
    for s in range(3):
        _same_dict(got["per_shard"][s], want["per_shard"][s], f"shard {s}")
