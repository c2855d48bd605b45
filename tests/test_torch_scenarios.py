"""The port's serving-workload scenarios against the JAX package's, bit for
bit: every array, the outage windows, and the values of the
``latency_scale``, ``rate_fn`` and ``replica_scales`` callables."""
import numpy as np
import pytest

from repro.data import scenarios as js
from repro_torch.data import scenarios as ts

NAMES = sorted(ts.SCENARIOS)


def test_same_registry():
    assert sorted(js.SCENARIOS) == NAMES
    for name in NAMES:
        jf = [(f.name, f.default) for f in
              js.SCENARIOS[name].__dataclass_fields__.values()]
        tf = [(f.name, f.default) for f in
              ts.SCENARIOS[name].__dataclass_fields__.values()]
        assert jf == tf


def _bits(x):
    return (x.dtype.str, x.shape, np.ascontiguousarray(x).tobytes())


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("name", NAMES)
def test_scenario_equals_reference(name, seed):
    a = js.make_scenario(name, seed=seed)
    b = ts.make_scenario(name, seed=seed)
    for f in ("times", "keys", "n_tokens", "burst_mask"):
        assert _bits(getattr(a, f)) == _bits(getattr(b, f)), f
    assert (a.name, a.n_replicas, a.outages) == (b.name, b.n_replicas,
                                                 b.outages)
    assert (a.n_requests, a.duration) == (b.n_requests, b.duration)
    assert len(a.replica_scales) == len(b.replica_scales)
    # 64 times over the horizon, window edges among them
    ts_ = np.random.default_rng(seed).uniform(-1.0, 1.1 * b.duration, 56)
    edges = [t for _, t0, t1 in b.outages for t in (t0, t1)]
    eps = getattr(b.spec, "episodes", ())
    edges += [f * b.duration for s, d in eps for f in (s, s + d)]
    pts = list(ts_) + edges[:8] + [0.0] * (8 - len(edges[:8]))
    for t in pts:
        assert a.latency_scale(t) == b.latency_scale(t)
        assert a.rate_fn(t) == b.rate_fn(t)
        for fa, fb in zip(a.replica_scales, b.replica_scales):
            assert fa(t) == fb(t)


@pytest.mark.parametrize("name,kw", [
    ("diurnal", dict(amplitude=0.0, n_requests=500)),
    ("flash_crowd", dict(burst_fraction=0.0, n_requests=500)),
    ("flash_crowd", dict(n_bursts=5, hot_per_burst=2, n_requests=900)),
    ("zipf_drift", dict(n_blocks=3, n_requests=7)),
    ("brownout", dict(severity=9.0, episodes=((0.1, 0.5),))),
    ("origin_outage", dict(n_outages=3, outage_frac=0.25)),
    ("degraded_replica", dict(n_replicas=5, n_keys=50)),
])
def test_overrides_equal_reference(name, kw):
    a = js.make_scenario(name, seed=3, **kw)
    b = ts.make_scenario(name, seed=3, **kw)
    for f in ("times", "keys", "n_tokens", "burst_mask"):
        assert _bits(getattr(a, f)) == _bits(getattr(b, f)), f
    assert a.outages == b.outages


@pytest.mark.parametrize("mod", [js, ts], ids=["jax", "port"])
def test_same_errors(mod):
    with pytest.raises(KeyError):
        mod.make_scenario("nope")
    for spec, kw in (("DiurnalSpec", dict(amplitude=1.5)),
                     ("FlashCrowdSpec", dict(burst_fraction=1.0)),
                     ("BrownoutSpec", dict(severity=0.0)),
                     ("OutageSpec", dict(n_replicas=1)),
                     ("OutageSpec", dict(n_outages=8, outage_frac=0.2)),
                     ("DegradedReplicaSpec", dict(n_replicas=1)),
                     ("DegradedReplicaSpec", dict(severity=-1.0))):
        with pytest.raises(ValueError) as ej:
            getattr(js, spec)(**kw).generate()
        with pytest.raises(ValueError) as et:
            getattr(mod, spec)(**kw).generate()
        assert str(ej.value) == str(et.value)
