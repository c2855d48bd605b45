"""The port's fault layer against the JAX package's: the fault plan's
decision stream, backoff, timeouts and outages over grids of inputs, and
the serving engine under every fault configuration of
``tests/test_faults.py``, request by request."""
import math

import numpy as np
import pytest

from repro.core import percentile as jp
from repro.serving import engine as je
from repro.serving import faults as jf
from repro_torch.core import percentile as tp
from repro_torch.serving import engine as te
from repro_torch.serving import faults as tf


def test_splitmix64_and_u01_equal_reference():
    xs = [0, 1, 2, 0x9E3779B97F4A7C15, 2 ** 63, 2 ** 64 - 1, 12345678901]
    xs += np.random.default_rng(0).integers(0, 2 ** 63, 50).tolist()
    assert [tf.splitmix64(x) for x in xs] == [jf.splitmix64(x) for x in xs]
    for seed in (0, 7, 2 ** 40 + 3, -1):
        a, b = jf.FaultPlan(seed=seed), tf.FaultPlan(seed=seed)
        assert [b.u01(c) for c in range(300)] == \
            [a.u01(c) for c in range(300)]


def test_backoff_timeout_and_outage_equal_reference():
    kw = dict(backoff_base_s=0.013, backoff_cap_s=0.09,
              outages=((1, 2.0, 3.0), (0, 5.0, 6.0), (2, 0.0, 1e9)))
    a, b = jf.FaultPlan(**kw), tf.FaultPlan(**kw)
    us = [1e-12, 0.25, 0.5, 0.999999, 1.0 - 1e-12]
    for k in range(10):
        assert [b.backoff_s(k, u) for u in us] == \
            [a.backoff_s(k, u) for u in us]
    for q in (0.5, 0.9, 0.995, None):
        pa = jf.FaultPlan(timeout_quantile=q)
        pb = tf.FaultPlan(timeout_quantile=q)
        for m in (1e-4, 0.04, 1.0, 37.5):
            assert pb.timeout_s(m) == pa.timeout_s(m)
    for r in range(4):
        for t in (-1.0, 0.0, 1.999, 2.0, 2.5, 3.0, 4.9, 5.0, 5.5, 6.0, 1e9):
            assert b.in_outage(r, t) == a.in_outage(r, t)


@pytest.mark.parametrize("mod", [jf, tf], ids=["jax", "port"])
def test_validation_errors_equal_reference(mod):
    cases = (dict(fail_prob=1.0), dict(fail_prob=-0.1),
             dict(timeout_quantile=0.0), dict(timeout_quantile=1.0),
             dict(max_retries=-1), dict(outages=((0, 3.0, 2.0),)),
             dict(outages=((-1, 0.0, 2.0),)))
    for kw in cases:
        with pytest.raises(ValueError) as ej:
            jf.FaultPlan(**kw)
        with pytest.raises(ValueError) as et:
            mod.FaultPlan(**kw)
        assert str(et.value) == str(ej.value)
    for kw in (dict(max_waiters=0), dict(max_in_flight=0)):
        with pytest.raises(ValueError, match="degrade bounds"):
            mod.DegradePolicy(**kw)
    with pytest.raises(ValueError):
        te.ReplicaSet(())
    with pytest.raises(ValueError):
        te.ReplicaSet.uniform(3, te.LatencyModel(),
                              scale_fns=[lambda t: 1.0])


def test_replica_streams_equal_reference():
    a = je.ReplicaSet.uniform(3, je.LatencyModel(), seed=5)
    b = te.ReplicaSet.uniform(3, te.LatencyModel(), seed=5)
    for r in range(3):
        assert a.rng(r).standard_normal(6).tolist() == \
            b.rng(r).standard_normal(6).tolist()


# --- the engine under faults, request by request ---------------------------
def _lat(m, base=0.05):
    return m.LatencyModel(base_s=base, per_token_s=0.0)


def _engine(m, **kw):
    if m is te:
        kw["device"] = "cpu"
    return m.ServeEngine(**kw)


def _pair(m):
    return (jf if m is je else tf), (jp if m is je else tp)


def outage_routed_around(m):
    f, _ = _pair(m)
    eng = _engine(m, capacity=1.0, policy="lru", latency=_lat(m),
                  state_size_fn=lambda n: 1.0, hedging=False, seed=0,
                  replicas=m.ReplicaSet.uniform(2, _lat(m), seed=0),
                  faults=f.FaultPlan(outages=((0, 0.0, 1e9),)))
    return eng, [(0.5 * i, f"k{i}", 10) for i in range(40)]


def all_replicas_down(m):
    f, _ = _pair(m)
    eng = _engine(m, capacity=1.0, policy="lru", latency=_lat(m),
                  state_size_fn=lambda n: 1.0, hedging=True, seed=0,
                  replicas=m.ReplicaSet.uniform(2, _lat(m), seed=0),
                  faults=f.FaultPlan(outages=((0, 0.0, 1e9), (1, 0.0, 1e9)),
                                     max_retries=2))
    return eng, [(0.0, "k", 10), (5.0, "k", 10), (5.001, "k", 10)]


def waiters_on_failed_fetch(m):
    f, _ = _pair(m)
    eng = _engine(m, capacity=1.0, policy="lru", latency=_lat(m),
                  state_size_fn=lambda n: 1.0, hedging=False, seed=0,
                  replicas=m.ReplicaSet.uniform(1, _lat(m), seed=0),
                  faults=f.FaultPlan(outages=((0, 0.0, 1e9),),
                                     max_retries=1))
    return eng, [(0.0, "k", 10), (0.01, "k", 10), (9.0, "k", 10)]


def retry_budget_zero(m):
    f, _ = _pair(m)
    eng = _engine(m, capacity=1.0, policy="lru", latency=_lat(m),
                  state_size_fn=lambda n: 1.0, hedging=False, seed=0,
                  replicas=m.ReplicaSet.uniform(2, _lat(m), seed=0),
                  faults=f.FaultPlan(outages=((0, 0.0, 1e9),),
                                     retry_budget=0))
    return eng, [(1.0 * i, f"k{i}", 10) for i in range(10)]


def hedge_to_other_replica(m):
    f, _ = _pair(m)
    slow = [lambda t: 1000.0, lambda t: 1.0]
    eng = _engine(m, capacity=100.0, policy="lru", latency=_lat(m),
                  state_size_fn=lambda n: 1.0, hedging=True, seed=0,
                  replicas=m.ReplicaSet.uniform(2, _lat(m), scale_fns=slow,
                                                seed=0),
                  faults=f.FaultPlan(max_retries=0, timeout_quantile=None))
    return eng, [(100.0 * i, f"k{i}", 10) for i in range(20)]


def degrade_sheds(m):
    f, _ = _pair(m)
    eng = _engine(m, capacity=1.0, policy="lru",
                  latency=m.LatencyModel(base_s=100.0, per_token_s=0.0,
                                         stochastic=False),
                  state_size_fn=lambda n: 1.0, hedging=False, seed=0,
                  degrade=f.DegradePolicy(max_waiters=2, max_in_flight=2))
    reqs = [(0.0, "a", 10), (0.1, "a", 10), (0.2, "a", 10), (0.3, "a", 10),
            (0.4, "b", 10), (0.5, "c", 10), (300.0, "c", 10)]
    return eng, reqs


def legacy_unchanged(m):
    eng = _engine(m, capacity=10.0, policy="lru",
                  latency=m.LatencyModel(base_s=1.0, per_token_s=0.0,
                                         stochastic=False),
                  state_size_fn=lambda n: 1.0, hedging=False)
    return eng, [(0.0, "p", 8), (0.5, "p", 8), (2.0, "p", 8)]


def _trace(n=1200, seed=123):
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(0.01, n))
    keys = rng.zipf(1.3, n) % 60
    toks = rng.integers(8, 256, n)
    return [(float(t), f"p{k}", int(x)) for t, k, x in zip(times, keys, toks)]


def _fault_kw(m, policy):
    f, _ = _pair(m)
    scale_fns = [lambda t: 1.0,
                 lambda t: 4.0 if 8.0 <= t < 16.0 else 1.0,
                 lambda t: 1.0]
    return dict(
        replicas=m.ReplicaSet.uniform(3, _lat(m, 0.03), scale_fns=scale_fns,
                                      seed=9),
        faults=f.FaultPlan(seed=9, fail_prob=0.08, outages=((2, 4.0, 9.0),),
                           max_retries=2, retry_budget=200),
        degrade=f.DegradePolicy(max_waiters=1, max_in_flight=16))


def fault_run(m, policy="lru"):
    eng = _engine(m, capacity=25.0, policy=policy, latency=_lat(m, 0.03),
                  state_size_fn=lambda n: 1.0, hedging=True, seed=1,
                  **_fault_kw(m, policy))
    return eng, _trace(600)


def fault_run_stoch(m):
    return fault_run(m, "stoch_vacdh")


def fault_run_hier(m):
    l2 = _engine(m, capacity=40.0, policy="stoch_vacdh",
                 latency=_lat(m, 0.03), state_size_fn=lambda n: 1.0,
                 hedging=True, seed=1, **_fault_kw(m, "lru"))
    eng = _engine(m, capacity=15.0, policy="lru",
                  state_size_fn=lambda n: 1.0, hedging=True, seed=2, l2=l2,
                  hop_s=0.004)
    return eng, _trace(600)


def plan_seed_run(m, plan_seed):
    f, _ = _pair(m)
    eng = _engine(m, capacity=25.0, policy="lru", latency=_lat(m, 0.03),
                  state_size_fn=lambda n: 1.0, hedging=True, seed=1,
                  replicas=m.ReplicaSet.uniform(2, _lat(m, 0.03), seed=9),
                  faults=f.FaultPlan(seed=plan_seed, fail_prob=0.3,
                                     max_retries=1))
    return eng, _trace(300)


CONFIGS = {
    "outage_routed_around": outage_routed_around,
    "all_replicas_down": all_replicas_down,
    "waiters_on_failed_fetch": waiters_on_failed_fetch,
    "retry_budget_zero": retry_budget_zero,
    "hedge_to_other_replica": hedge_to_other_replica,
    "degrade_sheds": degrade_sheds,
    "legacy_unchanged": legacy_unchanged,
    "fault_run": fault_run,
    "fault_run_stoch_vacdh": fault_run_stoch,
    "fault_run_hier": fault_run_hier,
    "plan_seed_0": lambda m: plan_seed_run(m, 0),
    "plan_seed_1": lambda m: plan_seed_run(m, 1),
}


def _replay(m, make):
    eng, reqs = make(m)
    _, p = _pair(m)
    sq = p.StreamingQuantile(rel_err=0.005, min_value=1e-6, max_value=1e5)
    out = []
    for t, k, n in reqs:
        o, lat = eng.serve(t, k, n)
        out.append((o, lat))
        if o not in ("shed", "failed"):
            sq.add(lat)
    s = sq.summary()
    tiers = [eng] + ([eng.l2] if eng.l2 is not None else [])
    return (out, [e.stats.as_dict() for e in tiers],
            [(e._rr, e._fault_ctr, e._retry_tokens, sorted(e.pending))
             for e in tiers],
            (sq.counts.tobytes(), sq.count, sq.sum, s.p50, s.p99, s.p999))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_under_faults_equals_reference(name):
    a = _replay(je, CONFIGS[name])
    b = _replay(te, CONFIGS[name])
    for k, (x, y) in enumerate(zip(a[0], b[0])):
        assert x == y, f"request {k}: jax {x} != port {y}"
    assert a == b


def test_fault_configs_exercise_their_paths():
    """The port's runs reach what each configuration exists for."""
    out, st, _, _ = _replay(te, outage_routed_around)
    assert st[0]["fault_failures"] > 0 and st[0]["retries"] > 0
    assert "failed" not in [o for o, _ in out]
    out, st, _, _ = _replay(te, all_replicas_down)
    assert out[0][0] == "failed" and st[0]["gaveup"] >= 1
    _, st, _, _ = _replay(te, retry_budget_zero)
    assert st[0]["retries"] == 0 and st[0]["gaveup"] == 5
    out, _, _, _ = _replay(te, degrade_sheds)
    assert [o for o, _ in out].count("shed") == 2
    _, st, _, _ = _replay(te, fault_run)
    assert st[0]["hedges"] and st[0]["retries"] and st[0]["shed"]
    _, st, _, _ = _replay(te, fault_run_hier)
    assert st[1]["fault_failures"] > 0
    assert _replay(te, CONFIGS["plan_seed_0"])[1] != \
        _replay(te, CONFIGS["plan_seed_1"])[1]
    assert not math.isnan(_replay(te, fault_run_stoch)[3][3])
