"""The seven hypothesis properties of tests/test_properties.py on the port's
functions, on the CPU, with the reference's settings and example counts.

Inputs are drawn with numpy from a drawn seed.  Where the JAX function is
cheap to call on the same inputs (the moment formulas, Kahan's sum,
attention and GLA), each example is also held against it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import delay_stats as jds  # noqa: E402
from repro.core.state import kahan_add as jkahan_add  # noqa: E402
from repro.models.attention import sdpa as jsdpa  # noqa: E402
from repro.models.ssm import chunked_gla as jchunked_gla  # noqa: E402
from repro_torch.core import delay_stats as ds  # noqa: E402
from repro_torch.core import make_trace, simulate  # noqa: E402
from repro_torch.core.state import kahan_add  # noqa: E402
from repro_torch.models.attention import sdpa  # noqa: E402
from repro_torch.models.ssm import chunked_gla  # noqa: E402

_settings = dict(deadline=None, max_examples=25)


@given(lam=st.floats(0.0, 50.0), z=st.floats(1e-3, 5.0))
@settings(**_settings)
def test_theorem2_moments_positive_and_dominate_theorem1(lam, z):
    m1, v1 = float(ds.det_mean(lam, z)), float(ds.det_var(lam, z))
    m2, v2 = float(ds.stoch_mean(lam, z)), float(ds.stoch_var(lam, z))
    assert m2 >= m1 >= z * (1 - 1e-6)
    assert v2 >= v1 >= 0.0
    # Var under Exp latency is at least the latency's own variance z^2
    assert v2 >= z * z * (1 - 1e-6)
    for got, fn in ((m1, jds.det_mean), (v1, jds.det_var),
                    (m2, jds.stoch_mean), (v2, jds.stoch_var)):
        assert got == pytest.approx(float(fn(lam, z)), rel=1e-6, abs=0.0)


@given(lam=st.floats(1e-3, 20.0), z=st.floats(1e-3, 2.0),
       scale=st.floats(1.1, 4.0))
@settings(**_settings)
def test_ranking_monotone_in_latency(lam, z, scale):
    """The eq.-16 numerator increases with the mean latency (keep
    slower-to-fetch objects, all else equal)."""
    f1 = float(ds.stoch_mean(lam, z) + ds.stoch_std(lam, z))
    f2 = float(ds.stoch_mean(lam, z * scale)
               + ds.stoch_std(lam, z * scale))
    assert f2 > f1
    want = float(jds.stoch_mean(lam, z) + jds.stoch_std(lam, z))
    assert f1 == pytest.approx(want, rel=1e-6, abs=0.0)


@st.composite
def small_trace(draw):
    n_obj = draw(st.integers(2, 12))
    n_req = draw(st.integers(20, 120))
    seed = draw(st.integers(0, 2**16))
    stochastic = draw(st.booleans())
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(size=n_req) * 0.01)
    objs = rng.integers(0, n_obj, n_req)
    sizes = rng.uniform(1.0, 5.0, n_obj)
    z_mean = np.full(n_obj, 0.05)
    return make_trace(times, objs, sizes, z_mean,
                      generator=torch.Generator().manual_seed(seed),
                      stochastic=stochastic, device="cpu"), n_obj


@given(tr=small_trace(),
       policy=st.sampled_from(["lru", "lfu", "lhd", "lac", "vacdh",
                               "stoch_vacdh", "lru_mad"]),
       cap=st.floats(2.0, 30.0))
@settings(deadline=None, max_examples=20)
def test_simulator_conservation_invariants(tr, policy, cap):
    trace, _ = tr
    r = simulate(trace, cap, policy, device="cpu")
    n = trace.times.shape[0]
    # every request is exactly one of hit/delayed/miss
    assert int(r.n_hits) + int(r.n_delayed) + int(r.n_misses) == n
    # latency is bounded by n * max realized fetch time
    zmax = float(trace.z_draw.max())
    assert 0.0 <= float(r.total_latency) <= n * zmax + 1e-3
    # evictions can never exceed admissions (<= misses)
    assert int(r.n_evictions) <= int(r.n_misses)


@given(tr=small_trace())
@settings(deadline=None, max_examples=15)
def test_bigger_cache_never_hurts_hit_count_much(tr):
    """LRU's hit count is (weakly) monotone in capacity on one trace."""
    trace, _ = tr
    small = simulate(trace, 3.0, "lru", device="cpu")
    big = simulate(trace, 1e6, "lru", device="cpu")
    assert int(big.n_hits) >= int(small.n_hits)
    assert float(big.total_latency) <= float(small.total_latency) + 1e-3


@given(seed=st.integers(0, 2**16), b=st.integers(1, 3),
       s=st.sampled_from([16, 48]))
@settings(deadline=None, max_examples=10)
def test_attention_causality(seed, b, s):
    """Perturbing future tokens must not change past outputs."""
    rng = np.random.default_rng(seed)
    h, dh = 2, 16
    q, k, v = (rng.standard_normal((b, s, h, dh)).astype(np.float32)
               for _ in range(3))
    pos = np.arange(s, dtype=np.int32)
    t = torch.from_numpy
    out1 = sdpa(t(q), t(k), t(v), t(pos), t(pos))
    cut = s // 2
    k2, v2 = k.copy(), v.copy()
    k2[:, cut:] += rng.standard_normal((b, s - cut, h, dh)).astype(
        np.float32)
    v2[:, cut:] += 1.0
    out2 = sdpa(t(q), t(k2), t(v2), t(pos), t(pos))
    np.testing.assert_allclose(out1[:, :cut].numpy(), out2[:, :cut].numpy(),
                               atol=1e-5)
    want = jsdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 jnp.asarray(pos), jnp.asarray(pos))
    np.testing.assert_allclose(out1.numpy(), np.asarray(want), atol=1e-5)


@given(seed=st.integers(0, 2**16))
@settings(deadline=None, max_examples=10)
def test_gla_state_consistency_split_vs_full(seed):
    """Chunked GLA over [0:S] == [0:S/2] then [S/2:S] with the carried
    state (the prefill-then-continue invariant)."""
    rng = np.random.default_rng(seed)
    b, s, h, d = 1, 64, 2, 8
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = (rng.standard_normal((b, s, h, d)) * 0.3).astype(np.float32)
    v = rng.standard_normal((b, s, h, d)).astype(np.float32)
    lf = -np.logaddexp(0.0, -rng.standard_normal((b, s, h))).astype(
        np.float32)
    li = -np.logaddexp(0.0, -rng.standard_normal((b, s, h))).astype(
        np.float32)
    args = [torch.from_numpy(x) for x in (q, k, v, lf, li)]
    y_full, st_full = chunked_gla(*args, chunk=16)
    h1, st1 = chunked_gla(*(x[:, :32] for x in args), chunk=16)
    h2, st2 = chunked_gla(*(x[:, 32:] for x in args), chunk=16,
                          init_state=st1)
    np.testing.assert_allclose(y_full[:, 32:].numpy(), h2.numpy(),
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(st_full[0].numpy(), st2[0].numpy(),
                               atol=1e-4, rtol=1e-3)
    jy, (jS, _) = jchunked_gla(*(jnp.asarray(x) for x in (q, k, v, lf, li)),
                               chunk=16)
    np.testing.assert_allclose(y_full.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(st_full[0].numpy(), np.asarray(jS),
                               atol=1e-4, rtol=1e-3)


@given(x=st.lists(st.floats(-1e5, 1e5), min_size=1, max_size=200))
@settings(**_settings)
def test_kahan_sum_tracks_float64(x):
    total = comp = np.float32(0.0)
    jtotal = jcomp = jnp.float32(0.0)
    for v in x:
        total, comp = kahan_add(total, comp, np.float32(v))
        jtotal, jcomp = jkahan_add(jtotal, jcomp, jnp.float32(v))
    want = np.sum(np.asarray(x, np.float64))
    scale = max(np.sum(np.abs(x)), 1.0)
    assert abs(float(total) - want) / scale < 1e-5
    assert float(total) == float(jtotal)
