"""The port's Theorem-1/2 moments and miss-latency laws against the JAX
package, on the grids of tests/test_delay_stats.py and
tests/test_distributions.py; its Monte-Carlo oracle and samplers
statistically (torch.Generator streams are not jax.random's)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delay_stats as jds
from repro.core import distributions as jdl
from repro_torch.core import delay_stats as ds
from repro_torch.core import distributions as dl

CASES = [(0.1, 0.5), (1.0, 1.0), (5.0, 0.3), (20.0, 0.1), (2.0, 4.0)]

# Closed forms are a handful of f32 ops in the reference's order: the two
# packages agree to the last bit in practice; rtol=1e-6 is one f32 ulp of
# headroom for a reordered XLA fusion.
RTOL = 1e-6

LAWS = [
    (dl.Deterministic(), jdl.Deterministic()),
    (dl.Exponential(), jdl.Exponential()),
    (dl.Erlang(k=2.0), jdl.Erlang(k=2.0)),
    (dl.Erlang(k=4.0), jdl.Erlang(k=4.0)),
    (dl.Hyperexponential(p=0.8, mu_fast=0.5),
     jdl.Hyperexponential(p=0.8, mu_fast=0.5)),
]


@pytest.mark.parametrize("lam,z", CASES)
def test_theorem_closed_forms_match_jax(lam, z):
    for ours, ref in [(ds.det_mean, jds.det_mean), (ds.det_var, jds.det_var),
                      (ds.stoch_mean, jds.stoch_mean),
                      (ds.stoch_var, jds.stoch_var),
                      (ds.stoch_std, jds.stoch_std)]:
        np.testing.assert_allclose(float(ours(lam, z)), float(ref(lam, z)),
                                   rtol=RTOL, err_msg=ours.__name__)


def test_closed_forms_match_jax_on_vectors():
    rng = np.random.default_rng(0)
    lam = rng.uniform(1e-3, 50.0, 1000).astype(np.float32)
    z = rng.uniform(1e-3, 2.0, 1000).astype(np.float32)
    for ours, ref in [(ds.stoch_mean, jds.stoch_mean),
                      (ds.stoch_var, jds.stoch_var),
                      (ds.det_mean, jds.det_mean), (ds.det_var, jds.det_var)]:
        np.testing.assert_allclose(
            ours(torch.from_numpy(lam), torch.from_numpy(z)).numpy(),
            np.asarray(ref(lam, z)), rtol=RTOL, err_msg=ours.__name__)


# Subnormal inputs and intermediates: XLA flushes them to zero, and the
# port follows that rule (the first case is a hypothesis draw that once
# made det_var 4.796e-41 in the port against 0.0 in JAX).
SUBNORMAL = [(1.4388068673503903e-40, 1.0), (1.0, 1e-39), (0.3, 1e-41),
             (2.0, 3e-20), (1e-30, 1e-5), (5.0, 2e-13)]


@pytest.mark.parametrize("lam,z", SUBNORMAL)
def test_subnormals_follow_the_references_flush_rule(lam, z):
    for ours, ref in [(ds.det_mean, jds.det_mean), (ds.det_var, jds.det_var),
                      (ds.stoch_mean, jds.stoch_mean),
                      (ds.stoch_var, jds.stoch_var),
                      (ds.stoch_std, jds.stoch_std)]:
        assert float(ours(lam, z)) == float(ref(lam, z)), ours.__name__
    # the same f32 moments to both (as device arrays, so JAX's XLA runs)
    host = [np.float32(np.float32(z) ** k) for k in range(1, 5)]
    m = [torch.tensor(x) for x in host]
    jm = [jnp.asarray(x) for x in host]
    jlam = jnp.asarray(np.float32(lam))
    assert float(ds.agg_mean_from_moments(lam, *m[:2])) == float(
        jds.agg_mean_from_moments(jlam, *jm[:2]))
    assert float(ds.agg_var_from_moments(lam, *m)) == float(
        jds.agg_var_from_moments(jlam, *jm))


@pytest.mark.parametrize("lam,z", CASES)
def test_generic_formulas_recover_both_theorems(lam, z):
    for d, mean_fn, var_fn in [(dl.Deterministic(), ds.det_mean, ds.det_var),
                               (dl.Exponential(), ds.stoch_mean,
                                ds.stoch_var)]:
        m1, m2, m3, m4 = d.raw_moments(z)
        np.testing.assert_allclose(
            float(ds.agg_mean_from_moments(lam, m1, m2)),
            float(mean_fn(lam, z)), rtol=RTOL)
        np.testing.assert_allclose(
            float(ds.agg_var_from_moments(lam, m1, m2, m3, m4)),
            float(var_fn(lam, z)), rtol=RTOL)


@pytest.mark.parametrize("lam,z", CASES[:4])
@pytest.mark.parametrize("law", range(len(LAWS)),
                         ids=["det", "exp", "erlang2", "erlang4", "hyper"])
def test_law_moments_match_jax(lam, z, law):
    ours, ref = LAWS[law]
    np.testing.assert_allclose(
        np.array([float(x) for x in ours.shape_moments()]),
        np.array([float(x) for x in ref.shape_moments()]), rtol=RTOL)
    np.testing.assert_allclose(float(ours.agg_mean(lam, z)),
                               float(ref.agg_mean(lam, z)), rtol=RTOL)
    np.testing.assert_allclose(float(ours.agg_var(lam, z)),
                               float(ref.agg_var(lam, z)), rtol=RTOL)
    np.testing.assert_allclose(float(ours.latency_var(z)),
                               float(ref.latency_var(z)), rtol=RTOL)


@pytest.mark.parametrize("lam,z", [(0.1, 0.5), (1.0, 1.0), (5.0, 0.3)])
@pytest.mark.parametrize("stochastic", [True, False])
def test_monte_carlo_oracle_matches_theorems(lam, z, stochastic):
    g = torch.Generator().manual_seed(42)
    m, v = ds.mc_moments(g, lam, z, n=100_000, stochastic=stochastic,
                         max_k=48)
    mean_fn, var_fn = ((ds.stoch_mean, ds.stoch_var) if stochastic
                       else (ds.det_mean, ds.det_var))
    np.testing.assert_allclose(float(m), float(mean_fn(lam, z)), rtol=0.03)
    np.testing.assert_allclose(float(v), float(var_fn(lam, z)), rtol=0.08)


def test_monte_carlo_oracle_with_erlang_sampler():
    d = dl.Erlang(k=2.0)
    g = torch.Generator().manual_seed(11)
    m, v = ds.mc_moments(g, 1.0, 1.0, n=100_000, sampler=d.sample_unit,
                         max_k=48)
    np.testing.assert_allclose(float(m), float(d.agg_mean(1.0, 1.0)),
                               rtol=0.03)
    np.testing.assert_allclose(float(v), float(d.agg_var(1.0, 1.0)),
                               rtol=0.08)


@pytest.mark.parametrize("law", range(len(LAWS)),
                         ids=["det", "exp", "erlang2", "erlang4", "hyper"])
def test_sampler_moments_are_the_shape_moments(law):
    ours, _ = LAWS[law]
    u = ours.sample_unit(torch.Generator().manual_seed(3), (200_000,))
    assert u.dtype == torch.float32
    c1, c2 = (float(x) for x in ours.shape_moments()[:2])
    np.testing.assert_allclose(float(u.double().mean()), c1, rtol=0.02)
    np.testing.assert_allclose(float((u.double() ** 2).mean()), c2,
                               rtol=0.05)


def test_monte_carlo_law_recovers_erlang():
    k = 3.0
    mc = dl.MonteCarlo(sampler=lambda g, shape: dl.Erlang(k=k).sample_unit(
        g, shape), n_est=200_000)
    np.testing.assert_allclose(
        np.array(mc.shape_moments()),
        np.array([float(x) for x in dl.Erlang(k=k).shape_moments()]),
        rtol=0.03)


def test_registry_and_errors():
    assert isinstance(dl.make_distribution("erlang", k=3.0), dl.Erlang)
    with pytest.raises(ValueError):
        dl.make_distribution("cauchy")
    with pytest.raises(ValueError):
        dl.Hyperexponential(p=0.9, mu_fast=1.2)
