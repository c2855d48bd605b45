"""The port's 13 rank epilogues and the lazy substrate against the JAX
package, on numpy ObjStats snapshots that include the cold-start cases
(count 0/1/2, gap_mean 0, age 0, no completed episode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributions as jdl
from repro.core import ranking as jr
from repro.core.state import ObjStats as JObjStats
from repro_torch.convert import obj_stats_from_arrays, params_from_dict
from repro_torch.core import ranking as pr

# Scores are f32 chains of a few ops; eager torch and jitted XLA may round
# one op differently, so one part in a million.
RTOL = 1e-6
T = 50.0


def _snapshot(n=48, seed=0):
    """Object statistics with every cold-start corner in the first rows."""
    rng = np.random.default_rng(seed)
    count = rng.integers(0, 30, n).astype(np.float32)
    count[:8] = [0, 1, 2, 2, 5, 0, 1, 3]
    gap_mean = rng.uniform(0.01, 3.0, n).astype(np.float32)
    gap_mean[[0, 2, 5]] = 0.0                     # never / duplicate stamps
    last = (T - rng.uniform(0.0, 20.0, n)).astype(np.float32)
    last[[0, 5]] = -np.inf                        # never accessed
    last[[2, 3, 6]] = T                           # age exactly 0
    agg_cnt = rng.integers(0, 6, n).astype(np.float32)
    agg_cnt[:4] = [0, 1, 2, 0]
    agg_sum = (agg_cnt * rng.uniform(0.01, 0.5, n)).astype(np.float32)
    agg_sq = (agg_sum * agg_sum / np.maximum(agg_cnt, 1)
              * rng.uniform(1.0, 2.0, n)).astype(np.float32)
    f = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)
    return dict(
        cached=rng.random(n) < 0.6, in_flight=rng.random(n) < 0.2,
        complete_t=f(T, T + 1), issue_t=f(T - 1, T), last_access=last,
        first_access=last - f(0, 10), gap_mean=gap_mean, count=count,
        z_est=f(0.005, 0.03), agg_sum=agg_sum, agg_sq_sum=agg_sq,
        agg_cnt=agg_cnt, episode_delay=f(0, 0.1), gd_h=f(0, 5))


PARAMS = [
    dict(omega=1.0, resid="recency"),
    dict(omega=2.5, resid="rate", cold_rate=2e-3, window=16),
    dict(omega=0.0, resid="recency", cala_beta=0.3),
    dict(omega=1.0, resid="recency", dist=("erlang", {"k": 3.0})),
    dict(omega=1.0, resid="rate",
         dist=("hyperexp", {"p": 0.8, "mu_fast": 0.5})),
]


def _jax_params(d):
    d = dict(d)
    name, kw = d.pop("dist", ("exponential", {}))
    return jr.PolicyParams(dist=jdl.make_distribution(name, **kw), **d)


@pytest.mark.parametrize("policy", sorted(jr.POLICIES))
@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_epilogue_matches_jax(policy, pi):
    snap = _snapshot(seed=pi)
    sizes = np.random.default_rng(9).uniform(0.5, 50, 48).astype(np.float32)
    jo = JObjStats(**{k: jnp.asarray(v) for k, v in snap.items()})
    want = np.asarray(jr.POLICIES[policy].rank(
        jo, jnp.asarray(sizes), jnp.float32(T), _jax_params(PARAMS[pi])))
    po = obj_stats_from_arrays(device="cpu", **snap)
    got = pr.POLICIES[policy].rank(po, torch.from_numpy(sizes), T,
                                   params_from_dict(PARAMS[pi])).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=policy)


@pytest.mark.parametrize("field", ["lam", "resid", "size_eps", "denom",
                                   "det_mean", "det_std", "dist_mean",
                                   "dist_std", "hist_mean", "hist_std"])
def test_substrate_fields_match_jax(field):
    snap = _snapshot(seed=4)
    sizes = np.linspace(0.0, 10.0, 48).astype(np.float32)   # includes 0
    jo = JObjStats(**{k: jnp.asarray(v) for k, v in snap.items()})
    js = jr.make_substrate(jo, jnp.asarray(sizes), jnp.float32(T),
                           jr.PolicyParams())
    ps = pr.make_substrate(obj_stats_from_arrays(device="cpu", **snap),
                           torch.from_numpy(sizes), T, pr.PolicyParams())
    np.testing.assert_allclose(getattr(ps, field).numpy(),
                               np.asarray(getattr(js, field)), rtol=RTOL)


def test_cold_start_gate_values():
    """Age 0: the mean gap once it is observed and non-degenerate, else the
    1/cold_rate prior (never the 1e6-inflating EPS clamp)."""
    snap = _snapshot()
    r = pr.residual_hat(obj_stats_from_arrays(device="cpu", **snap), T,
                        pr.PolicyParams()).numpy()
    prior = np.float32(1.0) / np.float32(1e-3)
    assert r[2] == prior                    # count 2, gap_mean 0
    assert r[3] == snap["gap_mean"][3]      # count 2, real gap
    assert r[6] == prior                    # count 1
    assert r[0] == np.inf                   # never accessed: age inf


def test_params_from_dict_round_trip():
    p = params_from_dict(dict(omega=2.0, window=8, resid="rate",
                              dist=("erlang", {"k": 2.0})))
    assert p.resid_rate == 1.0 and p.window == 8
    assert p.gap_alpha == np.float32(1.0) / np.float32(8)
    assert isinstance(p.dist, pr.MissLatency) and p.dist.k == 2.0
    with pytest.raises(ValueError):
        params_from_dict(dict(omeg=1.0))
    with pytest.raises(ValueError):
        pr.PolicyParams(resid="bogus")


def test_registry_matches_jax():
    assert sorted(pr.POLICIES) == sorted(jr.POLICIES)
    for name, q in pr.POLICIES.items():
        j = jr.POLICIES[name]
        assert (q.greedydual, q.gd_cost, q.admission, q.compare_admission) \
            == (j.greedydual, j.gd_cost, j.admission, j.compare_admission)
    assert pr.BASELINES == jr.BASELINES and pr.OURS == jr.OURS
