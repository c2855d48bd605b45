"""Analytic statistics of the aggregate delay D_i for delayed-hit caching.

Theorem 1 (deterministic miss latency, from VA-CDH) and Theorem 2
(exponentially distributed miss latency, the paper's contribution), the
generic compound-Poisson moment formulas, and a Monte-Carlo oracle drawn
from an explicit ``torch.Generator``.

Notation (paper §2.1): lambda_i is the Poisson arrival rate of object i,
z_i its mean miss latency, and D_i = Z_i + sum over arrivals t' in
(t, t+Z_i] of the remaining fetch time (t + Z_i - t').

The closed forms take tensors or Python numbers and compute in the
arguments' dtype (f32 for the simulator), in the same operation order as
the JAX reference so the two agree to the last bit on basic arithmetic.
"""
from __future__ import annotations

import torch

__all__ = [
    "det_mean", "det_var", "stoch_mean", "stoch_var", "stoch_std",
    "agg_mean_from_moments", "agg_var_from_moments",
    "mc_aggregate_delay", "mc_moments",
]


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.tensor(
        x, dtype=torch.float32)


# Theorem 1: E[D] = z(1 + lambda z / 2), Var[D] = lambda z^3 / 3.
def det_mean(lam, z):
    """Mean aggregate delay under deterministic miss latency (Theorem 1)."""
    lam, z = _t(lam), _t(z)
    return z * (1.0 + 0.5 * lam * z)


def det_var(lam, z):
    """Variance of aggregate delay under deterministic latency (Theorem 1)."""
    lam, z = _t(lam), _t(z)
    return lam * (z * z * z) / 3.0


# Theorem 2 (Z ~ Exp(1/z)): E[D] = z + lambda z^2,
# Var[D] = z^2 + 6 lambda z^3 + 5 lambda^2 z^4.
def stoch_mean(lam, z):
    """Mean aggregate delay under Exp miss latency (Theorem 2, eq. 6)."""
    lam, z = _t(lam), _t(z)
    return z + lam * (z * z)


def stoch_var(lam, z):
    """Variance of aggregate delay under Exp miss latency (Theorem 2, eq. 7)."""
    lam, z = _t(lam), _t(z)
    z2 = z * z
    return z2 + 6.0 * lam * z2 * z + 5.0 * lam * lam * z2 * z2


def stoch_std(lam, z):
    """Standard deviation of aggregate delay under Exp miss latency."""
    return torch.sqrt(stoch_var(lam, z))


# Arbitrary fetch-time laws: conditional on Z, D = Z + compound-Poisson
# (lambda Z) of U[0, Z) residuals, so with m_k = E[Z^k]:
#   E[D] = m1 + lambda m2 / 2
#   Var[D] = lambda m3 / 3 + Var[Z] + lambda Cov(Z, Z^2) + lambda^2 Var[Z^2] / 4
def agg_mean_from_moments(lam, m1, m2):
    """E[D] from the first two raw moments of the fetch time Z."""
    return m1 + 0.5 * lam * m2


def agg_var_from_moments(lam, m1, m2, m3, m4):
    """Var[D] from the first four raw moments of the fetch time Z."""
    return (lam * m3 / 3.0
            + (m2 - m1 * m1)
            + lam * (m3 - m1 * m2)
            + 0.25 * lam * lam * (m4 - m2 * m2))


# Monte-Carlo oracle: D = Z + sum_{j<K} V_j, K ~ Poisson(lambda Z),
# V_j ~ U[0, Z).
def mc_aggregate_delay(generator: torch.Generator, lam: float, z: float,
                       n: int, stochastic: bool = True, max_k: int = 512,
                       sampler=None) -> torch.Tensor:
    """Draw ``n`` iid samples of the aggregate delay D (f64).

    ``sampler(generator, shape) -> unit-mean draws`` selects the fetch-time
    law (e.g. ``dist.sample_unit``); ``stochastic`` keeps the
    Deterministic/Exponential switch.  ``max_k`` truncates the Poisson
    count (mass beyond 512 is negligible for lam*z <= 32)."""
    dev = generator.device
    kw = dict(generator=generator, device=dev, dtype=torch.float64)
    if sampler is not None:
        Z = sampler(generator, (n,)).to(torch.float64) * z
    elif stochastic:
        Z = torch.empty(n, device=dev, dtype=torch.float64).exponential_(
            1.0, generator=generator) * z
    else:
        Z = torch.full((n,), float(z), device=dev, dtype=torch.float64)
    K = torch.poisson(lam * Z, generator=generator).clamp_(max=max_k)
    U = torch.rand((n, max_k), **kw) * Z[:, None]
    mask = torch.arange(max_k, device=dev)[None, :] < K[:, None]
    return Z + torch.where(mask, U, 0.0).sum(dim=-1)


def mc_moments(generator: torch.Generator, lam: float, z: float, n: int,
               stochastic: bool = True, sampler=None, max_k: int = 512):
    """Monte-Carlo (mean, population variance) of D from ``n`` samples."""
    d = mc_aggregate_delay(generator, lam, z, n, stochastic=stochastic,
                           max_k=max_k, sampler=sampler)
    return d.mean(), d.var(correction=0)
