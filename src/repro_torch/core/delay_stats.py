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

Subnormals follow the reference's rule: XLA runs with flush-to-zero and
denormals-are-zero on the CPU and the TPU, so a subnormal input or
intermediate result reads as zero there.  Each closed form here flushes
its inputs and every operation's result (:func:`_ftz`, per tensor, not
``torch.set_flush_denormal``, which would change the whole process), in
the reference's operation order; for normal values that is a no-op.
``core.state.kahan_add``, the simulator's latency sum, follows the same
rule.
"""
from __future__ import annotations

import torch

from .state import flush_subnormals

__all__ = [
    "det_mean", "det_var", "stoch_mean", "stoch_var", "stoch_std",
    "agg_mean_from_moments", "agg_var_from_moments",
    "mc_aggregate_delay", "mc_moments",
]


def _ftz(x):
    """``x`` (a Python number: f32) with its subnormal entries read as
    zero (:func:`repro_torch.core.state.flush_subnormals`)."""
    return flush_subnormals(x if isinstance(x, torch.Tensor) else
                            torch.tensor(x, dtype=torch.float32))


# One rounded operation each, its result flushed as XLA flushes it.
def _add(a, b):
    return _ftz(a + b)


def _sub(a, b):
    return _ftz(a - b)


def _mul(a, b):
    return _ftz(a * b)


def _div(a, b):
    return _ftz(a / b)


# Theorem 1: E[D] = z(1 + lambda z / 2), Var[D] = lambda z^3 / 3.
def det_mean(lam, z):
    """Mean aggregate delay under deterministic miss latency (Theorem 1)."""
    lam, z = _ftz(lam), _ftz(z)
    return _mul(z, _add(1.0, _mul(_mul(0.5, lam), z)))


def det_var(lam, z):
    """Variance of aggregate delay under deterministic latency (Theorem 1)."""
    lam, z = _ftz(lam), _ftz(z)
    return _div(_mul(lam, _mul(_mul(z, z), z)), 3.0)


# Theorem 2 (Z ~ Exp(1/z)): E[D] = z + lambda z^2,
# Var[D] = z^2 + 6 lambda z^3 + 5 lambda^2 z^4.
def stoch_mean(lam, z):
    """Mean aggregate delay under Exp miss latency (Theorem 2, eq. 6)."""
    lam, z = _ftz(lam), _ftz(z)
    return _add(z, _mul(lam, _mul(z, z)))


def stoch_var(lam, z):
    """Variance of aggregate delay under Exp miss latency (Theorem 2, eq. 7)."""
    lam, z = _ftz(lam), _ftz(z)
    z2 = _mul(z, z)
    return _add(_add(z2, _mul(_mul(_mul(6.0, lam), z2), z)),
                _mul(_mul(_mul(_mul(5.0, lam), lam), z2), z2))


def stoch_std(lam, z):
    """Standard deviation of aggregate delay under Exp miss latency."""
    return _ftz(torch.sqrt(stoch_var(lam, z)))


# Arbitrary fetch-time laws: conditional on Z, D = Z + compound-Poisson
# (lambda Z) of U[0, Z) residuals, so with m_k = E[Z^k]:
#   E[D] = m1 + lambda m2 / 2
#   Var[D] = lambda m3 / 3 + Var[Z] + lambda Cov(Z, Z^2) + lambda^2 Var[Z^2] / 4
def agg_mean_from_moments(lam, m1, m2):
    """E[D] from the first two raw moments of the fetch time Z."""
    lam, m1, m2 = _ftz(lam), _ftz(m1), _ftz(m2)
    return _add(m1, _mul(_mul(0.5, lam), m2))


def agg_var_from_moments(lam, m1, m2, m3, m4):
    """Var[D] from the first four raw moments of the fetch time Z."""
    lam, m1, m2, m3, m4 = (_ftz(x) for x in (lam, m1, m2, m3, m4))
    return _add(_add(_add(_div(_mul(lam, m3), 3.0),
                          _sub(m2, _mul(m1, m1))),
                     _mul(lam, _sub(m3, _mul(m1, m2)))),
                _mul(_mul(_mul(0.25, lam), lam), _sub(m4, _mul(m2, m2))))


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
