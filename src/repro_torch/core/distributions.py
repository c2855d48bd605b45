"""Pluggable miss-latency distributions for the delayed-hit analysis.

Each law is a unit-mean fetch-time *shape* scaled per object by its mean
latency ``z``.  Conditional on the fetch time Z the aggregate delay is a
compound Poisson of uniform residuals (paper §3.1), so its moments depend on
Z only through ``m_k = E[Z^k]``; ``Deterministic`` and ``Exponential`` use the
Theorem-1/2 closed forms of :mod:`repro_torch.core.delay_stats` instead.

Moments are computed in f32 with the reference's operation order; samplers
draw from an explicit ``torch.Generator`` (statistically, not bitwise, the
reference's streams).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from . import delay_stats as ds

__all__ = ["MissLatency", "Deterministic", "Exponential", "Erlang",
           "Hyperexponential", "MonteCarlo", "DISTRIBUTIONS",
           "make_distribution"]


def _f32(x):
    return x if isinstance(x, torch.Tensor) else torch.tensor(
        x, dtype=torch.float32)


def _unit_kw(generator: torch.Generator):
    return dict(generator=generator, device=generator.device,
                dtype=torch.float32)


def _exponential(generator, shape):
    return torch.empty(shape, device=generator.device,
                       dtype=torch.float32).exponential_(
        1.0, generator=generator)


def _gamma(generator, k: float, shape):
    """Unit-scale Gamma(k) draws (Marsaglia-Tsang, vectorized rejection)."""
    kw = _unit_kw(generator)
    boost = None
    if k < 1.0:         # Gamma(k) = Gamma(k + 1) * U^(1/k)
        boost = torch.rand(shape, **kw) ** (1.0 / k)
        k = k + 1.0
    d = k - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(shape, device=generator.device, dtype=torch.float32)
    todo = torch.ones(shape, dtype=torch.bool, device=generator.device)
    while bool(todo.any()):
        x = torch.randn(shape, **kw)
        v = (1.0 + c * x) ** 3
        u = torch.rand(shape, **kw)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    return out if boost is None else out * boost


class MissLatency:
    """Base class: a unit-mean fetch-latency shape, scaled per object by z."""

    name: str = "abstract"

    def shape_moments(self):
        """Raw moments (c1, c2, c3, c4) of the unit-mean shape; c1 == 1."""
        raise NotImplementedError

    def sample_unit(self, generator: torch.Generator, shape) -> torch.Tensor:
        """Draw unit-mean fetch-time realizations."""
        raise NotImplementedError

    def raw_moments(self, z):
        """Raw moments (m1..m4) of Z for per-object mean latency ``z``."""
        z = _f32(z)
        c1, c2, c3, c4 = self.shape_moments()
        z2 = z * z
        return c1 * z, c2 * z2, c3 * z2 * z, c4 * z2 * z2

    def latency_var(self, z):
        """Variance of the fetch time itself: Var[Z]."""
        m1, m2, _, _ = self.raw_moments(z)
        return m2 - m1 * m1

    def agg_mean(self, lam, z):
        """E[D]: mean aggregate delay at arrival rate ``lam``, mean ``z``."""
        m1, m2, _, _ = self.raw_moments(z)
        return ds.agg_mean_from_moments(_f32(lam), m1, m2)

    def agg_var(self, lam, z):
        """Var[D]: variance of the aggregate delay."""
        m1, m2, m3, m4 = self.raw_moments(z)
        return ds.agg_var_from_moments(_f32(lam), m1, m2, m3, m4)

    def agg_std(self, lam, z):
        return torch.sqrt(self.agg_var(lam, z))

    def sample(self, generator: torch.Generator, z) -> torch.Tensor:
        """Realized fetch times with per-draw means ``z`` (broadcasts)."""
        z = torch.as_tensor(z, dtype=torch.float32, device=generator.device)
        return z * self.sample_unit(generator, tuple(z.shape))


@dataclasses.dataclass(frozen=True)
class Deterministic(MissLatency):
    """Z == z surely (VA-CDH's setting); Theorem 1 closed forms."""

    name = "deterministic"

    def shape_moments(self):
        return (1.0, 1.0, 1.0, 1.0)

    def sample_unit(self, generator, shape):
        return torch.ones(shape, dtype=torch.float32, device=generator.device)

    def agg_mean(self, lam, z):
        return ds.det_mean(lam, z)

    def agg_var(self, lam, z):
        return ds.det_var(lam, z)


@dataclasses.dataclass(frozen=True)
class Exponential(MissLatency):
    """Z ~ Exp(1/z), the paper's setting; Theorem 2 closed forms."""

    name = "exponential"

    def shape_moments(self):
        return (1.0, 2.0, 6.0, 24.0)

    def sample_unit(self, generator, shape):
        return _exponential(generator, shape)

    def agg_mean(self, lam, z):
        return ds.stoch_mean(lam, z)

    def agg_var(self, lam, z):
        return ds.stoch_var(lam, z)


@dataclasses.dataclass(frozen=True)
class Erlang(MissLatency):
    """Z ~ Erlang(k, rate k/z): unit-mean Gamma with shape ``k``
    (k = 1 is Exponential, k -> inf Deterministic)."""

    k: float = 2.0

    name = "erlang"

    def shape_moments(self):
        k = _f32(self.k)
        return (torch.tensor(1.0, dtype=torch.float32),
                (k + 1.0) / k,
                (k + 1.0) * (k + 2.0) / (k * k),
                (k + 1.0) * (k + 2.0) * (k + 3.0) / (k * k * k))

    def sample_unit(self, generator, shape):
        return _gamma(generator, float(self.k), shape) / float(self.k)


@dataclasses.dataclass(frozen=True)
class Hyperexponential(MissLatency):
    """Two-branch mixture of exponentials normalized to unit mean: with
    probability ``p`` the fetch is fast (mean ``mu_fast``), else slow."""

    p: float = 0.9
    mu_fast: float = 0.5

    name = "hyperexp"

    def __post_init__(self):
        if not 0.0 <= self.p < 1.0:
            raise ValueError(f"p={self.p} must be in [0, 1)")
        if self.mu_fast <= 0.0 or self.p * self.mu_fast >= 1.0:
            raise ValueError(
                f"p*mu_fast={self.p * self.mu_fast} must be < 1 (and "
                f"mu_fast > 0) for a positive unit-mean slow branch")

    def _branches(self):
        p, mu1 = _f32(self.p), _f32(self.mu_fast)
        mu2 = (1.0 - p * mu1) / torch.clamp(1.0 - p, min=1e-9)
        return p, mu1, mu2

    def shape_moments(self):
        p, mu1, mu2 = self._branches()
        mix = lambda f1, f2: p * f1 + (1.0 - p) * f2
        return (mix(mu1, mu2),
                2.0 * mix(mu1 ** 2, mu2 ** 2),
                6.0 * mix(mu1 ** 3, mu2 ** 3),
                24.0 * mix(mu1 ** 4, mu2 ** 4))

    def sample_unit(self, generator, shape):
        p, mu1, mu2 = (float(x) for x in self._branches())
        fast = torch.rand(shape, **_unit_kw(generator)) < p
        mu = torch.where(fast, mu1, mu2)
        return mu * _exponential(generator, shape)


@dataclasses.dataclass(frozen=True)
class MonteCarlo(MissLatency):
    """Arbitrary shape: moments estimated once from ``sampler(generator,
    shape)``, renormalized to unit mean (the Monte-Carlo fallback).
    Passing ``moments``/``unit_scale`` skips the estimation pass."""

    sampler: Callable
    n_est: int = 200_000
    est_seed: int = 0
    moments: tuple | None = None
    unit_scale: float | None = None

    name = "monte_carlo"

    def __post_init__(self):
        if self.moments is not None:
            return
        g = torch.Generator().manual_seed(self.est_seed)
        draws = self.sampler(g, (self.n_est,)).to(torch.float64)
        mean = float(torch.clamp(draws.mean(), min=1e-12))
        u = draws / mean
        object.__setattr__(self, "moments", tuple(
            float((u ** k).mean()) for k in (1, 2, 3, 4)))
        object.__setattr__(self, "unit_scale", mean)

    def shape_moments(self):
        return self.moments

    def sample_unit(self, generator, shape):
        return self.sampler(generator, shape).to(torch.float32) \
            / self.unit_scale


DISTRIBUTIONS: dict[str, Callable[..., MissLatency]] = {
    "deterministic": Deterministic,
    "exponential": Exponential,
    "erlang": Erlang,
    "hyperexp": Hyperexponential,
}


def make_distribution(name: str, **kwargs) -> MissLatency:
    """Construct a distribution from its registry name (e.g. ``erlang``)."""
    try:
        return DISTRIBUTIONS[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown miss-latency distribution {name!r}; "
            f"known: {sorted(DISTRIBUTIONS)}") from None
