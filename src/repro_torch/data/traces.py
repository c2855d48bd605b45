"""Synthetic trace generators (paper §5.2) and the §5.3 surrogate specs.

Synthetic: requests over N objects with Zipf popularity, sizes uniform on
[size_min, size_max] MB (integer-floored), miss latency L + c * size with
Exponential realizations, and Poisson or Pareto arrivals.  Draws come from
an explicit ``torch.Generator``; they match the JAX package's generator in
distribution, not bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.distributions import MissLatency, make_distribution
from ..core.trace import Trace, make_trace

__all__ = ["SyntheticSpec", "zipf_probs", "synthetic_trace", "SURROGATES"]


def zipf_probs(n: int, alpha: float, device=None) -> torch.Tensor:
    """Zipf(alpha) popularity over n ranked objects (f32)."""
    r = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    w = r ** (-alpha)
    return w / w.sum()


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    n_objects: int = 100
    n_requests: int = 100_000
    zipf_alpha: float = 0.9
    size_min: float = 1.0          # MB
    size_max: float = 100.0
    rate: float = 1000.0           # global request rate (req/s)
    arrival: str = "poisson"       # 'poisson' | 'pareto'
    pareto_shape: float = 1.5      # heavy-tailed inter-arrivals (mean exists)
    latency_base: float = 0.005    # L: 5 ms (paper §5.4)
    latency_per_mb: float = 2e-4   # c: size-proportional component
    stochastic: bool = True        # Exp-distributed realized fetch latency
    latency_dist: str | None = None  # a distributions registry name
    dist_kwargs: tuple = ()        # e.g. (('k', 3),) for Erlang(k=3)

    def make_dist(self) -> MissLatency | None:
        if self.latency_dist is None:
            return None
        return make_distribution(self.latency_dist, **dict(self.dist_kwargs))


def _interarrivals(g: torch.Generator, spec: SyntheticSpec) -> torch.Tensor:
    kw = dict(generator=g, device=g.device, dtype=torch.float64)
    mean_gap = 1.0 / spec.rate
    if spec.arrival == "poisson":
        return torch.empty(spec.n_requests, device=g.device,
                           dtype=torch.float64).exponential_(
            1.0, generator=g) * mean_gap
    if spec.arrival == "pareto":
        a = spec.pareto_shape
        x_m = mean_gap * (a - 1.0) / a    # mean a*x_m/(a-1) == mean_gap
        u = torch.rand(spec.n_requests, **kw) * (1.0 - 1e-7) + 1e-7
        return x_m * u ** (-1.0 / a)
    raise ValueError(f"unknown arrival process {spec.arrival!r}")


def synthetic_trace(generator: torch.Generator,
                    spec: SyntheticSpec = SyntheticSpec(),
                    device=None) -> Trace:
    """Draw a synthetic trace from ``generator`` (on its device), placed on
    ``device`` (None: the card)."""
    g = generator
    u = torch.rand(spec.n_objects, generator=g, device=g.device,
                   dtype=torch.float32)
    sizes = torch.floor(spec.size_min + u * (spec.size_max + 1.0
                                             - spec.size_min))
    probs = zipf_probs(spec.n_objects, spec.zipf_alpha, device=g.device)
    objs = torch.multinomial(probs, spec.n_requests, replacement=True,
                             generator=g)
    times = torch.cumsum(_interarrivals(g, spec), 0).to(torch.float32)
    z_mean = spec.latency_base + spec.latency_per_mb * sizes
    return make_trace(times, objs, sizes, z_mean, generator=g,
                      stochastic=spec.stochastic, dist=spec.make_dist(),
                      device=device)


# Surrogates for the four real traces (Fig. 3 calibration), at reduced
# universe sizes with the cache-to-footprint ratio kept comparable.
SURROGATES: dict[str, SyntheticSpec] = {
    # Wiki CDN: strong skew, small-object regime, near-Poisson arrivals.
    "wiki2018": SyntheticSpec(n_objects=2000, n_requests=200_000,
                              zipf_alpha=1.05, size_min=0.01, size_max=4.0,
                              rate=2000.0, arrival="poisson"),
    "wiki2019": SyntheticSpec(n_objects=2500, n_requests=200_000,
                              zipf_alpha=0.95, size_min=0.01, size_max=4.0,
                              rate=2500.0, arrival="poisson"),
    # Cloud block storage: flatter popularity, fixed-size blocks, bursty.
    "cloud": SyntheticSpec(n_objects=3000, n_requests=200_000,
                           zipf_alpha=0.65, size_min=0.5, size_max=2.0,
                           rate=4000.0, arrival="pareto", pareto_shape=1.3),
    # YouTube campus: moderate skew, large objects, bursty arrivals.
    "youtube": SyntheticSpec(n_objects=1500, n_requests=150_000,
                             zipf_alpha=0.8, size_min=5.0, size_max=200.0,
                             rate=600.0, arrival="pareto", pareto_shape=1.6),
}
