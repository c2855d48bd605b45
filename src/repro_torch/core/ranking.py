"""Eviction ranking functions: the paper's eq. 16 and every §5.1 baseline.

Every rank maps per-object statistics to a score tensor; **higher score =
more valuable = keep**.  The simulator evicts the lowest-scored cached
object, and (for the delayed-hit family) admits an incoming object only
while the victim scores strictly below it (paper §2.2).

All ranks share one estimator pass, the lazy :class:`Substrate` (each field
is computed on first read and memoized), and each policy's rank is a
few-op epilogue over it.  Every formula is elementwise, so it applies alike
to an ``[N]`` lane of the state and to the ``[L]`` values gathered at one
object per lane (the serve path's scalar estimators).

Arithmetic is f32 throughout.  Parameter-derived constants are rounded to
f32 before use (:func:`_f32`) so that e.g. ``1 / cold_rate`` is the f32
quotient of f32 operands, as in the JAX reference.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from .distributions import Deterministic, Exponential, MissLatency
from .state import ObjStats

EPS = 1e-6

# The deterministic-latency moment model assumed by the VA-CDH / LAC / CALA
# baselines (their published setting), independent of the trace's true law.
_DET = Deterministic()


def _f32(x) -> float:
    """``x`` rounded to f32, as a Python float (exact in any f32 op)."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class PolicyParams:
    """Hyperparameters shared by the ranking functions.

    omega      variance-sensitivity weight (paper's w; eq. 15/16).
    window     per-object estimation window W: the inter-arrival mean is a
               running mean for the first W gaps, then an EWMA(1/W).
    resid      residual-time estimator for R_i: 'rate' (R = 1/lambda) or
               'recency' (R = t - last_access, the LRU proxy).
    cala_beta  CALA's weight between historical AggDelay and the analytic
               mean-based estimate.
    adapt_c    AdaptSize admission scale (admit w.p. exp(-size/adapt_c)).
    cold_rate  arrival-rate prior for objects with < 2 observations.
    dist       miss-latency law assumed by eq. 16 (Exponential() is the
               paper's Theorem 2).
    """

    omega: float = 1.0
    cala_beta: float = 0.5
    adapt_c: float = 25.0
    cold_rate: float = 1e-3
    window: int = 64
    resid: dataclasses.InitVar[str] = "recency"
    dist: MissLatency = Exponential()
    resid_rate: float | None = None

    def __post_init__(self, resid):
        if self.resid_rate is None:
            if resid not in ("rate", "recency"):
                raise ValueError(f"unknown residual estimator {resid!r}")
            object.__setattr__(self, "resid_rate",
                               1.0 if resid == "rate" else 0.0)

    @property
    def gap_alpha(self) -> float:
        return _f32(np.float32(1.0) / np.float32(self.window))


# ---------------------------------------------------------------------------
# Online estimators (shared substrate)
# ---------------------------------------------------------------------------
def lambda_hat(o: ObjStats, p: PolicyParams) -> torch.Tensor:
    """Arrival-rate estimate: inverse windowed mean inter-arrival."""
    lam = 1.0 / torch.clamp(o.gap_mean, min=EPS)
    return torch.where(o.count >= 2.0, lam, _f32(p.cold_rate))


def residual_hat(o: ObjStats, t, p: PolicyParams) -> torch.Tensor:
    """Estimated residual time until the next request (paper §4's R_i).

    'recency' is t - last_access, except for an object scored at the very
    instant of its own last access (age <= EPS): its residual is then its
    mean gap once that is observed and non-degenerate, else the cold-rate
    prior ``1/cold_rate`` (the cold-start gate)."""
    if p.resid_rate > 0.5:
        return 1.0 / torch.clamp(lambda_hat(o, p), min=EPS)
    age = t - o.last_access
    prior = _f32(np.float32(1.0) / max(np.float32(p.cold_rate),
                                       np.float32(EPS)))
    just_touched = torch.where((o.count >= 2.0) & (o.gap_mean > EPS),
                               o.gap_mean, prior)
    return torch.where(age > EPS, age, just_touched)


def agg_mean_hat(o: ObjStats) -> torch.Tensor:
    """Historical mean aggregate delay; z_est before any episode."""
    m = o.agg_sum / torch.clamp(o.agg_cnt, min=1.0)
    return torch.where(o.agg_cnt > 0.0, m, o.z_est)


def agg_std_hat(o: ObjStats) -> torch.Tensor:
    """Population std of historical aggregate delay (0 before 2 episodes)."""
    n = torch.clamp(o.agg_cnt, min=1.0)
    m = o.agg_sum / n
    var = torch.clamp(o.agg_sq_sum / n - m * m, min=0.0)
    return torch.where(o.agg_cnt >= 2.0, torch.sqrt(var), 0.0)


class Substrate:
    """The shared estimator state every registered rank reads from.

    lam / resid     lambda_hat(o, p) / residual_hat(o, t, p)
    size_eps, denom max(sizes, EPS) and resid * size_eps (eq. 15/16's
                    normalizer)
    det_mean/std    Theorem-1 moments (VA-CDH / LAC / CALA's model)
    dist_mean/std   moments under ``p.dist`` (eq. 16)
    hist_mean/std   historical episode moments (CALA / toy policies)
    """

    def __init__(self, o: ObjStats, sizes, t, p: PolicyParams):
        self.obj = o
        self.sizes = sizes
        self.t = t
        self.p = p
        self.last_access = o.last_access
        self.count = o.count
        self.gd_h = o.gd_h
        self.z_est = o.z_est

    @functools.cached_property
    def lam(self):
        return lambda_hat(self.obj, self.p)

    @functools.cached_property
    def resid(self):
        return residual_hat(self.obj, self.t, self.p)

    @functools.cached_property
    def size_eps(self):
        return torch.clamp(self.sizes, min=EPS)

    @functools.cached_property
    def denom(self):
        return self.resid * self.size_eps

    @functools.cached_property
    def det_mean(self):
        return _DET.agg_mean(self.lam, self.z_est)

    @functools.cached_property
    def det_std(self):
        return _DET.agg_std(self.lam, self.z_est)

    @functools.cached_property
    def dist_mean(self):
        return self.p.dist.agg_mean(self.lam, self.z_est)

    @functools.cached_property
    def dist_std(self):
        return self.p.dist.agg_std(self.lam, self.z_est)

    @functools.cached_property
    def hist_mean(self):
        return agg_mean_hat(self.obj)

    @functools.cached_property
    def hist_std(self):
        return agg_std_hat(self.obj)


def make_substrate(o: ObjStats, sizes, t, p: PolicyParams) -> Substrate:
    """The shared (lazy, memoized) estimator pass at time ``t``."""
    return Substrate(o, sizes, t, p)


# ---------------------------------------------------------------------------
# Rank epilogues: (substrate, params) -> scores
# ---------------------------------------------------------------------------
EpilogueFn = Callable[[Substrate, PolicyParams], torch.Tensor]


def epi_lru(s, p):
    """LRU: most recently used is most valuable."""
    return s.last_access


def epi_lfu(s, p):
    """LFU: request count."""
    return s.count


def epi_lhd(s, p):
    """LHD-lite: hit density lambda / size (Poisson limit of LHD)."""
    return s.lam / s.size_eps


def epi_adaptsize(s, p):
    """AdaptSize ranks like LRU; its size-aware admission filter lives in
    the simulator."""
    return s.last_access


def epi_greedydual(s, p):
    """GreedyDual H value (LRU-MAD / LHD-MAD), maintained by the simulator."""
    return s.gd_h


def epi_lac(s, p):
    """LAC: deterministic-latency mean aggregate delay per byte and per unit
    residual time."""
    return s.det_mean / s.denom


def epi_cala(s, p):
    """CALA: blend of historical AggDelay and the analytic estimate."""
    beta = _f32(p.cala_beta)
    est = beta * s.hist_mean + _f32(np.float32(1.0) - np.float32(beta)) \
        * s.det_mean
    return est / s.denom


def epi_vacdh(s, p):
    """VA-CDH: eq. 15 with Theorem-1 (deterministic-latency) moments."""
    return (s.det_mean + _f32(p.omega) * s.det_std) / s.denom


def epi_stochastic_vacdh(s, p):
    """THE PAPER: eq. 16 with the moments of ``p.dist`` (Theorem 2 for the
    default Exponential)."""
    return (s.dist_mean + _f32(p.omega) * s.dist_std) / s.denom


def epi_lrb_lite(s, p):
    """LRB-lite: predicted next-use proximity blending rate and recency."""
    pred_next = 1.0 / torch.clamp(s.lam, min=EPS) + 0.5 * s.resid
    return -pred_next / s.size_eps * s.hist_mean


def epi_toy_mean(s, p):
    """Fig. 1 Policy 1: empirical mean aggregate delay, unnormalized."""
    return s.hist_mean


def epi_toy_meanstd(s, p):
    """Fig. 1 Policy 2: empirical mean + population std, unnormalized."""
    return s.hist_mean + s.hist_std


RankFn = Callable[[ObjStats, torch.Tensor, object, PolicyParams],
                  torch.Tensor]


def _rank_of(epilogue: EpilogueFn, name: str) -> RankFn:
    def rank(o, sizes, t, p):
        return epilogue(make_substrate(o, sizes, t, p), p)
    rank.__name__ = rank.__qualname__ = name
    rank.__doc__ = epilogue.__doc__
    return rank


rank_lru = _rank_of(epi_lru, "rank_lru")
rank_lfu = _rank_of(epi_lfu, "rank_lfu")
rank_lhd = _rank_of(epi_lhd, "rank_lhd")
rank_adaptsize = _rank_of(epi_adaptsize, "rank_adaptsize")
rank_greedydual = _rank_of(epi_greedydual, "rank_greedydual")
rank_lac = _rank_of(epi_lac, "rank_lac")
rank_cala = _rank_of(epi_cala, "rank_cala")
rank_vacdh = _rank_of(epi_vacdh, "rank_vacdh")
rank_stochastic_vacdh = _rank_of(epi_stochastic_vacdh,
                                 "rank_stochastic_vacdh")
rank_lrb_lite = _rank_of(epi_lrb_lite, "rank_lrb_lite")
rank_toy_mean = _rank_of(epi_toy_mean, "rank_toy_mean")
rank_toy_meanstd = _rank_of(epi_toy_meanstd, "rank_toy_meanstd")


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str
    rank: RankFn
    epilogue: EpilogueFn
    greedydual: bool = False       # maintain gd_h / clock
    gd_cost: str = "agg"           # 'agg' (LRU-MAD) | 'agg_rate' (LHD-MAD)
    admission: str = "always"      # 'always' | 'adaptsize'
    # Rank-compare admission (paper §2.2): evict only victims ranked
    # strictly below the incomer; False is the classical always-admit.
    compare_admission: bool = True


POLICIES: dict[str, Policy] = {
    "lru": Policy("lru", rank_lru, epi_lru, compare_admission=False),
    "lfu": Policy("lfu", rank_lfu, epi_lfu, compare_admission=False),
    "lhd": Policy("lhd", rank_lhd, epi_lhd, compare_admission=False),
    "adaptsize": Policy("adaptsize", rank_adaptsize, epi_adaptsize,
                        admission="adaptsize", compare_admission=False),
    "lru_mad": Policy("lru_mad", rank_greedydual, epi_greedydual,
                      greedydual=True, gd_cost="agg"),
    "lhd_mad": Policy("lhd_mad", rank_greedydual, epi_greedydual,
                      greedydual=True, gd_cost="agg_rate"),
    "lac": Policy("lac", rank_lac, epi_lac),
    "cala": Policy("cala", rank_cala, epi_cala),
    "vacdh": Policy("vacdh", rank_vacdh, epi_vacdh),
    "stoch_vacdh": Policy("stoch_vacdh", rank_stochastic_vacdh,
                          epi_stochastic_vacdh),  # ours
    "lrb_lite": Policy("lrb_lite", rank_lrb_lite, epi_lrb_lite),
    "toy_mean": Policy("toy_mean", rank_toy_mean, epi_toy_mean),
    "toy_meanstd": Policy("toy_meanstd", rank_toy_meanstd, epi_toy_meanstd),
}

OURS = "stoch_vacdh"
BASELINES = ["lru", "lfu", "lhd", "adaptsize", "lru_mad", "lhd_mad",
             "lac", "cala", "vacdh", "lrb_lite"]
