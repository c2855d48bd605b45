"""Adversarial serving-workload scenario generators.

A copy of the JAX package's ``data/scenarios.py`` (numpy only there too):
every array, and every value of the ``latency_scale``, ``rate_fn`` and
``replica_scales`` callables, is the reference's bit for bit per seed.
The replay benchmarks measure throughput on *stationary* traces; the
serving benchmark needs the workloads that break tails:

* :class:`DiurnalSpec`     load cycles (inhomogeneous Poisson, exact
                           time-rescaling inversion, so arrival mass
                           conserves the nominal rate integral).
* :class:`FlashCrowdSpec`  sudden hot-key bursts: a bounded fraction of
                           all requests concentrates on a few cold keys
                           inside short windows.
* :class:`ZipfDriftSpec`   popularity skew drifting monotonically between
                           two Zipf exponents over the trace.
* :class:`BrownoutSpec`    correlated fetch latencies: an origin brownout
                           multiplies miss latency inside episodes,
                           exposed as the time-varying ``latency_scale``
                           hook of ``LatencyModel`` and the hierarchy hop.
* :class:`OutageSpec`      replica outages: scheduled windows in which one
                           of ``n_replicas`` origins is hard down, exposed
                           as realized ``outages`` windows for the fault
                           plan.
* :class:`DegradedReplicaSpec` the brownout with replica structure: each
                           episode degrades ONE of ``n_replicas`` origins,
                           exposed as per-replica ``replica_scales``
                           schedules, so a hedge to an independent replica
                           can route around it.

Every generator is pure numpy off one ``np.random.default_rng(seed)`` and
returns a :class:`ServingWorkload` with sorted non-negative ``times``
(f64), dense integer ``keys``, per-request ``n_tokens`` and the scenario's
metadata.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

__all__ = ["ServingWorkload", "DiurnalSpec", "FlashCrowdSpec",
           "ZipfDriftSpec", "BrownoutSpec", "OutageSpec",
           "DegradedReplicaSpec", "SCENARIOS", "make_scenario"]


@dataclasses.dataclass(frozen=True)
class ServingWorkload:
    """A generated open-loop arrival trace for the serving engine.

    times         f64[T] sorted, >= 0 — open-loop arrival instants
    keys          i64[T] — dense prefix/object ids in [0, n_keys)
    n_tokens      i32[T] — per-request prefix length (drives fetch cost)
    burst_mask    bool[T] — True on injected flash-crowd requests
                  (all-False for scenarios without bursts)
    latency_scale t -> multiplier for the origin fetch latency at sim
                  time t (identity for scenarios without brownouts)
    rate_fn       t -> nominal arrival rate at t (req/s); the property
                  tests integrate it to check arrival-mass conservation
    name, spec    provenance
    n_replicas    origin replica count the scenario assumes (1 = the
                  legacy single origin)
    replica_scales per-replica health schedules: tuple of t -> multiplier
                  callables, one per replica (empty = all healthy /
                  governed by the global ``latency_scale``)
    outages       realized replica-outage windows ``(replica, t0, t1)``
                  for the engine's fault plan (empty = none)
    """

    times: np.ndarray
    keys: np.ndarray
    n_tokens: np.ndarray
    burst_mask: np.ndarray
    latency_scale: Callable[[float], float]
    rate_fn: Callable[[float], float]
    name: str
    spec: object
    n_replicas: int = 1
    replica_scales: tuple = ()
    outages: tuple = ()

    @property
    def n_requests(self) -> int:
        return int(self.times.shape[0])

    @property
    def duration(self) -> float:
        return float(self.times[-1]) if self.n_requests else 0.0


def _zipf_probs(n: int, alpha: float) -> np.ndarray:
    p = np.arange(1, n + 1, dtype=np.float64) ** -alpha
    return p / p.sum()


def _tokens_per_key(rng: np.random.Generator, n_keys: int,
                    lo: int = 64, hi: int = 2048) -> np.ndarray:
    """Per-key prefix length, fixed across the trace (a prefix's size does
    not change between requests for it)."""
    return rng.integers(lo, hi, n_keys, dtype=np.int64)


def _identity_scale(t: float) -> float:
    return 1.0


@dataclasses.dataclass(frozen=True)
class DiurnalSpec:
    """Inhomogeneous Poisson arrivals with a sinusoidal rate cycle,
    ``rate(t) = rate * (1 + amplitude * sin(2 pi t / period))``.

    Sampling is exact time-rescaling: unit-exponential cumulative sums are
    mapped through the inverse of ``Lambda(t) = integral rate(s) ds`` (a
    fine-grid interp of the closed-form integral), so the realized count
    over any window is Poisson with the window's true rate mass — the
    conservation property the tests check."""

    n_requests: int = 20_000
    n_keys: int = 2_000
    zipf_alpha: float = 0.9
    rate: float = 2_000.0
    amplitude: float = 0.6          # in [0, 1)
    period: float = 40.0            # compressed "day" (seconds)

    def rate_at(self, t):
        return self.rate * (1.0 + self.amplitude
                            * np.sin(2.0 * np.pi * t / self.period))

    def rate_integral(self, t):
        """Closed-form Lambda(t) = integral_0^t rate(s) ds."""
        w = 2.0 * np.pi / self.period
        return self.rate * (t + self.amplitude / w * (1.0 - np.cos(w * t)))

    def generate(self, seed: int = 0) -> ServingWorkload:
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError("amplitude must be in [0, 1)")
        rng = np.random.default_rng(seed)
        e = np.cumsum(rng.exponential(1.0, self.n_requests))
        # invert Lambda on a grid that certainly covers e[-1]:
        # Lambda(t) >= rate * (t - amplitude * period / pi)
        t_max = e[-1] / self.rate + self.amplitude * self.period / np.pi + 1.0
        grid = np.linspace(0.0, t_max, 200_001)
        times = np.interp(e, self.rate_integral(grid), grid)
        keys = rng.choice(self.n_keys, self.n_requests,
                          p=_zipf_probs(self.n_keys, self.zipf_alpha))
        tok = _tokens_per_key(rng, self.n_keys)
        return ServingWorkload(
            times=times.astype(np.float64), keys=keys.astype(np.int64),
            n_tokens=tok[keys].astype(np.int32),
            burst_mask=np.zeros(self.n_requests, bool),
            latency_scale=_identity_scale, rate_fn=self.rate_at,
            name="diurnal", spec=self)


@dataclasses.dataclass(frozen=True)
class FlashCrowdSpec:
    """Stationary Poisson base load plus flash crowds: exactly
    ``floor(burst_fraction * n_requests)`` extra requests concentrated on
    ``hot_per_burst`` previously-cold keys inside ``n_bursts`` short
    windows.  ``burst_mask`` marks the injected requests, so the mass
    bound is exact by construction (the property the tests pin)."""

    n_requests: int = 20_000
    n_keys: int = 2_000
    zipf_alpha: float = 0.9
    rate: float = 2_000.0
    burst_fraction: float = 0.15    # share of total requests in bursts
    n_bursts: int = 3
    burst_duration: float = 0.4     # seconds per burst window
    hot_per_burst: int = 4          # cold keys each burst hammers

    def generate(self, seed: int = 0) -> ServingWorkload:
        if not 0.0 <= self.burst_fraction < 1.0:
            raise ValueError("burst_fraction must be in [0, 1)")
        rng = np.random.default_rng(seed)
        n_burst = int(self.burst_fraction * self.n_requests)
        n_base = self.n_requests - n_burst
        t_base = np.cumsum(rng.exponential(1.0 / self.rate, n_base))
        k_base = rng.choice(self.n_keys, n_base,
                            p=_zipf_probs(self.n_keys, self.zipf_alpha))
        duration = float(t_base[-1])

        # burst windows: spread over the middle 80% so warmup stays clean;
        # targets drawn from the cold half of the key space ("sudden")
        starts = np.sort(rng.uniform(0.1 * duration, 0.9 * duration,
                                     self.n_bursts))
        per = np.full(self.n_bursts, n_burst // max(self.n_bursts, 1))
        per[:n_burst - int(per.sum())] += 1
        t_b, k_b = [], []
        for b in range(self.n_bursts):
            nb = int(per[b])
            if nb == 0:
                continue
            hot = rng.choice(np.arange(self.n_keys // 2, self.n_keys),
                             self.hot_per_burst, replace=False)
            t_b.append(rng.uniform(starts[b], starts[b] +
                                   self.burst_duration, nb))
            k_b.append(rng.choice(hot, nb))
        t_burst = (np.concatenate(t_b) if t_b
                   else np.empty(0, np.float64))
        k_burst = (np.concatenate(k_b) if k_b
                   else np.empty(0, np.int64))

        times = np.concatenate([t_base, t_burst])
        keys = np.concatenate([k_base, k_burst]).astype(np.int64)
        mask = np.zeros(times.shape[0], bool)
        mask[n_base:] = True
        order = np.argsort(times, kind="stable")
        tok = _tokens_per_key(rng, self.n_keys)
        keys = keys[order]
        return ServingWorkload(
            times=times[order].astype(np.float64), keys=keys,
            n_tokens=tok[keys].astype(np.int32), burst_mask=mask[order],
            latency_scale=_identity_scale,
            rate_fn=lambda t: self.rate,    # nominal base rate
            name="flash_crowd", spec=self)


@dataclasses.dataclass(frozen=True)
class ZipfDriftSpec:
    """Poisson arrivals whose popularity skew drifts monotonically from
    ``alpha_start`` to ``alpha_end`` across ``n_blocks`` equal request
    blocks (piecewise-constant alpha; the schedule is exposed via
    :meth:`alpha_schedule` and is monotone by construction)."""

    n_requests: int = 20_000
    n_keys: int = 2_000
    alpha_start: float = 0.5
    alpha_end: float = 1.3
    rate: float = 2_000.0
    n_blocks: int = 16

    def alpha_schedule(self) -> np.ndarray:
        return np.linspace(self.alpha_start, self.alpha_end, self.n_blocks)

    def generate(self, seed: int = 0) -> ServingWorkload:
        rng = np.random.default_rng(seed)
        times = np.cumsum(rng.exponential(1.0 / self.rate, self.n_requests))
        bounds = np.linspace(0, self.n_requests, self.n_blocks + 1,
                             dtype=np.int64)
        keys = np.empty(self.n_requests, np.int64)
        for b, alpha in enumerate(self.alpha_schedule()):
            lo, hi = int(bounds[b]), int(bounds[b + 1])
            if hi > lo:
                keys[lo:hi] = rng.choice(
                    self.n_keys, hi - lo, p=_zipf_probs(self.n_keys, alpha))
        tok = _tokens_per_key(rng, self.n_keys)
        return ServingWorkload(
            times=times.astype(np.float64), keys=keys,
            n_tokens=tok[keys].astype(np.int32),
            burst_mask=np.zeros(self.n_requests, bool),
            latency_scale=_identity_scale, rate_fn=lambda t: self.rate,
            name="zipf_drift", spec=self)


@dataclasses.dataclass(frozen=True)
class BrownoutSpec:
    """Stationary Poisson arrivals with correlated fetch latencies: inside
    each brownout episode the origin's miss latency is multiplied by
    ``severity`` (piecewise-constant), modeling an origin/backend
    degradation that makes *concurrent* misses slow together — the regime
    where delayed-hit queues compound and hedging is supposed to pay.

    ``episodes`` are ``(start_frac, duration_frac)`` pairs relative to the
    trace duration; the realized window times are resolved at generation
    and baked into the ``latency_scale`` closure."""

    n_requests: int = 20_000
    n_keys: int = 2_000
    zipf_alpha: float = 0.9
    rate: float = 2_000.0
    severity: float = 4.0
    episodes: tuple = ((0.3, 0.1), (0.7, 0.15))

    def generate(self, seed: int = 0) -> ServingWorkload:
        if self.severity <= 0.0:
            raise ValueError("severity must be positive")
        rng = np.random.default_rng(seed)
        times = np.cumsum(rng.exponential(1.0 / self.rate, self.n_requests))
        keys = rng.choice(self.n_keys, self.n_requests,
                          p=_zipf_probs(self.n_keys, self.zipf_alpha))
        tok = _tokens_per_key(rng, self.n_keys)
        duration = float(times[-1])
        windows = tuple((s * duration, (s + d) * duration)
                        for s, d in self.episodes)
        severity = self.severity

        def latency_scale(t: float) -> float:
            for lo, hi in windows:
                if lo <= t < hi:
                    return severity
            return 1.0

        return ServingWorkload(
            times=times.astype(np.float64), keys=keys.astype(np.int64),
            n_tokens=tok[keys].astype(np.int32),
            burst_mask=np.zeros(self.n_requests, bool),
            latency_scale=latency_scale, rate_fn=lambda t: self.rate,
            name="brownout", spec=self)


def _piecewise_scale(windows: tuple, severity: float):
    """t -> severity inside any window, else 1.0 (bound early, no late
    closure capture)."""
    def scale(t: float) -> float:
        for lo, hi in windows:
            if lo <= t < hi:
                return severity
        return 1.0
    return scale


@dataclasses.dataclass(frozen=True)
class OutageSpec:
    """Stationary Poisson arrivals with scheduled **replica outages**: in
    each of ``n_outages`` windows one of ``n_replicas`` origins is hard
    down — fetches routed to it fail fast instead of completing.  The
    realized windows are exposed as ``outages = (replica, t0, t1)``
    tuples for the engine's :class:`~repro_torch.serving.faults.FaultPlan`;
    with retries walking the replica ring, the outage costs a detection
    delay plus backoff, not an unbounded stall.

    Windows are placed in disjoint slots across the middle of the trace
    (warmup and tail stay clean), one replica drawn per window."""

    n_requests: int = 20_000
    n_keys: int = 2_000
    zipf_alpha: float = 0.9
    rate: float = 2_000.0
    n_replicas: int = 3
    n_outages: int = 2
    outage_frac: float = 0.12       # duration of each outage / horizon

    def generate(self, seed: int = 0) -> ServingWorkload:
        if self.n_replicas < 2:
            raise ValueError("OutageSpec needs n_replicas >= 2 (with one "
                             "replica an outage is just a dead origin)")
        if not 0.0 < self.outage_frac * self.n_outages <= 0.75:
            raise ValueError("outage windows must fit the middle of the "
                             "trace: need 0 < n_outages * outage_frac <= 0.75")
        rng = np.random.default_rng(seed)
        times = np.cumsum(rng.exponential(1.0 / self.rate, self.n_requests))
        keys = rng.choice(self.n_keys, self.n_requests,
                          p=_zipf_probs(self.n_keys, self.zipf_alpha))
        tok = _tokens_per_key(rng, self.n_keys)
        duration = float(times[-1])
        # disjoint slots over the middle 75% of the horizon
        slot = 0.75 / self.n_outages
        outages = []
        for j in range(self.n_outages):
            lo = 0.15 + j * slot
            start = lo + rng.uniform(0.0, max(slot - self.outage_frac, 0.0))
            replica = int(rng.integers(self.n_replicas))
            outages.append((replica, start * duration,
                            (start + self.outage_frac) * duration))
        return ServingWorkload(
            times=times.astype(np.float64), keys=keys.astype(np.int64),
            n_tokens=tok[keys].astype(np.int32),
            burst_mask=np.zeros(self.n_requests, bool),
            latency_scale=_identity_scale, rate_fn=lambda t: self.rate,
            name="origin_outage", spec=self,
            n_replicas=self.n_replicas, outages=tuple(outages))


@dataclasses.dataclass(frozen=True)
class DegradedReplicaSpec:
    """The brownout scenario re-posed with replica structure: the same
    stationary arrivals and ``(start_frac, duration_frac)`` episodes as
    :class:`BrownoutSpec`, but each episode degrades exactly ONE of
    ``n_replicas`` origins (drawn per episode), exposed as per-replica
    ``replica_scales`` schedules.  With a single origin both hedge legs
    sample the same degraded origin; here the hedge leg lands on an
    *independent* replica."""

    n_requests: int = 20_000
    n_keys: int = 2_000
    zipf_alpha: float = 0.9
    rate: float = 2_000.0
    severity: float = 4.0
    episodes: tuple = ((0.3, 0.1), (0.7, 0.15))
    n_replicas: int = 3

    def generate(self, seed: int = 0) -> ServingWorkload:
        if self.severity <= 0.0:
            raise ValueError("severity must be positive")
        if self.n_replicas < 2:
            raise ValueError("DegradedReplicaSpec needs n_replicas >= 2; "
                             "use BrownoutSpec for the single-origin case")
        rng = np.random.default_rng(seed)
        times = np.cumsum(rng.exponential(1.0 / self.rate, self.n_requests))
        keys = rng.choice(self.n_keys, self.n_requests,
                          p=_zipf_probs(self.n_keys, self.zipf_alpha))
        tok = _tokens_per_key(rng, self.n_keys)
        duration = float(times[-1])
        per_replica: list[list] = [[] for _ in range(self.n_replicas)]
        for s, d in self.episodes:
            replica = int(rng.integers(self.n_replicas))
            per_replica[replica].append((s * duration, (s + d) * duration))
        scales = tuple(_piecewise_scale(tuple(w), self.severity)
                       for w in per_replica)
        return ServingWorkload(
            times=times.astype(np.float64), keys=keys.astype(np.int64),
            n_tokens=tok[keys].astype(np.int32),
            burst_mask=np.zeros(self.n_requests, bool),
            latency_scale=_identity_scale, rate_fn=lambda t: self.rate,
            name="degraded_replica", spec=self,
            n_replicas=self.n_replicas, replica_scales=scales)


SCENARIOS: dict[str, type] = {
    "diurnal": DiurnalSpec,
    "flash_crowd": FlashCrowdSpec,
    "zipf_drift": ZipfDriftSpec,
    "brownout": BrownoutSpec,
    "origin_outage": OutageSpec,
    "degraded_replica": DegradedReplicaSpec,
}


def make_scenario(name: str, seed: int = 0, **overrides) -> ServingWorkload:
    """Build a named scenario workload; ``overrides`` replace spec fields
    (e.g. ``make_scenario('diurnal', n_requests=5_000)``)."""
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"have {sorted(SCENARIOS)}")
    return SCENARIOS[name](**overrides).generate(seed=seed)
