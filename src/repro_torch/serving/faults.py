"""Deterministic fault-injection plans for the serving engine.

A copy of the JAX package's ``serving/faults.py`` (pure Python there too).
The fault model beyond the paper's stochastic fetch latency: fetch
**failures** (a prefill dies partway through), fetch **timeouts** (the
client abandons an attempt at a quantile-derived deadline), and **replica
outages** (an origin is down for a scheduled window and attempts against
it fail fast).

Everything here is a pure function of ``(seed, plan)``:

* Per-decision randomness comes from a counter-keyed splitmix64 hash
  (:meth:`FaultPlan.u01`), not from a shared stateful RNG: the engine
  passes a monotonically increasing decision counter, so the fault stream
  is reproducible bit for bit however many latency draws the replicas
  consumed in between.
* Outage windows are static data resolved at plan construction (the
  scenario generators bake realized times in, see
  :class:`repro_torch.data.scenarios.OutageSpec`).

:class:`DegradePolicy` is the graceful-degradation side: bounds on the
per-entry waiter-queue depth and on the number of concurrent in-flight
fetch episodes past which the engine *sheds* a request (a recorded
``shed`` outcome) instead of queueing it without bound.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["FaultPlan", "DegradePolicy", "splitmix64"]

_MASK = (1 << 64) - 1


def splitmix64(x: int) -> int:
    """One splitmix64 step: cheap, stateless, and full-period."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return (z ^ (z >> 31)) & _MASK


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, schedulable fault-injection plan.

    seed             keys the counter-hashed decision stream (u01)
    fail_prob        per-attempt probability the primary fetch leg dies
                     partway through (the failure manifests at ``u * z``
                     into the attempt, ``u`` ~ plan-uniform)
    outages          ``(replica, t0, t1)`` windows: attempts *issued* to
                     ``replica`` with t0 <= t < t1 fail fast after
                     ``outage_detect_s`` (connection refused, not a hang)
    outage_detect_s  fast-failure detection delay for outage attempts
    timeout_quantile per-attempt client timeout at this quantile of the
                     issuing replica's latency model (None disables);
                     must exceed the hedge quantile or every hedged fetch
                     would be killed before its hedge could win
    max_retries      retry cap per fetch episode (attempts = 1 + retries)
    backoff_base_s   capped exponential backoff: retry k waits
                     ``min(base * 2^k, cap) * (0.5 + 0.5 * u)`` with
                     deterministic jitter ``u``
    backoff_cap_s    the backoff cap
    retry_budget     global retry-token pool per engine (None = unlimited);
                     once spent, a failed attempt resolves the episode as
                     a failure instead of retrying
    """

    seed: int = 0
    fail_prob: float = 0.0
    outages: tuple = ()
    outage_detect_s: float = 0.002
    timeout_quantile: float | None = 0.995
    max_retries: int = 3
    backoff_base_s: float = 0.010
    backoff_cap_s: float = 0.160
    retry_budget: int | None = None

    def __post_init__(self):
        if not 0.0 <= self.fail_prob < 1.0:
            raise ValueError("fail_prob must be in [0, 1)")
        if self.timeout_quantile is not None \
                and not 0.0 < self.timeout_quantile < 1.0:
            raise ValueError("timeout_quantile must be in (0, 1) or None")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        for w in self.outages:
            r, t0, t1 = w
            if t1 <= t0 or r < 0:
                raise ValueError(f"malformed outage window {w!r}")

    # --- deterministic decision stream ---------------------------------
    def u01(self, ctr: int) -> float:
        """Uniform (0,1) keyed on (seed, ctr): decision ``ctr`` of a run
        is the same float no matter what happened in between."""
        h = splitmix64(splitmix64(self.seed & _MASK) ^ (ctr & _MASK))
        return ((h >> 11) + 1) * (2.0 ** -53)

    def in_outage(self, replica: int, t: float) -> bool:
        for r, t0, t1 in self.outages:
            if r == replica and t0 <= t < t1:
                return True
        return False

    def backoff_s(self, retry_idx: int, u: float) -> float:
        """Capped exponential backoff with deterministic jitter in
        [0.5, 1.0) of the capped value — never zero, never above cap."""
        base = min(self.backoff_base_s * (2.0 ** retry_idx),
                   self.backoff_cap_s)
        return base * (0.5 + 0.5 * u)

    def timeout_s(self, mean_s: float) -> float:
        """Client timeout for an attempt whose (scaled) exponential mean
        is ``mean_s`` — the model-quantile rule."""
        if self.timeout_quantile is None:
            return math.inf
        return -mean_s * math.log(1.0 - self.timeout_quantile)


@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """Admission-control bounds for graceful degradation under overload.

    max_waiters     a delayed hit that would make an entry's waiter queue
                    exceed this depth is shed instead
    max_in_flight   a miss that would push the number of concurrent
                    in-flight fetch episodes past this bound is shed
    """

    max_waiters: int = 64
    max_in_flight: int = 512

    def __post_init__(self):
        if self.max_waiters < 1 or self.max_in_flight < 1:
            raise ValueError("degrade bounds must be >= 1")
