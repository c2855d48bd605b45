"""Serving engine with a delayed-hit prefix cache (the paper, deployed).

The cache stores *prefix states* (KV pages or recurrent states) keyed by
the prompt prefix.  A request whose prefix is resident decodes at once
(hit).  A missing prefix triggers a prefill, the "fetch", whose duration is
stochastic.  Requests that arrive for a prefix being prefilled are DELAYED
HITS: they join the in-flight entry's waiters and are served when the
prefill completes, each having waited the remaining fetch time.  Eviction
ranks resident prefixes with the paper's eq. 16 (Theorem-2 moments), or
any baseline policy for A/B comparison.

This is the JAX package's ``serving/engine.py`` with the same semantics:
the same outcomes, latencies, counters and RNG streams (numpy
``default_rng``).  The event loop, the latency models, hedging, the
hierarchy mode (``l2``, ``hop_s`` a number or a callable of sim time), the
replica set with its retry chain, the fault plan and shedding are host
Python, as there.  What runs on the card is the prefix cache's rank:

- **Host, authoritative.**  :class:`DelayedHitPrefixCache` keeps the
  per-object statistics as numpy f32/bool arrays (:class:`HostStats`,
  the reference's field names) and updates them in place with the
  reference's arithmetic, so NumPy's scalar promotion gives the same f32
  bits.
- **Device mirror.**  An ``[F, N]`` f32 tensor (the fields the ranks read,
  then the rank-time sizes) and a ``[2, N]`` bool tensor (``cached``,
  ``in_flight``) on the engine's device.  The host records the objects it
  changed since the last rank; each rank first writes their current values
  into the mirror with one ``lane_scatter_batch`` call (one launch while
  the batch fits the kernel's parameter block).  Copying f32 values is
  exact, so the mirror is the host state bit for bit.
- **The rank.**  At an admission the port's substrate is built over views
  of the mirror at ``t`` rounded to f32 (the reference passes
  ``np.float32(t)``).  The eq.-16 policy with an Exponential law takes
  ``ranking_victim_order``: the scores and the ascending ``(score,
  index)`` order of the cached entries in one launch.  Every other policy
  takes its epilogue on the device and one masked stable sort.  One
  read-back brings the incoming prefix's score and the first ``top``
  victims with their scores; evict-until-fit walks that order and stops
  at the first victim that does not rank strictly below the incomer,
  which is the reference's ``min`` over ``(rank, index)`` re-taken after
  every eviction.  A walk that needs more than ``top`` victims ranks
  again with the updated mask (the scores do not depend on it).

``device=None`` means the card (:func:`repro_torch.resolve_device`);
``use_kernel`` follows :func:`repro_torch.core.resolve_score_mode`:
``"ref"`` runs the plain versions of both kernels, so it launches none,
and a CPU device runs them there.  Nothing falls back to another path when
a kernel fails to build or launch.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Any, Callable

import numpy as np
import torch

from .._device import resolve_device
from ..core.distributions import Exponential
from ..core.ranking import (POLICIES, PolicyParams, _f32,
                            epi_stochastic_vacdh, make_substrate)
from ..core.simulator import resolve_score_mode
from ..core.state import ObjStats
from ..kernels import ranking_score as _rs
from ..kernels import ref as _ref
from ..kernels.lane_scatter import lane_scatter_batch
from .faults import DegradePolicy, FaultPlan

# The f32 fields the ranks read, in the mirror's row order; the rank-time
# sizes follow as its last row.
MIRROR_F32 = ("last_access", "gap_mean", "count", "z_est", "agg_sum",
              "agg_sq_sum", "agg_cnt", "gd_h")
MIRROR_BOOL = ("cached", "in_flight")
# Victims read back per rank: the ranking kernel's sorting-network path
# covers up to 8; a walk that needs more ranks again.
EVICT_TOP = 8


@dataclasses.dataclass
class LatencyModel:
    """Stochastic prefill-latency model: Exp with mean a + b * prefix_len.

    ``scale_fn`` is the time-varying hook of the brownout scenarios: the
    mean at sim time ``t`` is multiplied by ``scale_fn(t)``, so correlated
    origin degradation slows every fetch *issued* inside the episode.  The
    hedge deadline scales the same way."""
    base_s: float = 0.050
    per_token_s: float = 2e-5
    stochastic: bool = True
    hedge_quantile: float = 0.95
    scale_fn: Callable[[float], float] | None = None

    def mean(self, n_tokens: int, t: float | None = None) -> float:
        m = self.base_s + self.per_token_s * n_tokens
        if self.scale_fn is not None and t is not None:
            m *= self.scale_fn(t)
        return m

    def draw(self, rng: np.random.Generator, n_tokens: int,
             t: float | None = None) -> float:
        m = self.mean(n_tokens, t)
        return float(rng.exponential(m)) if self.stochastic else m

    def quantile_s(self, q: float, n_tokens: int,
                   t: float | None = None) -> float:
        """Exp quantile of the (scaled) latency at issue time t:
        -m * ln(1 - q).  Hedge deadlines and fault-plan timeouts both
        derive from it."""
        return -self.mean(n_tokens, t) * float(np.log(1 - q))

    def hedge_deadline(self, n_tokens: int, t: float | None = None) -> float:
        return self.quantile_s(self.hedge_quantile, n_tokens, t)


class ReplicaSet:
    """N independent origin replicas.

    Each replica owns a :class:`LatencyModel` (its health: a per-replica
    ``scale_fn``) and an RNG stream spawned from ``(seed, replica_idx)``,
    so one replica's draws never perturb another's.  Primary selection
    rotates round-robin per miss episode; retries walk the ring; the hedge
    leg always goes to the next *different* replica."""

    def __init__(self, models, seed: int = 0):
        self.models: tuple[LatencyModel, ...] = tuple(models)
        if not self.models:
            raise ValueError("ReplicaSet needs at least one replica")
        self.seed = seed
        self.rngs = [np.random.default_rng([seed, r])
                     for r in range(len(self.models))]

    @classmethod
    def uniform(cls, n: int, latency: LatencyModel, scale_fns=None,
                seed: int = 0) -> "ReplicaSet":
        """n replicas sharing ``latency``'s parameters, each optionally
        with its own health schedule ``scale_fns[r]``."""
        if scale_fns is not None and len(scale_fns) != n:
            raise ValueError("need one scale_fn per replica")
        return cls((dataclasses.replace(
            latency, scale_fn=scale_fns[r] if scale_fns else latency.scale_fn)
            for r in range(n)), seed=seed)

    @property
    def n(self) -> int:
        return len(self.models)

    def model(self, r: int) -> LatencyModel:
        return self.models[r]

    def rng(self, r: int) -> np.random.Generator:
        return self.rngs[r]


@dataclasses.dataclass
class PrefixEntry:
    key: str
    n_tokens: int
    size: float                   # cache units (KV bytes or state bytes)
    state: Any = None             # what prefill_fn returned (real engine)
    complete_t: float = np.inf    # in-flight completion time (sim clock)
    issue_t: float = 0.0
    waiters: int = 0
    failed: bool = False          # retry chain exhausted: resolves, not admits


@dataclasses.dataclass
class EngineStats:
    hits: int = 0
    delayed_hits: int = 0
    misses: int = 0
    evictions: int = 0
    hedges: int = 0
    total_latency: float = 0.0
    prefill_tokens: int = 0
    shed: int = 0                 # requests refused by the DegradePolicy
    failed: int = 0               # requests resolved by a failed fetch
    retries: int = 0              # retry attempts actually issued
    timeouts: int = 0             # attempts abandoned at the client timeout
    fault_failures: int = 0       # attempts killed by outage/injected fault
    gaveup: int = 0               # fetch episodes that exhausted retries

    def as_dict(self) -> dict:
        n = max(self.hits + self.delayed_hits + self.misses, 1)
        return dict(hits=self.hits, delayed_hits=self.delayed_hits,
                    misses=self.misses, evictions=self.evictions,
                    hedges=self.hedges, total_latency=self.total_latency,
                    mean_latency=self.total_latency / n,
                    shed=self.shed, failed=self.failed,
                    retries=self.retries, timeouts=self.timeouts,
                    fault_failures=self.fault_failures, gaveup=self.gaveup)


@dataclasses.dataclass
class HostStats:
    """Per-object statistics of the prefix cache as numpy ``[N]`` arrays,
    with the field names of :class:`repro_torch.core.state.ObjStats`."""

    cached: np.ndarray
    in_flight: np.ndarray
    complete_t: np.ndarray
    issue_t: np.ndarray
    last_access: np.ndarray
    first_access: np.ndarray
    gap_mean: np.ndarray
    count: np.ndarray
    z_est: np.ndarray
    agg_sum: np.ndarray
    agg_sq_sum: np.ndarray
    agg_cnt: np.ndarray
    episode_delay: np.ndarray
    gd_h: np.ndarray


class DelayedHitPrefixCache:
    """The paper's policy over prefix states, with online statistics.

    The statistics (lambda from the inter-arrival EWMA, z from observed
    prefill times, R from recency) are those of ``core/ranking.py``; the
    ranks run on the device over a mirror of them (module doc).
    ``counters`` counts ``admits``, ``ranks``, ``syncs`` (read-backs),
    ``flushes`` (mirror writes) and ``flushed`` (objects written)."""

    def __init__(self, capacity: float, policy: str = "stoch_vacdh",
                 params: PolicyParams | None = None, max_objects: int = 4096,
                 *, device=None, use_kernel=None):
        self.capacity = capacity
        self.free = capacity
        self.policy = POLICIES[policy]
        self.params = params or PolicyParams()
        self.n = max_objects
        self.key_to_idx: dict[str, int] = {}
        self.entries: dict[int, PrefixEntry] = {}
        self.free_idx = list(range(max_objects))
        # rank-time sizes: resident entries carry their true size,
        # everything else 1.0
        self._sizes = np.ones(max_objects, np.float32)
        f = lambda v: np.full(max_objects, v, np.float32)
        self.obj = HostStats(
            cached=np.zeros(max_objects, bool),
            in_flight=np.zeros(max_objects, bool),
            complete_t=f(np.inf), issue_t=f(0.0),
            last_access=f(-np.inf), first_access=f(-np.inf),
            gap_mean=f(0.0), count=f(0.0), z_est=f(0.05),
            agg_sum=f(0.0), agg_sq_sum=f(0.0), agg_cnt=f(0.0),
            episode_delay=f(0.0), gd_h=f(0.0))

        self.dev = resolve_device(device)
        self.mode = resolve_score_mode(use_kernel, self.dev)
        self._write = (_ref.lane_scatter_batch_ref if self.mode == "ref"
                       else lane_scatter_batch)
        self.kernelable = (self.mode != "rank"
                           and self.policy.epilogue is epi_stochastic_vacdh
                           and isinstance(self.params.dist, Exponential))
        self.top = min(EVICT_TOP, max_objects)
        o = self.obj
        self.mirror_f = torch.from_numpy(np.stack(
            [getattr(o, k) for k in MIRROR_F32] + [self._sizes])).to(self.dev)
        self.mirror_b = torch.from_numpy(np.stack(
            [getattr(o, k) for k in MIRROR_BOOL])).to(self.dev)
        views = {k: self.mirror_f[r] for r, k in enumerate(MIRROR_F32)}
        views.update({k: self.mirror_b[r] for r, k in enumerate(MIRROR_BOOL)})
        self._mobj = ObjStats(complete_t=None, issue_t=None,
                              first_access=None, episode_delay=None, **views)
        self._msizes = self.mirror_f[len(MIRROR_F32)]
        self._dirty: set[int] = set()
        self.counters = dict(admits=0, ranks=0, syncs=0, flushes=0,
                             flushed=0)

    @property
    def mirror_bytes(self) -> int:
        return (self.mirror_f.numel() * self.mirror_f.element_size()
                + self.mirror_b.numel() * self.mirror_b.element_size())

    def idx(self, key: str) -> int:
        if key not in self.key_to_idx:
            if not self.free_idx:
                i = self._reclaim()
                if i is None:
                    raise RuntimeError(
                        "prefix table full (every slot cached or in flight)")
                self.key_to_idx[key] = i
            else:
                self.key_to_idx[key] = self.free_idx.pop()
        return self.key_to_idx[key]

    def _reclaim(self) -> int | None:
        """Reclaim the stalest *dead* slot: a key that is tracked but
        neither cached nor in flight.  Returns None only when every slot
        is live."""
        o = self.obj
        victim_key, victim_i, victim_t = None, None, math.inf
        for k, i in self.key_to_idx.items():
            if not o.cached[i] and not o.in_flight[i] \
                    and o.last_access[i] < victim_t:
                victim_key, victim_i, victim_t = k, i, float(o.last_access[i])
        if victim_key is None:
            return None
        del self.key_to_idx[victim_key]
        self._reset_slot(victim_i)
        return victim_i

    def _reset_slot(self, i: int) -> None:
        """Restore slot ``i`` to its initial state."""
        o = self.obj
        o.cached[i] = False
        o.in_flight[i] = False
        o.complete_t[i] = np.inf
        o.issue_t[i] = 0.0
        o.last_access[i] = -np.inf
        o.first_access[i] = -np.inf
        o.gap_mean[i] = 0.0
        o.count[i] = 0.0
        o.z_est[i] = 0.05
        o.agg_sum[i] = 0.0
        o.agg_sq_sum[i] = 0.0
        o.agg_cnt[i] = 0.0
        o.episode_delay[i] = 0.0
        o.gd_h[i] = 0.0
        self._sizes[i] = 1.0
        self._dirty.add(i)

    def touch(self, key: str, t: float) -> int:
        i = self.idx(key)
        o = self.obj
        cnt = o.count[i]
        gap = np.float32(t) - o.last_access[i]
        if cnt == 1.0:
            o.gap_mean[i] = gap
        elif cnt > 1.0:
            a = max(1.0 / self.params.window, 1.0 / max(cnt, 1.0))
            o.gap_mean[i] = o.gap_mean[i] + a * (gap - o.gap_mean[i])
        if cnt == 0.0:
            o.first_access[i] = t
        o.last_access[i] = t
        o.count[i] = cnt + 1.0
        # the caller goes on to change i's flags and episode fields; the
        # next rank's flush reads them then
        self._dirty.add(i)
        return i

    # --- the device mirror and the rank ----------------------------------
    def flush(self) -> int:
        """Write every object changed since the last flush into the
        mirror: one ``lane_scatter_batch`` call.  Returns their number."""
        if not self._dirty:
            return 0
        ids = np.fromiter(self._dirty, np.int64, len(self._dirty))
        self._dirty.clear()
        o = self.obj
        vf = np.stack([getattr(o, k)[ids] for k in MIRROR_F32]
                      + [self._sizes[ids]])
        vb = np.stack([getattr(o, k)[ids] for k in MIRROR_BOOL])
        writes = []
        for c, i in enumerate(ids.tolist()):
            writes.append((self.mirror_f, np.full(len(vf), i, np.int32),
                           vf[:, c], None, False))
            writes.append((self.mirror_b, np.full(len(vb), i, np.int32),
                           vb[:, c], None, False))
        self._write(writes)
        self.counters["flushes"] += 1
        self.counters["flushed"] += len(ids)
        return len(ids)

    def ranks(self, t: float):
        """Flush the mirror, then rank every object at ``t`` (rounded to
        f32) on the device: ``(scores f32[N], idx i32[top], vals
        f32[top])``, the victim order being the ``top`` lowest-scored
        cached objects in ascending ``(score, index)`` order, continued
        by +inf for uncached ones.  (Eq.-16 scores at or above 3.4e38
        count as +inf in the kernel's order; the engine's never come
        near.)"""
        self.flush()
        self.counters["ranks"] += 1
        sub = make_substrate(self._mobj, self._msizes,
                             float(np.float32(t)), self.params)
        if self.kernelable:
            args = (sub.lam, sub.z_est, sub.resid, self._msizes,
                    self._mobj.cached)
            omega = _f32(self.params.omega)
            if self.mode == "kernel":
                return _rs.ranking_victim_order(*args, omega=omega,
                                                top=self.top)
            return _ref.ranking_victim_order_ref(*args, omega, self.top)
        r = self.policy.epilogue(sub, self.params)
        return (r, *_ref.victim_order_ref(r, self._mobj.cached, self.top))

    def _victims(self, t: float, i: int):
        """``ranks(t)`` read back in one copy: the score of object ``i``
        and the victim order's indices and scores (host arrays)."""
        r, idx, vals = self.ranks(t)
        out = torch.cat([r[i:i + 1].view(torch.int32),
                         vals.view(torch.int32), idx.to(torch.int32)])
        out = out.cpu().numpy()
        self.counters["syncs"] += 1
        k = vals.shape[0]
        return out[:1].view(np.float32)[0], out[1 + k:], \
            out[1:1 + k].view(np.float32)

    def admit(self, entry: PrefixEntry, t: float,
              stats: EngineStats) -> bool:
        """Evict-until-fit with the paper's strict-rank rule (§2.2)."""
        i = self.idx(entry.key)
        o = self.obj
        # close the miss episode
        ep = o.episode_delay[i]
        o.agg_sum[i] += ep
        o.agg_sq_sum[i] += ep * ep
        o.agg_cnt[i] += 1.0
        o.episode_delay[i] = 0.0
        o.in_flight[i] = False
        realized = t - o.issue_t[i]
        o.z_est[i] = 0.7 * o.z_est[i] + 0.3 * realized
        self._dirty.add(i)
        self.counters["admits"] += 1
        rank_i, order, vals = self._victims(t, i)
        pos = 0
        ok = True
        while ok and self.free < entry.size:
            if pos == len(order):
                # more victims than one read-back holds: rank again with
                # the evictions in the mask (the scores are unchanged)
                _, order, vals = self._victims(t, i)
                pos = 0
            v, rv = int(order[pos]), vals[pos]
            pos += 1
            if not o.cached[v]:          # no cached candidate is left
                ok = False
                break
            if rv < rank_i:
                self.evict(v)
                stats.evictions += 1
            else:
                ok = False
        if ok and self.free >= entry.size:
            o.cached[i] = True
            self.entries[i] = entry
            self._sizes[i] = entry.size
            self.free -= entry.size
            self._dirty.add(i)
            return True
        return False

    def fail_close(self, i: int, t: float) -> None:
        """Close a *failed* fetch episode (retry chain exhausted): fold the
        waiters' accumulated delay into the episode aggregates without
        admitting and without a z_est update."""
        o = self.obj
        ep = o.episode_delay[i]
        o.agg_sum[i] += ep
        o.agg_sq_sum[i] += ep * ep
        o.agg_cnt[i] += 1.0
        o.episode_delay[i] = 0.0
        o.in_flight[i] = False
        self._dirty.add(i)

    def evict(self, i: int) -> None:
        e = self.entries.pop(i)
        self.obj.cached[i] = False
        self.free += e.size
        self._sizes[i] = 1.0
        del self.key_to_idx[e.key]
        self.free_idx.append(i)
        self._dirty.add(i)


class ServeEngine:
    """Event-driven serving loop over the delayed-hit prefix cache.

    ``device`` and ``use_kernel`` go to the cache (module doc); the rest
    is the reference's.  An ``l2`` engine keeps its own
    cache and mirror."""

    def __init__(self, *, capacity: float, policy: str = "stoch_vacdh",
                 latency: LatencyModel | None = None,
                 params: PolicyParams | None = None,
                 prefill_fn: Callable | None = None,
                 state_size_fn: Callable[[int], float] | None = None,
                 hedging: bool = True, seed: int = 0,
                 l2: "ServeEngine | None" = None,
                 hop_s: "float | Callable[[float], float]" = 0.0,
                 replicas: ReplicaSet | None = None,
                 faults: FaultPlan | None = None,
                 degrade: DegradePolicy | None = None,
                 max_objects: int = 4096, device=None, use_kernel=None):
        self.cache = DelayedHitPrefixCache(
            capacity, policy, params, max_objects=max_objects, device=device,
            use_kernel=use_kernel)
        self.latency = latency or LatencyModel()
        self.prefill_fn = prefill_fn           # real-model hook (optional)
        self.state_size = state_size_fn or (lambda n_tok: float(n_tok))
        self.hedging = hedging
        self.l2 = l2                # shared second tier (hierarchy mode)
        self.hop_s = hop_s          # round-trip L1<->L2 hop delay
        self.replicas = replicas    # independent origins
        self.faults = faults        # deterministic fault-injection plan
        self.degrade = degrade      # overload shedding bounds
        self.rng = np.random.default_rng(seed)
        self.stats = EngineStats()
        self.events: list[tuple[float, int, str]] = []   # (t, seq, key)
        self.pending: dict[str, PrefixEntry] = {}
        self._seq = 0
        self._rr = 0                # round-robin primary-replica cursor
        self._fault_ctr = 0         # fault-plan decision counter
        self._retry_tokens = (faults.retry_budget
                              if faults is not None else None)

    # --- event machinery (sim clock) -----------------------------------
    def _commit_due(self, t: float) -> None:
        while self.events and self.events[0][0] <= t:
            t_c, _, key = heapq.heappop(self.events)
            e = self.pending.get(key)
            if e is None or t_c != e.complete_t:
                # stale (hedged duplicate lost, or the key re-missed and a
                # newer fetch owns the entry): drop the EVENT only
                continue
            del self.pending[key]
            if e.failed:
                # retry chain exhausted: close the episode, never admit
                self.cache.fail_close(self.cache.key_to_idx[key], t_c)
                continue
            if self.prefill_fn is not None:
                e.state = self.prefill_fn(key, e.n_tokens)
            self.cache.admit(e, t_c, self.stats)

    # --- fault-tolerant fetch resolution --------------------------------
    def _origin(self, r: int) -> tuple[LatencyModel, np.random.Generator]:
        if self.replicas is None:
            return self.latency, self.rng
        return self.replicas.model(r), self.replicas.rng(r)

    def _resolve_fetch(self, t: float, n_tokens: int) -> tuple[float, bool]:
        """Resolve a miss's full retry chain at issue time; returns
        ``(resolution_time, ok)``.

        Attempt k runs on replica ``(primary + k) % R`` (the primary
        rotates per episode): the primary leg is drawn from that replica's
        model and RNG, the fault plan is overlaid (outage: fail fast;
        injected failure: the leg dies at ``u * z``), a hedge leg goes to
        the next *different* replica if the primary is unresolved at the
        hedge deadline, and the attempt times out at the plan's deadline.
        Failed attempts retry after capped exponential backoff while the
        budget lasts.  Deadlines are the client's beliefs (the engine's
        own ``latency`` model); draws are the replica's truth."""
        plan = self.faults
        n_rep = 1 if self.replicas is None else self.replicas.n
        primary = self._rr % n_rep
        self._rr += 1
        max_attempts = 1 + (plan.max_retries if plan is not None else 0)
        a = t
        for k in range(max_attempts):
            r = (primary + k) % n_rep
            model, rng = self._origin(r)
            z = model.draw(rng, n_tokens, a)
            # primary-leg fault overlay
            fail_rel, fail_kind = math.inf, None
            if plan is not None:
                if plan.in_outage(r, a):
                    fail_rel, fail_kind = plan.outage_detect_s, "fault"
                elif plan.fail_prob > 0.0:
                    self._fault_ctr += 1
                    if plan.u01(self._fault_ctr) < plan.fail_prob:
                        self._fault_ctr += 1
                        # the fetch dies partway through: u*z < z always
                        fail_rel = plan.u01(self._fault_ctr) * z
                        fail_kind = "fault"
            primary_ok = fail_kind is None
            primary_end = z if primary_ok else fail_rel
            legs = [(primary_end, primary_ok)]
            # hedge leg: fires iff the primary is still unresolved at the
            # deadline; always to a different replica when one exists
            if self.hedging:
                deadline = self.latency.hedge_deadline(n_tokens, a)
                if primary_end > deadline:
                    r2 = (r + 1) % n_rep if n_rep > 1 else r
                    m2, rng2 = self._origin(r2)
                    if plan is not None and plan.in_outage(r2, a + deadline):
                        legs.append((deadline + plan.outage_detect_s, False))
                    else:
                        z2 = m2.draw(rng2, n_tokens, a + deadline)
                        legs.append((deadline + z2, True))
                    self.stats.hedges += 1
            tmo = (plan.timeout_s(self.latency.mean(n_tokens, a))
                   if plan is not None else math.inf)
            success_rel = min((e for e, ok in legs if ok), default=math.inf)
            if success_rel <= tmo and success_rel < math.inf:
                return a + success_rel, True
            # attempt failed: at the timeout if a leg was still pending,
            # else when the last leg died
            if success_rel < math.inf or tmo < max(
                    (e for e, ok in legs if not ok), default=0.0):
                end_rel, kind = tmo, "timeout"
            else:
                end_rel = max(e for e, ok in legs if not ok)
                kind = fail_kind or "fault"
            if kind == "timeout":
                self.stats.timeouts += 1
            else:
                self.stats.fault_failures += 1
            fail_t = a + end_rel
            if k + 1 >= max_attempts:
                break
            if self._retry_tokens is not None:
                if self._retry_tokens <= 0:
                    break
                self._retry_tokens -= 1
            self.stats.retries += 1
            self._fault_ctr += 1
            a = fail_t + plan.backoff_s(k, plan.u01(self._fault_ctr))
        self.stats.gaveup += 1
        return fail_t, False

    # --- request path ---------------------------------------------------
    def serve(self, t: float, prefix_key: str,
              n_tokens: int) -> tuple[str, float]:
        """Serve a request at sim time t; returns ``(outcome, latency)``.

        Outcome is one of ``hit`` / ``delayed`` / ``miss`` / ``shed`` /
        ``failed``: ``shed`` means the DegradePolicy refused the request
        (latency 0; report the shed *rate*); ``failed`` means the request's
        fetch episode exhausted its retry chain (the latency is the time
        until the client learned of the failure)."""
        self._commit_due(t)
        c = self.cache
        i = c.touch(prefix_key, t)
        o = c.obj
        if o.cached[i]:
            self.stats.hits += 1
            return "hit", 0.0
        if o.in_flight[i]:
            e = self.pending[prefix_key]
            if self.degrade is not None \
                    and e.waiters + 1 > self.degrade.max_waiters:
                self.stats.shed += 1
                return "shed", 0.0
            lat = max(float(o.complete_t[i]) - t, 0.0)
            o.episode_delay[i] += lat
            self.stats.delayed_hits += 1
            e.waiters += 1
            self.stats.total_latency += lat
            if e.failed:
                self.stats.failed += 1
                return "failed", lat
            return "delayed", lat
        # miss: issue the prefill "fetch"; in hierarchy mode its duration
        # is hop + the shared L2's resolution time
        if self.degrade is not None \
                and len(self.pending) >= self.degrade.max_in_flight:
            self.stats.shed += 1
            return "shed", 0.0
        ok = True
        loser_comp = None
        if self.l2 is not None:
            hop = self.hop_s(t) if callable(self.hop_s) else self.hop_s
            z = hop + self.l2.request(t, prefix_key, n_tokens)
        elif self.replicas is not None or self.faults is not None:
            comp_t, ok = self._resolve_fetch(t, n_tokens)
            z = comp_t - t
        else:
            z = self.latency.draw(self.rng, n_tokens, t)
            if self.hedging:
                deadline = self.latency.hedge_deadline(n_tokens, t)
                if z > deadline:
                    z2 = self.latency.draw(self.rng, n_tokens, t)
                    z_h = deadline + z2
                    # both copies race; the served latency is the winner
                    # min(Z1, t_hedge + Z2') and the loser's completion
                    # event stays queued, dropped as stale
                    loser_comp = t + max(z, z_h)
                    if z_h < z:
                        z = z_h
                    self.stats.hedges += 1
        comp = t + z
        o.in_flight[i] = True
        o.complete_t[i] = comp
        o.issue_t[i] = t
        o.episode_delay[i] = z
        entry = PrefixEntry(prefix_key, n_tokens,
                            self.state_size(n_tokens), complete_t=comp,
                            issue_t=t, failed=not ok)
        self.pending[prefix_key] = entry
        self._seq += 1
        heapq.heappush(self.events, (comp, self._seq, prefix_key))
        if loser_comp is not None and loser_comp > comp:
            self._seq += 1
            heapq.heappush(self.events, (loser_comp, self._seq, prefix_key))
        self.stats.misses += 1
        self.stats.total_latency += z
        if not ok:
            self.stats.failed += 1
            return "failed", z
        self.stats.prefill_tokens += n_tokens
        return "miss", z

    def request(self, t: float, prefix_key: str, n_tokens: int) -> float:
        """Serve a request at sim time t; returns its queueing latency."""
        return self.serve(t, prefix_key, n_tokens)[1]

    def run_trace(self, times, keys, lengths) -> EngineStats:
        for t, k, n in zip(times, keys, lengths):
            self.request(float(t), str(k), int(n))
        return self.stats
