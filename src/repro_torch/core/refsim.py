"""Event-driven reference simulators (numpy, heap-based).

The oracle of :mod:`repro_torch.core.simulator` and
:mod:`repro_torch.core.hierarchy`: classic discrete-event loops with
explicit completion-event heaps, in the JAX package's ``core/refsim.py``
arithmetic (numpy f32 state, f64 event times and latency sums).  They rank
through the port's :mod:`repro_torch.core.ranking` on CPU tensors that
share the numpy state's memory, so a disagreement with the engines is a
fault of semantics, not of formulas.  Only tests use them (tiny traces).

:class:`_RefCache` is one delayed-hit cache tier; :func:`simulate_ref` runs
one tier over a trace, :func:`simulate_ref_stream` over chunks, and
:func:`simulate_hier_ref` composes one instance per L1 shard with a shared
L2 instance.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from .ranking import POLICIES, PolicyParams, agg_mean_hat, lambda_hat
from .state import ObjStats


def _np(x, dtype) -> np.ndarray:
    """A tensor or array-like as a host array of ``dtype``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


class _RefCache:
    """One delayed-hit cache tier of the event-driven reference: the
    per-object statistics (numpy arrays, with CPU-tensor views for the
    ranking), the free-capacity accounting, the completion-event heap and
    the outcome counters.  ``serve`` takes the fetch time of the miss case
    as an argument; in the hierarchy it is ``hop + R_L2(t)``."""

    def __init__(self, n: int, capacity: float, policy_name: str,
                 params: PolicyParams | None, z_prior, estimate_z: bool):
        self.p = params or PolicyParams()
        self.policy = POLICIES[policy_name]
        if self.policy.admission != "always":
            raise NotImplementedError("refsim only covers coin-free policies")
        self.estimate_z = estimate_z
        f = lambda v: np.full(n, v, np.float32)
        self.o = ObjStats(
            cached=np.zeros(n, bool), in_flight=np.zeros(n, bool),
            complete_t=f(np.inf), issue_t=f(0.0),
            last_access=f(-np.inf), first_access=f(-np.inf),
            gap_mean=f(0.0), count=f(0.0),
            z_est=np.broadcast_to(np.asarray(z_prior, np.float32),
                                  (n,)).copy(),
            agg_sum=f(0.0), agg_sq_sum=f(0.0), agg_cnt=f(0.0),
            episode_delay=f(0.0), gd_h=f(0.0),
        )
        # the same memory as CPU tensors, for the ranking functions
        self.ot = ObjStats(**{k.name: torch.from_numpy(getattr(self.o,
                                                               k.name))
                              for k in dataclasses.fields(ObjStats)})
        self.sizes = None            # set by bind_sizes before use
        self.free = np.float32(capacity)
        self.gd_clock = np.float32(0.0)
        self.heap: list[tuple[float, int]] = []   # (complete_t, obj)
        self.total = 0.0
        self.hits = self.delayed = self.misses = self.evictions = 0

    def bind_sizes(self, sizes) -> None:
        self.sizes = np.array(sizes, np.float32)
        self.sizes_t = torch.from_numpy(self.sizes)

    def _gd_cost(self):
        cost = agg_mean_hat(self.ot).numpy()
        if self.policy.gd_cost == "agg_rate":
            cost = cost * lambda_hat(self.ot, self.p).numpy()
        return cost / np.maximum(self.sizes, 1e-6)

    # --- fetch commit (admission + eviction at completion time) ---------
    def commit(self, j: int, t_c: float) -> None:
        o, p, policy = self.o, self.p, self.policy
        realized = t_c - o.issue_t[j]
        ep = o.episode_delay[j]
        o.agg_sum[j] += ep
        o.agg_sq_sum[j] += ep * ep
        o.agg_cnt[j] += 1.0
        o.episode_delay[j] = 0.0
        o.in_flight[j] = False
        o.complete_t[j] = np.inf
        if self.estimate_z:
            o.z_est[j] = 0.7 * o.z_est[j] + 0.3 * realized
        if policy.greedydual:
            o.gd_h[j] = self.gd_clock + self._gd_cost()[j]
        ranks = np.asarray(policy.rank(self.ot, self.sizes_t,
                                       float(np.float32(t_c)), p).numpy(),
                           np.float32)
        rank_j = ranks[j]
        ok = True
        while ok and self.free < self.sizes[j]:
            vr = np.where(o.cached, ranks, np.inf)
            v = int(np.argmin(vr))
            if vr[v] < (rank_j if policy.compare_admission else np.inf):
                o.cached[v] = False
                self.free += self.sizes[v]
                self.evictions += 1
                if policy.greedydual:
                    self.gd_clock = max(self.gd_clock, vr[v])
            else:
                ok = False
        if ok and self.free >= self.sizes[j]:
            o.cached[j] = True
            self.free -= self.sizes[j]

    def commit_due(self, t: float) -> None:
        while self.heap and self.heap[0][0] <= t:
            t_c, j = heapq.heappop(self.heap)
            self.commit(j, t_c)

    # --- request arrival -------------------------------------------------
    def status(self, i: int) -> str:
        if self.o.cached[i]:
            return "hit"
        if self.o.in_flight[i]:
            return "delayed"
        return "miss"

    def serve(self, t: float, i: int, z_realized: float) -> float:
        """Serve arrival (t, i); ``z_realized`` is used only on a miss.
        Returns the arrival's latency at this tier."""
        o = self.o
        kind = self.status(i)
        if kind == "hit":
            lat = 0.0
            self.hits += 1
        elif kind == "delayed":
            lat = max(float(o.complete_t[i]) - t, 0.0)
            o.episode_delay[i] += np.float32(lat)
            self.delayed += 1
        else:
            z = float(z_realized)
            lat = z
            o.in_flight[i] = True
            o.complete_t[i] = np.float32(t + z)
            o.issue_t[i] = np.float32(t)
            o.episode_delay[i] = np.float32(z)
            heapq.heappush(self.heap, (t + z, i))
            self.misses += 1
        cnt = o.count[i]
        gap = np.float32(t) - o.last_access[i]
        if cnt == 1.0:
            o.gap_mean[i] = gap
        elif cnt > 1.0:
            a_eff = max(1.0 / self.p.window, 1.0 / max(cnt, 1.0))
            o.gap_mean[i] = o.gap_mean[i] + a_eff * (gap - o.gap_mean[i])
        if cnt == 0.0:
            o.first_access[i] = np.float32(t)
        o.last_access[i] = np.float32(t)
        o.count[i] = cnt + 1.0
        if self.policy.greedydual and o.cached[i]:
            o.gd_h[i] = self.gd_clock + self._gd_cost()[i]
        self.total += lat
        return lat

    def counters(self) -> dict:
        return dict(total_latency=self.total, n_hits=self.hits,
                    n_delayed=self.delayed, n_misses=self.misses,
                    n_evictions=self.evictions)


def simulate_ref_stream(chunks, n_objects: int, sizes, z_mean,
                        capacity: float, policy_name: str,
                        params: PolicyParams | None = None,
                        estimate_z: bool = False,
                        rebase: bool = False) -> dict:
    """The oracle over an iterable of ``(times, objs, z_draw)`` chunks.
    Any chunking of one trace gives :func:`simulate_ref`'s result;
    ``rebase=True`` rebases each chunk's f64 times to its first arrival
    and shifts the cache's absolute times, heap included, by the f32
    delta, as the streaming engine does."""
    cache = _RefCache(n_objects, capacity, policy_name, params,
                      _np(z_mean, np.float32), estimate_z)
    cache.bind_sizes(_np(sizes, np.float32))
    base = 0.0
    for times, objs, z_draw in chunks:
        times = _np(times, np.float64)
        objs = _np(objs, np.int64)
        z_draw = _np(z_draw, np.float32)
        if rebase and len(times):
            delta = np.float32(float(times[0]) - base)
            base = float(times[0])
            o = cache.o
            for f in ("complete_t", "issue_t", "last_access",
                      "first_access"):
                getattr(o, f)[:] = getattr(o, f) - delta
            cache.heap = [(float(np.float32(np.float32(t_c) - delta)), j)
                          for t_c, j in cache.heap]
            heapq.heapify(cache.heap)
        local = (times - base).astype(np.float32) if rebase \
            else times.astype(np.float32)
        for k in range(len(times)):
            t = float(local[k])
            cache.commit_due(t)
            cache.serve(t, int(objs[k]), z_draw[k])
    return cache.counters()


def simulate_ref(trace, capacity: float, policy_name: str,
                 params: PolicyParams | None = None,
                 estimate_z: bool = False) -> dict:
    """The oracle over a :class:`repro_torch.core.trace.Trace`."""
    times = _np(trace.times, np.float32)
    objs = _np(trace.objs, np.int64)
    z_draw = _np(trace.z_draw, np.float32)
    cache = _RefCache(trace.n_objects, capacity, policy_name, params,
                      _np(trace.z_mean, np.float32), estimate_z)
    cache.bind_sizes(_np(trace.sizes, np.float32))
    for k in range(len(times)):
        t = float(times[k])
        cache.commit_due(t)
        cache.serve(t, int(objs[k]), z_draw[k])
    return cache.counters()


def simulate_hier_ref(trace, n_shards: int, l1_capacity: float,
                      l2_capacity: float, policy_name: str,
                      l2_policy: str = "lru",
                      params: PolicyParams | None = None,
                      l2_params: PolicyParams | None = None,
                      estimate_z: bool = True) -> dict:
    """The two-tier oracle over a :class:`repro_torch.core.hierarchy.
    HierTrace`: an L1 miss is an L2 arrival at the same instant, and the
    L1 fetch completes ``hop + R_L2(t)`` later."""
    times = _np(trace.times, np.float32)
    objs = _np(trace.objs, np.int64)
    shards = _np(trace.shards, np.int64)
    z_draw = _np(trace.z_draw, np.float32)
    hop_draw = _np(trace.hop_draw, np.float32)
    sizes = _np(trace.sizes, np.float32)
    z_mean = _np(trace.z_mean, np.float32)
    n = trace.n_objects
    if l2_params is None:
        l2_params = PolicyParams()   # decoupled default, as in simulate_hier

    l1_prior = np.float32(trace.hop_mean) + z_mean
    l1 = [_RefCache(n, l1_capacity, policy_name, params, l1_prior,
                    estimate_z) for _ in range(n_shards)]
    l2 = _RefCache(n, l2_capacity, l2_policy, l2_params, z_mean, estimate_z)
    for c in l1 + [l2]:
        c.bind_sizes(sizes)

    for k in range(len(times)):
        t, i, s = float(times[k]), int(objs[k]), int(shards[k])
        l2.commit_due(t)
        for c in l1:
            c.commit_due(t)
        c1 = l1[s]
        z_eff = np.float32(0.0)
        if c1.status(i) == "miss":
            res = l2.serve(t, i, z_draw[k])
            z_eff = np.float32(hop_draw[k] + np.float32(res))
        c1.serve(t, i, z_eff)

    agg = dict(total_latency=sum(c.total for c in l1),
               n_hits=sum(c.hits for c in l1),
               n_delayed=sum(c.delayed for c in l1),
               n_misses=sum(c.misses for c in l1),
               n_evictions=sum(c.evictions for c in l1))
    agg["l2"] = l2.counters()
    agg["per_shard"] = [c.counters() for c in l1]
    return agg
