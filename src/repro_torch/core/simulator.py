"""Delayed-hit cache simulator (dense state, one or more lanes).

One step per request: before serving the request at time t, every
outstanding fetch with ``complete_t <= t`` is committed in completion-time
order, each with its own admission/eviction decision at its exact
completion time; then the request is served.  These are the semantics of
the JAX reference's ``lax.scan``/``lax.while_loop`` graph, and of a classical
event-driven simulation.

Eviction follows the paper's §2.2: evict the lowest-ranked cached object
while its rank is strictly below the incoming object's rank (policies with
``compare_admission``); if space still cannot be freed, the incoming object
is not admitted.

Where the work runs:

- The per-object state (``[L, N]`` per field) lives on the device.  Every
  point update (a serve at object i, a commit at object j) gathers the
  fields at that object for all lanes in one read-back, computes the new
  values on the host in f32, and writes them back with one batched
  lane-scatter launch (its indices and values ride in the kernel's
  parameters, so the write needs no copy).  That read-back is the one
  device sync of a serve or a commit.
- The per-lane scalars (free capacity, clocks, counters, Kahan sums) and a
  heap of the outstanding fetches live on the host, so the commit check
  ``min_complete <= t`` costs no sync.
- A commit that needs space scores the whole table on the device (the
  eq.-16 kernels for the paper's policy, the policy's epilogue otherwise),
  then reads back the ascending victim order once; the evict-until-fit
  loop walks it on the host in f32.  ``simulate`` and
  ``latency_improvement`` score the eq.-16 lane alike: through
  ``ranking_victim_order``, or through ``ranking_scores`` when
  ``evict_top=0``.  Evicting more than ``evict_top``
  victims for one admission falls back to a per-eviction argmin on the
  device (phase 2), bitwise identical to walking a longer order.

Lanes run in lockstep: a lane with no due commit writes back its own bits
and keeps its scalars, so each lane's result equals a single-lane run bit
for bit.  ``latency_improvement`` runs the policy and its baseline as two
lanes of one state.

Host arithmetic uses numpy f32 arrays with f32 constants; every operation
rounds once, in the reference's order (numpy never fuses a multiply-add).
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from .._device import resolve_device
from ..kernels import ranking_score as _rs
from ..kernels import ref as _ref
from ..kernels.lane_scatter import lane_scatter_batch
from . import prng
from .distributions import Exponential
from .ranking import (EPS, POLICIES, PolicyParams, _f32, epi_stochastic_vacdh,
                      make_substrate)
from .state import FIELD, F32_FIELDS, init_state, kahan_add
from .trace import Trace

# How many victims the rank-and-select pass pre-orders per commit; 0 scores
# the row only and evicts through the per-eviction argmin loop alone.
# Results are bitwise identical for every setting.
EVICT_TOP = 8

# Scoring backends for the commit-time ranking pass:
#   'rank'   the policy's epilogue over the substrate
#   'kernel' the eq.-16 CUDA kernels for the paper's policy (their plain
#            versions when the state lies on the CPU)
#   'ref'    the plain PyTorch versions of every kernel (the eq.-16
#            scoring and the lane-scatter writes), on any device
_SCORE_MODES = ("rank", "kernel", "ref")

_F = np.float32
_ZERO, _ONE, _INF = _F(0.0), _F(1.0), _F(np.inf)
_EPS = _F(EPS)
_Z_OLD, _Z_NEW = _F(0.7), _F(0.3)
_NF = len(F32_FIELDS)


@dataclasses.dataclass
class SimResult:
    """Totals of one lane (f32 0-d tensors, as the reference's arrays)."""

    total_latency: torch.Tensor
    n_hits: torch.Tensor
    n_delayed: torch.Tensor
    n_misses: torch.Tensor
    n_evictions: torch.Tensor

    @property
    def n_requests(self):
        return self.n_hits + self.n_delayed + self.n_misses

    @property
    def mean_latency(self):
        return self.total_latency / torch.clamp(self.n_requests, min=1.0)

    @property
    def hit_ratio(self):
        return self.n_hits / torch.clamp(self.n_requests, min=1.0)


def resolve_score_mode(use_kernel, device) -> str:
    """Map ``use_kernel`` to a scoring backend.

    None (the default) -> 'kernel' on a card, 'ref' on the CPU; True ->
    'kernel'; False -> 'rank' (the epilogue); 'kernel'/'ref'/'rank' force a
    backend."""
    if use_kernel is None:
        return "kernel" if torch.device(device).type == "cuda" else "ref"
    if use_kernel is False:
        return "rank"
    if use_kernel is True:
        return "kernel"
    if use_kernel in _SCORE_MODES:
        return use_kernel
    raise ValueError(f"use_kernel={use_kernel!r}; expected a bool, None, or "
                     f"one of {_SCORE_MODES}")


def _trace_on(trace: Trace, dev: torch.device) -> Trace:
    if trace.device == dev:
        return trace
    return Trace(*(x.to(dev) for x in (trace.times, trace.objs, trace.sizes,
                                       trace.z_mean, trace.z_draw)))


def _lambda_hat(gap_mean, count, cold_rate):
    """:func:`repro_torch.core.ranking.lambda_hat` on host f32 arrays."""
    lam = _ONE / np.maximum(gap_mean, _EPS)
    return np.where(count >= _F(2.0), lam, cold_rate)


def _agg_mean_hat(agg_sum, agg_cnt, z_est):
    """:func:`repro_torch.core.ranking.agg_mean_hat` on host f32 arrays."""
    m = agg_sum / np.maximum(agg_cnt, _ONE)
    return np.where(agg_cnt > _ZERO, m, z_est)


class _Engine:
    """One simulation of ``L`` lanes over one trace (see the module doc)."""

    def __init__(self, trace: Trace, capacity: float, policies: tuple,
                 params: PolicyParams, estimate_z: bool, score_mode: str,
                 evict_top, key):
        self.dev = trace.device
        self.L = len(policies)
        self.pols = [POLICIES[n] for n in policies]
        self.p = params
        self.estimate_z = estimate_z
        self.mode = score_mode
        self._lane_write = (_ref.lane_scatter_batch_ref
                            if score_mode == "ref" else lane_scatter_batch)
        self.n = trace.n_objects
        self.top = min(EVICT_TOP if evict_top is None else int(evict_top),
                       self.n)
        # each AdaptSize lane's coin key, split at every commit of that lane
        self.keys = [tuple(int(k) for k in key)] * self.L
        self.trace = trace
        self.sizes = trace.sizes
        self.sizes_np = trace.sizes.cpu().numpy()
        st = init_state(self.n, capacity, trace.z_mean, self.L, self.dev)
        self.st = st
        self.rows_f = st.values.view(_NF * self.L, self.n)
        self.rows_b = st.flags.view(-1, self.n)
        self.cached = st.flags[0]
        # host scalars: numpy views of the state's [L] CPU tensors
        self.free = st.free.numpy()
        self.gd_clock = st.gd_clock.numpy()
        self.min_complete = st.min_complete.numpy()
        self.lat_sum = st.lat_sum.numpy()
        self.lat_comp = st.lat_comp.numpy()
        self.n_hits = st.n_hits.numpy()
        self.n_delayed = st.n_delayed.numpy()
        self.n_misses = st.n_misses.numpy()
        self.n_evictions = st.n_evictions.numpy()
        mask = lambda f: np.array([bool(f(q)) for q in self.pols])
        self.gd = mask(lambda q: q.greedydual)
        self.gd_rate = mask(lambda q: q.gd_cost == "agg_rate")
        self.adapt = mask(lambda q: q.admission == "adaptsize")
        self.cmp_adm = mask(lambda q: q.compare_admission)
        self.cold_rate = _F(params.cold_rate)
        self.gap_alpha = _F(params.gap_alpha)
        self.adapt_c = _F(params.adapt_c)
        self.heaps = [[] for _ in range(self.L)]
        self.syncs = 0
        self.commits = 0
        self.scored = 0

    # --- device traffic ---------------------------------------------------
    def _read(self, t: torch.Tensor) -> np.ndarray:
        """Read a device tensor back to the host (one sync)."""
        self.syncs += 1
        return t.cpu().numpy()

    def _gather(self, idx):
        """Every field at object ``idx[l]`` of each lane l: f32 [12, L] and
        bool [2, L] host arrays, in one read-back."""
        if all(int(j) == int(idx[0]) for j in idx):
            v = self.st.values[:, :, int(idx[0])]
            f = self.st.flags[:, :, int(idx[0])]
        else:
            v = torch.stack([self.st.values[:, l, int(j)]
                             for l, j in enumerate(idx)], dim=1)
            f = torch.stack([self.st.flags[:, l, int(j)]
                             for l, j in enumerate(idx)], dim=1)
        a = self._read(torch.cat([v, f.to(torch.float32)]))
        return a[:_NF].copy(), a[_NF:] > 0.5

    def _scatter(self, writes):
        """Lane-scatter writes ``(x [R, N], idx [R], val [R], valid [R] or
        None, add)`` with host operands, in list order: one
        ``lane_scatter_batch`` call (one launch on the card)."""
        self._lane_write(writes)

    def _point_writes(self, idx, new_f, new_b):
        """All fields of every lane at ``idx[l]``: rows (field, lane)."""
        idx = np.asarray(idx, np.int32)
        return [(self.rows_f, np.tile(idx, _NF), new_f.reshape(-1), None,
                 False),
                (self.rows_b, np.tile(idx, 2), new_b.reshape(-1), None,
                 False)]

    # --- scoring ----------------------------------------------------------
    def _kernelable(self, li: int) -> bool:
        return (self.mode != "rank"
                and self.pols[li].epilogue is epi_stochastic_vacdh
                and isinstance(self.p.dist, Exponential))

    def _select(self, li: int, t: float, top: int):
        """Lane ``li``'s score row and victim order ``(ranks [N], idx
        [top], vals [top])`` at time ``t`` (device tensors)."""
        o = self.st.obj.lane(li)
        sub = make_substrate(o, self.sizes, t, self.p)
        omega = _f32(self.p.omega)
        if self._kernelable(li):
            args = (sub.lam, sub.z_est, sub.resid, self.sizes, o.cached)
            kern = self.mode == "kernel"
            if top:
                if kern:
                    return _rs.ranking_victim_order(*args, omega=omega,
                                                    top=top)
                return _ref.ranking_victim_order_ref(*args, omega, top)
            ranks = (_rs.ranking_scores(*args, omega=omega) if kern
                     else _ref.ranking_scores_ref(*args, omega))[0]
        else:
            ranks = self.pols[li].epilogue(sub, self.p)
        if not top:
            return ranks, None, None
        idx, vals = _ref.victim_order_ref(ranks, o.cached, top)
        return ranks, idx, vals

    # --- GreedyDual cost ----------------------------------------------------
    def _gd_cost(self, f, size):
        """GreedyDual cost term for the object whose fields are ``f``."""
        cost = _agg_mean_hat(f[FIELD["agg_sum"]], f[FIELD["agg_cnt"]],
                             f[FIELD["z_est"]])
        lam = _lambda_hat(f[FIELD["gap_mean"]], f[FIELD["count"]],
                          self.cold_rate)
        cost = np.where(self.gd_rate, cost * lam, cost)
        return cost / np.maximum(size, _EPS)

    # --- commit ---------------------------------------------------------------
    def _commit(self, due: np.ndarray) -> None:
        """Commit the earliest outstanding fetch of every due lane."""
        L, top = self.L, self.top
        self.commits += 1
        j = np.zeros(L, np.int64)
        for li in np.flatnonzero(due):
            j[li] = heapq.heappop(self.heaps[li])[1]
        g, b = self._gather(j)
        f = lambda name: g[FIELD[name]]
        t_c = f("complete_t")
        realized = t_c - f("issue_t")
        ep = f("episode_delay")

        # --- finalize the miss episode's statistics -----------------------
        new = g.copy()
        new[FIELD["agg_sum"]] = f("agg_sum") + ep
        new[FIELD["agg_sq_sum"]] = f("agg_sq_sum") + ep * ep
        new[FIELD["agg_cnt"]] = f("agg_cnt") + _ONE
        new[FIELD["episode_delay"]] = _ZERO
        new[FIELD["complete_t"]] = _INF
        if self.estimate_z:
            new[FIELD["z_est"]] = _Z_OLD * f("z_est") + _Z_NEW * realized
        new_b = b.copy()
        new_b[1] = False                                 # in_flight
        min_c = np.array([h[0][0] if h else np.inf for h in self.heaps],
                         np.float32)
        s_j = self.sizes_np[j]

        # --- admission coin (AdaptSize) ------------------------------------
        admit_ok = np.ones(L, bool)
        for li in np.flatnonzero(due & self.adapt):
            self.keys[li], sub = prng.split(self.keys[li])
            admit_ok[li] = prng.uniform(sub) < np.exp(
                -s_j[li:li + 1] / self.adapt_c)[0]

        # --- GreedyDual H refresh at the exact completion time ---------------
        if self.gd.any():
            hj = self.gd_clock + self._gd_cost(new, s_j)
            new[FIELD["gd_h"]] = np.where(self.gd, hj, f("gd_h"))

        # lanes with no due commit write back their own bits
        self._scatter(self._point_writes(j, np.where(due, new, g),
                                         np.where(due, new_b, b)))

        # --- rank-and-select, only where the commit needs space -------------
        gate = due & admit_ok & (self.free < s_j)
        ranks = {}
        rank_j = np.zeros(L, np.float32)
        o_idx = np.zeros((L, top), np.int64)
        o_val = np.zeros((L, top), np.float32)
        if gate.any():
            self.scored += 1
            packed = []
            for li in np.flatnonzero(gate):
                r, idx, vals = self._select(li, float(t_c[li]), top)
                ranks[li] = r
                parts = [r[int(j[li]):int(j[li]) + 1].view(torch.int32)]
                if top:
                    parts += [vals.view(torch.int32), idx.to(torch.int32)]
                packed.append(torch.cat(parts))
            back = self._read(torch.cat(packed))
            for k, li in enumerate(np.flatnonzero(gate)):
                row = back[k * (1 + 2 * top):(k + 1) * (1 + 2 * top)]
                rank_j[li] = row[:1].view(np.float32)[0]
                o_val[li] = row[1:1 + top].view(np.float32)
                o_idx[li] = row[1 + top:]
        cmp = np.where(self.cmp_adm, rank_j, _INF)

        free = self.free.copy()
        clock = self.gd_clock.copy()
        nev = self.n_evictions.copy()
        ok = admit_ok.copy()
        evictions = []

        def evict(act, v, vv):
            nonlocal free, clock, nev, ok
            can = vv < cmp
            e = act & can
            free = np.where(e, free + self.sizes_np[v], free)
            nev = np.where(e, nev + _ONE, nev)
            clock = np.where(self.gd & e, np.maximum(clock, vv), clock)
            ok = np.where(act, can, ok)
            return e

        # phase 1: walk the precomputed ascending victim order
        for k in range(top):
            act = due & ok & (free < s_j)
            if not act.any():
                break
            v = o_idx[:, k]
            e = evict(act, v, o_val[:, k])
            if e.any():
                evictions.append((self.cached, v, np.zeros(L, bool), e,
                                  False))

        # phase 2: per-eviction argmin, when one admission needs more
        # victims than the order holds (rare)
        while True:
            act = due & ok & (free < s_j)
            if not act.any():
                break
            if evictions:
                self._scatter(evictions)
                evictions = []
            lanes = np.flatnonzero(act)
            picks = []
            for li in lanes:
                vr = torch.where(self.cached[li], ranks[li], float("inf"))
                v = torch.argmin(vr)
                picks.append(torch.stack([v.to(torch.int32),
                                          vr[v].view(torch.int32)]))
            back = self._read(torch.stack(picks))
            v = np.zeros(L, np.int64)
            vv = np.zeros(L, np.float32)
            v[lanes] = back[:, 0]
            vv[lanes] = back[:, 1].view(np.float32)
            e = evict(act, v, vv)
            if e.any():
                evictions.append((self.cached, v, np.zeros(L, bool), e,
                                  False))

        # --- admission --------------------------------------------------------
        do_admit = due & admit_ok & ok & (free >= s_j)
        if do_admit.any():
            evictions.append((self.cached, j, np.ones(L, bool), do_admit,
                              False))
        if evictions:
            self._scatter(evictions)
        free = np.where(do_admit, free - s_j, free)

        self.free[:] = np.where(due, free, self.free)
        self.gd_clock[:] = np.where(due, clock, self.gd_clock)
        self.n_evictions[:] = np.where(due, nev, self.n_evictions)
        self.min_complete[:] = np.where(due, min_c, self.min_complete)

    def _commit_due(self, t) -> None:
        """Commit, in completion order, every outstanding fetch with
        ``complete_t <= t`` (lanes in lockstep)."""
        while True:
            due = self.min_complete <= t
            if not due.any():
                return
            self._commit(due)

    # --- serve ----------------------------------------------------------------
    def _serve(self, t, i: int, z) -> None:
        """Serve the request (t, i); ``z`` is its fetch time if it misses."""
        g, b = self._gather([i] * self.L)
        f = lambda name: g[FIELD[name]]
        is_hit, is_delayed = b[0], b[1]
        is_miss = ~(is_hit | is_delayed)
        ct = f("complete_t")
        lat_delayed = np.maximum(ct - t, _ZERO)
        lat = np.where(is_hit, _ZERO, np.where(is_delayed, lat_delayed, z))

        # --- miss: issue fetch --------------------------------------------
        comp = np.where(is_miss, t + z, ct)
        new = g.copy()
        new[FIELD["complete_t"]] = comp
        new[FIELD["issue_t"]] = np.where(is_miss, t, f("issue_t"))
        new[FIELD["episode_delay"]] = np.where(
            is_miss, z,
            f("episode_delay") + np.where(is_delayed, lat, _ZERO))
        new_b = b.copy()
        new_b[1] = is_miss | is_delayed
        self.min_complete[:] = np.minimum(self.min_complete,
                                          np.where(is_miss, comp, _INF))
        for li in np.flatnonzero(is_miss):
            heapq.heappush(self.heaps[li], (float(comp[li]), i))

        # --- access statistics (every request) ------------------------------
        cnt = f("count")
        gap = t - f("last_access")
        gm0 = f("gap_mean")
        a_eff = np.maximum(self.gap_alpha, _ONE / np.maximum(cnt, _ONE))
        new[FIELD["gap_mean"]] = np.where(
            cnt <= _ZERO, gm0,
            np.where(cnt == _ONE, gap, gm0 + a_eff * (gap - gm0)))
        new[FIELD["first_access"]] = np.where(cnt == _ZERO, t,
                                              f("first_access"))
        new[FIELD["last_access"]] = t
        new[FIELD["count"]] = cnt + _ONE
        if self.gd.any():
            hi = self.gd_clock + self._gd_cost(new, self.sizes_np[[i]])
            new[FIELD["gd_h"]] = np.where(self.gd & is_hit, hi, f("gd_h"))
        self._scatter(self._point_writes([i] * self.L, new, new_b))

        self.lat_sum[:], self.lat_comp[:] = kahan_add(self.lat_sum,
                                                      self.lat_comp, lat)
        self.n_hits[:] = self.n_hits + is_hit
        self.n_delayed[:] = self.n_delayed + is_delayed
        self.n_misses[:] = self.n_misses + is_miss

    def run(self) -> list[SimResult]:
        tr = self.trace
        times = tr.times.cpu().numpy()
        objs = tr.objs.cpu().numpy()
        z_draw = tr.z_draw.cpu().numpy()
        with np.errstate(all="ignore"):
            for r in range(tr.n_requests):
                t = times[r:r + 1]
                self._commit_due(t)
                self._serve(t, int(objs[r]), z_draw[r:r + 1])
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        s = self.st
        return [SimResult(s.lat_sum[li].clone(), s.n_hits[li].clone(),
                          s.n_delayed[li].clone(), s.n_misses[li].clone(),
                          s.n_evictions[li].clone()) for li in range(self.L)]

    def stats(self) -> dict:
        return {"requests": self.trace.n_requests, "syncs": self.syncs,
                "commits": self.commits, "scoring_commits": self.scored}


def _run(trace, capacity, policies, params, key, estimate_z,
         use_kernel, evict_top, device, counters):
    dev = resolve_device(device)
    for name in policies:
        if name not in POLICIES:
            raise ValueError(f"unknown policy {name!r}; known: "
                             f"{sorted(POLICIES)}")
    if params is None:
        params = PolicyParams()
    eng = _Engine(_trace_on(trace, dev), capacity, tuple(policies), params,
                  estimate_z, resolve_score_mode(use_kernel, dev), evict_top,
                  key)
    res = eng.run()
    if counters is not None:
        for k, v in eng.stats().items():
            counters[k] = counters.get(k, 0) + v
    return res


def simulate(trace: Trace, capacity: float, policy: str = "stoch_vacdh",
             params: PolicyParams | None = None,
             key=(0, 0), estimate_z: bool = False, use_kernel=None,
             evict_top: int | None = None, device=None,
             counters: dict | None = None) -> SimResult:
    """Run one policy over a trace on ``device`` (None: the card).

    ``use_kernel`` picks the eq.-16 scoring backend
    (:func:`resolve_score_mode`); ``evict_top`` the victim-order length
    (:data:`EVICT_TOP`; results are bitwise identical for every value).
    ``key`` is the key data ``(k0, k1)`` of the AdaptSize admission coin
    stream (``(0, 0)`` is ``jax.random.key(0)``); the coins
    equal the JAX package's bit for bit (:mod:`.prng`).  ``counters``,
    when given, accumulates requests, device syncs, commits and scoring
    commits."""
    return _run(trace, capacity, (policy,), params, key, estimate_z,
                use_kernel, evict_top, device, counters)[0]


def latency_improvement(trace: Trace, capacity: float, policy: str,
                        baseline: str = "lru",
                        params: PolicyParams | None = None,
                        key=(0, 0), estimate_z: bool = False,
                        use_kernel=None, device=None,
                        counters: dict | None = None) -> torch.Tensor:
    """Paper eq. 17: (Latency(baseline) - Latency(policy)) /
    Latency(baseline), in f32.

    The policy and the baseline run as two lanes of one state; each lane's
    result equals its single-lane :func:`simulate` bit for bit.  ``key``
    seeds both lanes' coin streams alike, as in the JAX package."""
    res = _run(trace, capacity, (policy, baseline), params, key,
               estimate_z, use_kernel, None, device, counters)
    la, lb = res[0].total_latency, res[1].total_latency
    return (lb - la) / lb
