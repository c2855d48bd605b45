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
  point update (a serve at object i, a commit at object j, a ``cached``
  write of an eviction or an admission) is an op of the point-update
  journal (:mod:`repro_torch.kernels.point_update`): the host queues it,
  and before the next read of the state (a scoring pass, an argmin, a
  time shift, the results) one launch does the field arithmetic of every
  queued op on the card, in order; the ops ride in the kernel's
  parameters.  A serve or a commit reads nothing back.
- The host keeps what its decisions read: a mirror of the ``cached`` and
  ``in_flight`` bits and of ``complete_t`` for every lane and object,
  written by the same decisions that write the card (the serve's miss,
  the commit, evictions, admissions) and shifted with the card's times.
  The per-lane scalars (free capacity, clocks, counters, Kahan sums) and a
  heap of the outstanding fetches live on the host too, so the commit
  check ``min_complete <= t`` costs no sync.
- A commit that needs space scores the whole table on the device (the
  eq.-16 kernels for the paper's policy, the policy's epilogue otherwise),
  then reads back the ascending victim order once; the evict-until-fit
  loop walks it on the host in f32.  ``simulate`` and
  ``latency_improvement`` score the eq.-16 lane alike: through
  ``ranking_victim_order``, or through ``ranking_scores`` when
  ``evict_top=0``.  Evicting more than ``evict_top``
  victims for one admission falls back to a per-eviction argmin on the
  device (phase 2), bitwise identical to walking a longer order.  These
  are a replay's only read-backs: one a scoring commit, one an argmin.

Lanes run in lockstep: a lane with no due commit keeps its point and its
scalars, so each lane's result equals a single-lane run bit for bit.  Each lane has its own policy, capacity, :class:`PolicyParams`
and coin key; all lanes of an engine replay one request sequence.
``latency_improvement`` runs the policy and its baseline as two lanes of
one state, :func:`repro_torch.core.sweep.sweep_grid` a whole grid.

The engine takes its requests from host arrays, a chunk at a time:
:func:`simulate_stream` feeds a host :class:`RequestStream` chunk by chunk
(its f64 times rebased to f32 offsets from each chunk's start), so the
request axis is never uploaded to the card.

``state_mode='slots'`` runs the same engine over a hashed slot table
(:class:`_SlotEngine`): the per-object state is ``[S]``, an object takes
its slot on first touch, and every reduction over the slot axis breaks
ties by object id, so the replay equals the dense one bit for bit while
the table never fills.  The hierarchy
(:mod:`repro_torch.core.hierarchy`) runs two engines, one lane per L1
shard and one per L2, through the per-lane ``active`` mask and fetch
times of :meth:`_Engine._serve`.

Host arithmetic uses numpy f32 arrays with f32 constants; every operation
rounds once, in the reference's order (numpy never fuses a multiply-add),
as the point-update kernel's does on the card.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from .._device import resolve_device
from ..kernels import ranking_score as _rs
from ..kernels import ref as _ref
from ..kernels.point_update import PointUpdate
from . import prng
from .distributions import Exponential
from .ranking import (EPS, POLICIES, PolicyParams, _f32, epi_stochastic_vacdh,
                      make_substrate)
from .state import (SLOT_EMPTY, init_slot_state, init_state, kahan_add,
                    shift_times, slot_home, slot_table_size)
from .trace import RequestStream, Trace, auto_chunk_size, stream_of_trace

# How many victims the rank-and-select pass pre-orders per commit; 0 scores
# the row only and evicts through the per-eviction argmin loop alone.
# Results are bitwise identical for every setting.
EVICT_TOP = 8

# Scoring backends for the commit-time ranking pass:
#   'rank'   the policy's epilogue over the substrate
#   'kernel' the eq.-16 CUDA kernels for the paper's policy (their plain
#            versions when the state lies on the CPU)
#   'ref'    the plain PyTorch versions of every kernel (the eq.-16
#            scoring and the point updates), on any device
_SCORE_MODES = ("rank", "kernel", "ref")

_F = np.float32
_ZERO, _ONE, _INF = _F(0.0), _F(1.0), _F(np.inf)


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


def ranks_through_kernel(policy: str, params: PolicyParams,
                         mode: str) -> bool:
    """Whether a lane of ``policy`` under ``params`` is scored by the
    ranking kernel (by its plain version in mode 'ref'): eq. 16 under the
    Exponential law, unless ``mode`` is 'rank'.  Every other lane scores
    through its policy's epilogue."""
    return (mode != "rank"
            and POLICIES[policy].epilogue is epi_stochastic_vacdh
            and isinstance(params.dist, Exponential))


def _trace_on(trace: Trace, dev: torch.device) -> Trace:
    if trace.device == dev:
        return trace
    return Trace(*(x.to(dev) for x in (trace.times, trace.objs, trace.sizes,
                                       trace.z_mean, trace.z_draw)))


def eviction_pick(cached: torch.Tensor, ranks: torch.Tensor,
                  ids: torch.Tensor | None) -> torch.Tensor:
    """One eviction of the per-eviction loop: the lowest-ranked cached
    entry of a lane, as int32 ``[index, score bits]``.  Ties break by
    position (``ids=None``, the dense state, where position is the object
    id) or by the smallest id (the slot table's ``key_tab``,
    :func:`repro_torch.kernels.ref.tiebreak_argmin_ref`)."""
    vr = torch.where(cached, ranks, float("inf"))
    v = (torch.argmin(vr) if ids is None
         else _ref.tiebreak_argmin_ref(vr, ids))
    return torch.stack([v.to(torch.int32), vr[v].view(torch.int32)])


class _Engine:
    """One simulation of ``L`` lanes over one object universe (see the
    module doc).  ``sizes`` and ``z_mean`` are ``[N]`` tensors on the
    engine's device; lane ``l`` runs ``policies[l]`` at ``capacities[l]``
    under ``params[l]`` with coin key ``keys[l]``."""

    def __init__(self, sizes: torch.Tensor, z_mean: torch.Tensor | None,
                 capacities, policies: tuple, params: tuple,
                 keys: tuple, estimate_z: bool, score_mode: str,
                 evict_top, plain_writes: bool | None = None,
                 state=None, table=None):
        self.dev = sizes.device
        self.L = len(policies)
        self.pols = [POLICIES[n] for n in policies]
        self.params = tuple(params)
        self.estimate_z = estimate_z
        self.mode = score_mode
        if plain_writes is None:
            plain_writes = score_mode == "ref"
        # the ids that break ties in the per-eviction argmin: None is the
        # position (the dense state); the slot engine sets its key_tab
        self.ids = None
        self.n = sizes.shape[0]
        self.top = min(EVICT_TOP if evict_top is None else int(evict_top),
                       self.n)
        # each AdaptSize lane's coin key, split at every commit of that lane
        self.keys = [tuple(int(x) for x in k) for k in keys]
        self.sizes = sizes
        self.sizes_np = sizes.cpu().numpy()
        st = (init_state(self.n, capacities, z_mean, self.L, self.dev)
              if state is None else state)
        self.st = st
        self.cached = st.flags[0]
        # each lane's fields as [N] views (the state is updated in place)
        self.lane_obj = [st.obj.lane(li) for li in range(self.L)]
        # a host buffer (pinned on a card) for the indices of a scoring
        # pass; every use ends in a read-back before the next one refills it
        self._hidx = torch.empty(2 * self.L, dtype=torch.int64,
                                 pin_memory=self.dev.type == "cuda")
        # the host mirror: cached / in_flight [2, L, N] and complete_t
        # [L, N], as a fresh state holds them
        self.m_bits = np.zeros((2, self.L, self.n), bool)
        self.m_ct = np.full((self.L, self.n), np.inf, np.float32)
        self._lane_ids = np.arange(self.L)
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
        lane = lambda f: np.array([f(p) for p in self.params], np.float32)
        self.cold_rate = lane(lambda p: p.cold_rate)
        self.gap_alpha = lane(lambda p: p.gap_alpha)
        self.adapt_c = lane(lambda p: p.adapt_c)
        self._point = PointUpdate(st.values, st.flags, self.gd, self.gd_rate,
                                  self.cold_rate, self.gap_alpha, EPS,
                                  estimate_z, plain=plain_writes,
                                  table=table)
        self.heaps = [[] for _ in range(self.L)]
        self.requests = 0
        self.syncs = 0
        self.commits = 0
        self.scored = 0
        self.argmins = 0

    # --- device traffic ---------------------------------------------------
    def _read(self, t: torch.Tensor) -> np.ndarray:
        """Read a device tensor back to the host (one sync)."""
        self.syncs += 1
        return t.cpu().numpy()

    def _set_cached(self, lanes_mask, idx, value: bool) -> None:
        """The ``cached`` write of ``idx[l]`` on the masked lanes, to the
        mirror now and to the card's journal."""
        lanes = self._lane_ids[lanes_mask]
        self.m_bits[0, lanes, idx[lanes]] = value
        self._point.set_cached(idx, lanes_mask, value)

    # --- scoring ----------------------------------------------------------
    def _kernelable(self, li: int) -> bool:
        return ranks_through_kernel(self.pols[li].name, self.params[li],
                                    self.mode)

    def _select(self, lanes, t_c, j, top: int):
        """Score each lane ``li`` of ``lanes`` at its commit time
        ``t_c[li]``; returns its score row ``ranks[li]`` (device [N]) and
        one int32 device tensor whose row ``k`` holds, for lane
        ``order[k]``, the score of its committing object ``j[li]`` and its
        ascending victim order's ``top`` values and indices.

        Eq.-16 kernel lanes get the order from the kernel (or its plain
        version); the other lanes' rows are stacked and ordered in one
        masked stable sort, row by row the order of
        ``ref.victim_order_ref``."""
        ranks, kern_rows, plain = {}, [], []
        for li in lanes:
            p = self.params[li]
            o = self.lane_obj[li]
            sub = make_substrate(o, self.sizes, float(t_c[li]), p)
            if not self._kernelable(li):
                ranks[li] = self.pols[li].epilogue(sub, p)
                plain.append(li)
                continue
            args = (sub.lam, sub.z_est, sub.resid, self.sizes, o.cached)
            omega = _f32(p.omega)
            kern = self.mode == "kernel"
            if top:
                r, idx, vals = (
                    _rs.ranking_victim_order(*args, omega=omega, top=top)
                    if kern else
                    _ref.ranking_victim_order_ref(*args, omega, top))
                parts = [vals.view(torch.int32), idx.to(torch.int32)]
            else:
                r = (_rs.ranking_scores(*args, omega=omega) if kern
                     else _ref.ranking_scores_ref(*args, omega))[0]
                parts = []
            ranks[li] = r
            kern_rows.append(torch.cat(
                [r[int(j[li]):int(j[li]) + 1].view(torch.int32)] + parts))
        blocks = [torch.stack(kern_rows)] if kern_rows else []
        if plain:
            g = len(plain)
            if g == 1:          # views: one lane costs no gather
                li = plain[0]
                rows = ranks[li][None]
                cached = self.cached[li:li + 1]
                rank_j = rows[:, int(j[li]):int(j[li]) + 1]
            else:
                rows = torch.stack([ranks[li] for li in plain])  # [g, N]
                hidx = self._hidx.numpy()
                hidx[:g] = plain
                hidx[g:2 * g] = np.arange(g) * self.n + j[plain]
                d = self._hidx[:2 * g].to(self.dev, non_blocking=True)
                cached = self.cached.index_select(0, d[:g])
                rank_j = rows.view(-1)[d[g:]][:, None]
            parts = [rank_j.view(torch.int32)]
            if top:
                masked = torch.where(cached, rows, float("inf"))
                vals, idx = torch.sort(masked, dim=1, stable=True)
                parts += [vals[:, :top].view(torch.int32),
                          idx[:, :top].to(torch.int32)]
            blocks.append(torch.cat(parts, dim=1))
        order = [li for li in lanes if li not in plain] + plain
        return ranks, order, (blocks[0] if len(blocks) == 1
                              else torch.cat(blocks))

    # --- the host heaps of outstanding fetches --------------------------------
    def _push(self, li: int, comp: float, i: int) -> None:
        """Lane ``li`` issued a fetch of object ``i`` completing at
        ``comp``; ties pop by object id."""
        heapq.heappush(self.heaps[li], (comp, i))

    def _pop(self, li: int) -> int:
        """The index of lane ``li``'s earliest outstanding fetch."""
        return heapq.heappop(self.heaps[li])[-1]

    # --- commit ---------------------------------------------------------------
    def _commit(self, due: np.ndarray) -> None:
        """Commit the earliest outstanding fetch of every due lane."""
        L, top = self.L, self.top
        self.commits += 1
        j = np.zeros(L, np.int64)
        for li in np.flatnonzero(due):
            j[li] = self._pop(li)
        lanes = self._lane_ids[due]
        t_c = self.m_ct[self._lane_ids, j]
        s_j = self.sizes_np[j]

        # --- finalize the miss episode (queued for the card): its
        # statistics, the z_est EMA and the GreedyDual refresh at the exact
        # completion time
        self._point.commit(j, due, s_j, self.gd_clock)
        self.m_bits[1, lanes, j[lanes]] = False
        self.m_ct[lanes, j[lanes]] = _INF
        min_c = np.array([h[0][0] if h else np.inf for h in self.heaps],
                         np.float32)

        # --- admission coin (AdaptSize) ------------------------------------
        admit_ok = np.ones(L, bool)
        for li in np.flatnonzero(due & self.adapt):
            self.keys[li], sub = prng.split(self.keys[li])
            admit_ok[li] = prng.uniform(sub) < np.exp(
                -s_j[li:li + 1] / self.adapt_c[li:li + 1])[0]

        # --- rank-and-select, only where the commit needs space -------------
        gate = due & admit_ok & (self.free < s_j)
        ranks = {}
        rank_j = np.zeros(L, np.float32)
        o_idx = np.zeros((L, top), np.int64)
        o_val = np.zeros((L, top), np.float32)
        if gate.any():
            self.scored += 1
            self._point.flush()
            ranks, order, packed = self._select(np.flatnonzero(gate), t_c,
                                                j, top)
            back = self._read(packed)
            for row, li in zip(back, order):
                rank_j[li] = row[:1].view(np.float32)[0]
                o_val[li] = row[1:1 + top].view(np.float32)
                o_idx[li] = row[1 + top:]
        cmp = np.where(self.cmp_adm, rank_j, _INF)

        free = self.free.copy()
        clock = self.gd_clock.copy()
        nev = self.n_evictions.copy()
        ok = admit_ok.copy()

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
                self._set_cached(e, v, False)

        # phase 2: per-eviction argmin, when one admission needs more
        # victims than the order holds (rare)
        while True:
            act = due & ok & (free < s_j)
            if not act.any():
                break
            self._point.flush()
            lanes = np.flatnonzero(act)
            self.argmins += 1
            back = self._read(torch.stack([
                eviction_pick(self.cached[li], ranks[li], self.ids)
                for li in lanes]))
            v = np.zeros(L, np.int64)
            vv = np.zeros(L, np.float32)
            v[lanes] = back[:, 0]
            vv[lanes] = back[:, 1].view(np.float32)
            e = evict(act, v, vv)
            if e.any():
                self._set_cached(e, v, False)

        # --- admission --------------------------------------------------------
        do_admit = due & admit_ok & ok & (free >= s_j)
        if do_admit.any():
            self._set_cached(do_admit, j, True)
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
    def _serve(self, t, i: int, z, active=None, fresh=None) -> np.ndarray:
        """Serve the request (t, i); ``z`` (one or ``[L]``) is its fetch
        time if it misses.  Returns each lane's latency.

        ``active`` (bool ``[L]``) gates the serve per lane: a masked lane
        keeps its point and its scalars, and its latency is computed all
        the same (the hierarchy reads it).  ``fresh`` is a slot table's
        first touch (:meth:`_SlotEngine._locate`), written by the serve's
        op.  The latency branch reads the mirror; the fields are updated on
        the card, from the journal."""
        b = self.m_bits[:, :, i].copy()
        is_hit, is_delayed = b[0], b[1]
        is_miss = ~(is_hit | is_delayed)
        ct = self.m_ct[:, i].copy()
        lat_delayed = np.maximum(ct - t, _ZERO)
        lat = np.where(is_hit, _ZERO, np.where(is_delayed, lat_delayed, z))
        comp = np.where(is_miss, t + z, ct)
        self._point.serve(i, t, z, self.sizes_np[i], self.gd_clock, active,
                          fresh)
        in_flight = is_miss | is_delayed
        if active is not None:
            in_flight = np.where(active, in_flight, is_delayed)
            comp = np.where(active, comp, ct)
            is_hit, is_delayed, is_miss = (is_hit & active,
                                           is_delayed & active,
                                           is_miss & active)
        self.m_bits[1, :, i] = in_flight
        self.m_ct[:, i] = comp
        self.min_complete[:] = np.minimum(self.min_complete,
                                          np.where(is_miss, comp, _INF))
        for li in np.flatnonzero(is_miss):
            self._push(li, float(comp[li]), i)

        lat_sum, lat_comp = kahan_add(self.lat_sum, self.lat_comp, lat)
        if active is not None:
            lat_sum = np.where(active, lat_sum, self.lat_sum)
            lat_comp = np.where(active, lat_comp, self.lat_comp)
        self.lat_sum[:], self.lat_comp[:] = lat_sum, lat_comp
        self.n_hits[:] = self.n_hits + is_hit
        self.n_delayed[:] = self.n_delayed + is_delayed
        self.n_misses[:] = self.n_misses + is_miss
        return lat

    # --- the request feed ---------------------------------------------------
    def _locate(self, obj: int):
        """``(index, fresh)`` of object ``obj`` for its serve: in the dense
        state its own index, never a first touch."""
        return obj, None

    def feed(self, times: np.ndarray, objs: np.ndarray,
             z_draw: np.ndarray) -> None:
        """Replay the requests ``(times f32[k], objs int[k], z_draw
        f32[k])`` (host arrays) after those fed before."""
        with np.errstate(all="ignore"):
            for r in range(times.shape[0]):
                t = times[r:r + 1]
                self._commit_due(t)
                i, fresh = self._locate(int(objs[r]))
                self._serve(t, i, z_draw[r:r + 1], fresh=fresh)
        self.requests += times.shape[0]

    def shift(self, delta: np.float32) -> None:
        """Rebase every absolute time by ``-delta`` (f32), as the reference
        state's ``shift_times`` does: the state's time fields on the card,
        the host ``min_complete``, the mirror's ``complete_t`` and each
        lane's heap of completion times (re-heaped, since distinct times
        may round to one)."""
        if delta == 0:
            return
        self._point.flush()
        shift_times(self.st, float(delta))
        self.m_ct -= delta
        for li, h in enumerate(self.heaps):
            self.heaps[li] = [(float(np.float32(e[0]) - delta), *e[1:])
                              for e in h]
            heapq.heapify(self.heaps[li])

    def result(self) -> list[SimResult]:
        self._point.flush()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        s = self.st
        return [SimResult(s.lat_sum[li].clone(), s.n_hits[li].clone(),
                          s.n_delayed[li].clone(), s.n_misses[li].clone(),
                          s.n_evictions[li].clone()) for li in range(self.L)]

    def stats(self) -> dict:
        return {"requests": self.requests, "syncs": self.syncs,
                "commits": self.commits, "scoring_commits": self.scored,
                "argmins": self.argmins}


class _SlotEngine(_Engine):
    """The one-lane engine over an ``[S]`` slot table (``state_mode=
    'slots'``): the dense machinery runs unchanged over the slot axis, and
    a request's object is resolved to its slot, inserted on first touch,
    before it is served.

    Only the host inserts, so the probe table is the host array
    ``key_np``; the card holds ``key_tab`` for the id tie-break of the
    per-eviction argmin and the per-slot sizes for the scoring pass, both
    written by the first touch's serve op, which also starts the slot
    from the first-touch fields.  The host heap holds ``(complete_t,
    object id, slot)``: commits pop in completion order with ties broken
    by object id, as the dense engine's do, and the mirror's ``in_flight``
    marks the slots with an outstanding fetch."""

    def __init__(self, n_slots: int, slot_seed: int, sizes_full, z_prior,
                 capacity, policy: str, params: PolicyParams, key,
                 estimate_z: bool, score_mode: str, dev):
        st = init_slot_state(n_slots, capacity, slot_seed, dev)
        super().__init__(st.tab.sizes, None, capacity, (policy,),
                         (params,), (key,), estimate_z, score_mode, 0,
                         state=st.sim, table=(st.tab.key_tab, st.tab.sizes))
        self.tab = st.tab
        self.ids = st.tab.key_tab
        self.key_np = np.full(n_slots, SLOT_EMPTY, np.int64)
        self.sizes_np = np.zeros(n_slots, np.float32)
        self.sizes_full = np.asarray(sizes_full, np.float32)
        self.z_prior = np.asarray(z_prior, np.float32)
        self.reclaims = 0

    def _push(self, li, comp, i):
        heapq.heappush(self.heaps[li], (comp, int(self.key_np[i]), i))

    def _reclaim(self, home: int) -> int:
        """The table is full: take the first slot in probe order from
        ``home`` with no outstanding fetch (the home slot when every slot
        has one, dropping its fetch).  Its occupant is evicted if cached,
        and a dropped fetch leaves the heap (the mirror tells both)."""
        order = (home + np.arange(self.n)) % self.n
        idle = np.flatnonzero(~self.m_bits[1, 0, order])
        v = int(order[idle[0]]) if idle.size else home
        if self.m_bits[0, 0, v]:
            self.free[:] = self.free + self.sizes_np[v]
            self.n_evictions[:] = self.n_evictions + _ONE
        if self.m_bits[1, 0, v]:
            h = [e for e in self.heaps[0] if e[-1] != v]
            heapq.heapify(h)
            self.heaps[0] = h
            self.min_complete[:] = h[0][0] if h else _INF
        self.reclaims += 1
        return v

    def _locate(self, obj: int):
        """``(slot, fresh)``: the object's slot, and on a first touch the
        ``(id, z prior)`` its serve op starts the slot from."""
        n = self.n
        s = home = int(slot_home(obj, self.tab.seed, n))
        for _ in range(n):
            k = self.key_np[s]
            if k == obj:
                return s, None
            if k == SLOT_EMPTY:
                break
            s = s + 1 if s + 1 < n else 0
        else:
            s = self._reclaim(home)
        self.key_np[s] = obj
        self.sizes_np[s] = self.sizes_full[obj]
        # the slot's first-touch bits and complete_t, as the serve op writes
        self.m_bits[:, 0, s] = False
        self.m_ct[0, s] = _INF
        return s, (obj, self.z_prior[obj])

    def stats(self) -> dict:
        return {**super().stats(), "reclaims": self.reclaims}


def host_requests(trace: Trace, lo: int = 0, hi: int | None = None):
    """Requests ``lo:hi`` of a trace as host arrays (times, objs, z_draw)."""
    sl = slice(lo, hi)
    return (trace.times[sl].cpu().numpy(), trace.objs[sl].cpu().numpy(),
            trace.z_draw[sl].cpu().numpy())


def check_policies(names) -> None:
    unknown = [n for n in names if n not in POLICIES]
    if unknown:
        raise ValueError(f"unknown policy {unknown[0]!r}; known: "
                         f"{sorted(POLICIES)}")


def add_counters(counters: dict | None, engines) -> None:
    if counters is None:
        return
    for eng in engines:
        for k, v in eng.stats().items():
            counters[k] = counters.get(k, 0) + v


def _run(trace, capacity, policies, params, key, estimate_z,
         use_kernel, evict_top, device, counters):
    dev = resolve_device(device)
    check_policies(policies)
    if params is None:
        params = PolicyParams()
    trace = _trace_on(trace, dev)
    L = len(policies)
    eng = _Engine(trace.sizes, trace.z_mean, capacity, tuple(policies),
                  (params,) * L, (key,) * L, estimate_z,
                  resolve_score_mode(use_kernel, dev), evict_top)
    eng.feed(*host_requests(trace))
    res = eng.result()
    add_counters(counters, [eng])
    return res


def simulate(trace: Trace, capacity: float, policy: str = "stoch_vacdh",
             params: PolicyParams | None = None,
             key=(0, 0), estimate_z: bool = False, use_kernel=None,
             evict_top: int | None = None, state_mode: str = "dense",
             n_slots: int | None = None, slot_seed: int = 0, device=None,
             counters: dict | None = None) -> SimResult:
    """Run one policy over a trace on ``device`` (None: the card).

    ``use_kernel`` picks the eq.-16 scoring backend
    (:func:`resolve_score_mode`); ``evict_top`` the victim-order length
    (:data:`EVICT_TOP`; results are bitwise identical for every value).
    ``key`` is the key data ``(k0, k1)`` of the AdaptSize admission coin
    stream (``(0, 0)`` is ``jax.random.key(0)``); the coins
    equal the JAX package's bit for bit (:mod:`.prng`).  ``counters``,
    when given, accumulates requests, device syncs, commits and scoring
    commits.  ``state_mode='slots'`` routes through the slot-table engine
    (:func:`simulate_stream`), bitwise equal to dense mode whenever the
    table never fills."""
    if state_mode != "dense":
        return simulate_stream(stream_of_trace(trace), capacity, policy,
                               params, key, estimate_z, use_kernel,
                               chunk_size="auto", rebase=False,
                               evict_top=evict_top, state_mode=state_mode,
                               n_slots=n_slots, slot_seed=slot_seed,
                               device=device, counters=counters)
    check_state_mode(state_mode, n_slots, evict_top)
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


# ---------------------------------------------------------------------------
# Streaming replay: a host-resident request stream fed chunk by chunk
# ---------------------------------------------------------------------------
def resolve_chunk_size(chunk_size, n_requests: int) -> int:
    """An int passes through; ``'auto'`` or None picks
    :func:`repro_torch.core.trace.auto_chunk_size`."""
    if chunk_size is None or chunk_size == "auto":
        return auto_chunk_size(n_requests)
    if isinstance(chunk_size, str):
        raise ValueError(f"chunk_size={chunk_size!r}; the only string "
                         f"value is 'auto' (or pass an int / None)")
    if chunk_size < 1:
        raise ValueError(f"chunk_size={chunk_size} must be >= 1")
    return int(chunk_size)


def stream_chunks(times64: np.ndarray, chunk_size: int, rebase: bool):
    """``(lo, hi, t_local f32[hi - lo], delta f32)`` per chunk, as the
    reference's ``_stream_chunks`` builds them: with ``rebase`` each chunk's
    times become f32 offsets from its first time, and ``delta`` is the f64
    step between consecutive bases rounded to f32 (0 without ``rebase``)."""
    base = 0.0
    n = times64.shape[0]
    for lo in range(0, n, chunk_size):
        hi = min(lo + chunk_size, n)
        new_base = float(times64[lo]) if rebase else base
        t_loc = (times64[lo:hi] - new_base).astype(np.float32)
        yield lo, hi, t_loc, np.float32(new_base - base)
        base = new_base


def check_state_mode(state_mode, n_slots, evict_top) -> None:
    """The reference's guards on ``state_mode``, ``n_slots`` and
    ``evict_top``."""
    if state_mode not in ("dense", "slots"):
        raise ValueError(f"state_mode={state_mode!r}; expected 'dense' or "
                         f"'slots'")
    if state_mode == "slots":
        if evict_top not in (None, 0):
            raise ValueError(
                f"evict_top={evict_top} is not supported with "
                f"state_mode='slots': the precomputed victim order breaks "
                f"ties by slot, not by object id; the slot engine pins "
                f"evict_top=0 (the id-tiebroken argmin, bitwise identical "
                f"in dense results)")
    elif n_slots is not None:
        raise ValueError("n_slots applies only with state_mode='slots'")


def simulate_stream(stream: RequestStream, capacity: float,
                    policy: str = "stoch_vacdh",
                    params: PolicyParams | None = None, key=(0, 0),
                    estimate_z: bool = False, use_kernel=None,
                    chunk_size: int | str | None = 65536,
                    rebase: bool = True, evict_top: int | None = None,
                    state_mode: str = "dense", n_slots: int | None = None,
                    slot_seed: int = 0, device=None,
                    counters: dict | None = None) -> SimResult:
    """Run one policy over a host-resident stream, one chunk at a time, on
    ``device`` (None: the card).

    Only the ``[N]`` object columns go to the device; the engine reads each
    chunk's requests from the host arrays, so the request axis is never
    uploaded.  ``rebase=True`` (the long-trace default) hands the engine
    each chunk's f64 times as f32 offsets from the chunk's first time and
    shifts the carried state's absolute times, on the card and in the host
    heap of completion times, by the f64 step between bases rounded to f32
    (:func:`stream_chunks`): precision is then set by the chunk's span, not
    the trace's, and the replay is shift-invariant bit for bit.
    ``rebase=False`` feeds absolute f32 times and is bitwise identical to
    :func:`simulate`.  ``chunk_size='auto'`` picks
    :func:`repro_torch.core.trace.auto_chunk_size`.

    Unlike the reference there are no padded tail steps (its pad exists
    to share one compiled graph; this loop stops at the last request) and
    no ``prefetch`` argument (there is no device queue to double-buffer:
    the host walks the requests itself).

    ``state_mode='slots'`` replays through a hashed open-addressing table
    of ``n_slots`` slots (None: :func:`repro_torch.core.state.
    slot_table_size` of the stream's distinct ids) instead of the dense
    ``[N]`` state; it equals dense mode bit for bit whenever the table
    never fills, whatever ``slot_seed`` (the hash seed).  It pins
    ``evict_top=0``: the eq.-16 lane scores through ``ranking_scores``,
    and every eviction is an argmin with ties broken by object id."""
    check_state_mode(state_mode, n_slots, evict_top)
    dev = resolve_device(device)
    check_policies((policy,))
    if params is None:
        params = PolicyParams()
    chunk_size = resolve_chunk_size(chunk_size, stream.n_requests)
    mode = resolve_score_mode(use_kernel, dev)
    times64 = np.asarray(stream.times, np.float64)
    objs = np.asarray(stream.objs, np.int32)
    z_draw = np.asarray(stream.z_draw, np.float32)
    if state_mode == "slots":
        if n_slots is None:
            n_slots = slot_table_size(int(np.unique(objs).size))
        eng = _SlotEngine(int(n_slots), slot_seed, stream.sizes,
                          stream.z_mean, capacity, policy, params, key,
                          estimate_z, mode, dev)
    else:
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                        device=dev)
        eng = _Engine(f32(stream.sizes), f32(stream.z_mean), capacity,
                      (policy,), (params,), (key,), estimate_z, mode,
                      evict_top)
    for lo, hi, t_loc, delta in stream_chunks(times64, chunk_size, rebase):
        eng.shift(delta)
        eng.feed(t_loc, objs[lo:hi], z_draw[lo:hi])
    res = eng.result()[0]
    add_counters(counters, [eng])
    return res


def simulate_chunked(trace: Trace, capacity: float,
                     policy: str = "stoch_vacdh",
                     params: PolicyParams | None = None, key=(0, 0),
                     estimate_z: bool = False, use_kernel=None,
                     chunk_size: int = 65536,
                     evict_top: int | None = None,
                     state_mode: str = "dense", n_slots: int | None = None,
                     slot_seed: int = 0, device=None,
                     counters: dict | None = None) -> SimResult:
    """:func:`simulate` fed chunk by chunk: ``simulate_stream(
    stream_of_trace(trace), rebase=False)``, bitwise equal to
    :func:`simulate` at every chunk size."""
    return simulate_stream(stream_of_trace(trace), capacity, policy, params,
                           key, estimate_z, use_kernel, chunk_size,
                           rebase=False, evict_top=evict_top,
                           state_mode=state_mode, n_slots=n_slots,
                           slot_seed=slot_seed, device=device,
                           counters=counters)
