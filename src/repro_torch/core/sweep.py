"""Scenario grids: traces x policies x PolicyParams x capacities x seeds.

:func:`sweep_grid` runs one simulator engine per trace whose lanes are the
flattened policies x params x capacities x seeds (policy-major, as the
reference flattens them), each lane with its own policy, params, capacity
and coin key.  Lanes run in lockstep and never interact, so every point
equals its single-lane :func:`repro_torch.core.simulator.simulate` bit for
bit.  The trace axis is a host loop: each trace has its own object sizes
and latency means, and one engine serves one request sequence.

Arguments of the reference that are not taken: ``lane_bucket`` (padding
lanes to share a compiled graph), ``update`` and ``commit_mode`` (XLA
lowerings of the state update and of multi-policy commits).  The port has
one dispatch, so none of them has anything to choose.  ``devices=`` /
``mesh=`` (the multi-device fabric) raise until it is ported.

:func:`sweep_hier_grid` runs hierarchy grids (traces x L1 policies x params
x L1 capacities x L2 capacities x seeds) the same way: per request
sequence one L1 engine whose lanes are every point's shards and one L2
engine whose lanes are the points (:mod:`repro_torch.core.hierarchy`).
Traces that differ only in their hop draws (the hop-law axis of fig6)
share one engine pair, each lane reading its own trace's hops.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .._device import resolve_device
from . import prng
from .distributions import MonteCarlo
from .hierarchy import (HierResult, HierTrace, _Hier, check_shards,
                        host_columns, plain_writes_of, run_hier,
                        same_requests)
from .ranking import POLICIES, PolicyParams
from .simulator import (SimResult, _Engine, _trace_on, add_counters,
                        host_requests, resolve_score_mode)
from .trace import Trace

__all__ = ["HierSweepGrid", "SweepGrid", "sweep_grid", "sweep_hier_grid"]

_FIELDS = tuple(f.name for f in dataclasses.fields(SimResult))


class SweepGrid(NamedTuple):
    """A swept result with its axes.  ``result`` is a :class:`SimResult`
    whose fields are f32 tensors shaped ``[n_traces, n_policies,
    n_params, n_capacities, n_seeds]``."""

    result: SimResult
    policies: Sequence[str]
    params: Sequence[PolicyParams]
    capacities: torch.Tensor
    seeds: Sequence[int]

    def point(self, ti: int, li: int, pi: int, ci: int, si: int) -> SimResult:
        """The :class:`SimResult` of one grid point (0-d tensors)."""
        return SimResult(*(getattr(self.result, f)[ti, li, pi, ci, si]
                           for f in _FIELDS))


def _structure(p: PolicyParams):
    """What the reference's pytree treats as static: the distribution's
    class and its non-numeric fields (every field of a MonteCarlo law)."""
    d = p.dist
    fields = [f.name for f in dataclasses.fields(d)]
    if not isinstance(d, MonteCarlo):
        fields = [n for n in fields
                  if not isinstance(getattr(d, n), (int, float))]
    return (type(d).__name__, tuple((n, getattr(d, n)) for n in fields))


def _count(counters, eng) -> None:
    add_counters(counters, [eng])
    if counters is not None:
        counters["lane_requests"] = (counters.get("lane_requests", 0)
                                     + eng.L * eng.requests)


def _check_axes(policies, params):
    """``(policy_names, params_list)``, or the reference's two errors."""
    names = (policies,) if isinstance(policies, str) else tuple(policies)
    unknown = [n for n in names if n not in POLICIES]
    if unknown:
        raise ValueError(f"unknown policies {unknown}; known: "
                         f"{sorted(POLICIES)}")
    params_list = ([params] if isinstance(params, PolicyParams)
                   else list(params))
    structs = {_structure(p) for p in params_list}
    if len(structs) != 1:
        raise ValueError(
            "all PolicyParams in a sweep must share static structure "
            f"(distribution type); got {structs}")
    return names, params_list


def sweep_grid(traces, capacities, policies,
               params=PolicyParams(), seeds=(0,),
               estimate_z: bool = False, use_kernel=None,
               chunk_size: int | None = None,
               state_mode: str = "dense",
               devices: int | None = None, mesh=None, device=None,
               counters: dict | None = None) -> SweepGrid:
    """Run the grid traces x policies x params x capacities x seeds on
    ``device`` (None: the card).

    traces      one :class:`Trace` or a sequence of them (each its own
                engine; they need not share a shape).
    capacities  a scalar or a sequence, rounded to f32.
    policies    one policy name or a sequence of names.
    params      one :class:`PolicyParams` or a sequence sharing one static
                structure (the distribution's class and non-numeric fields).
    seeds       coin seeds: seed ``s`` is ``jax.random.key(s)``'s key data
                (:func:`repro_torch.core.prng.key_data`).
    use_kernel  resolved as in :func:`simulate`, per lane: every
                ``stoch_vacdh`` lane with an Exponential law is scored by
                the eq.-16 kernels (plain versions on the CPU), in
                multi-policy grids too.  The reference allows kernels only
                in single-policy grids, a limit of its static
                specialization that this engine does not have.
    chunk_size  feed every engine the same chunks of each trace in turn
                (no rebasing); bitwise equal to the unchunked grid.
    state_mode  'dense' only: slot tables are not batched (ValueError, as
                in the reference).
    counters    accumulates requests, syncs, commits and scoring commits
                over the engines, and ``lane_requests`` (requests times
                lanes).

    Each point is bitwise equal to the single-lane :func:`simulate` call
    at the same trace, policy, params, capacity and key.
    """
    trace_list = [traces] if isinstance(traces, Trace) else list(traces)
    names, params_list = _check_axes(policies, params)
    caps = np.atleast_1d(np.asarray(capacities, np.float32))
    seeds = tuple(int(s) for s in np.atleast_1d(np.asarray(seeds)))
    if state_mode != "dense":
        if state_mode == "slots":
            raise ValueError(
                "state_mode='slots' is not supported by sweep_grid: its "
                "lanes batch dense [N]-state lane axes only; run slot-table "
                "replays through simulate_stream")
        raise ValueError(f"state_mode={state_mode!r}; expected 'dense'")
    if devices is not None or mesh is not None:
        raise NotImplementedError(
            "devices= / mesh= (the multi-device sweep fabric) are not "
            "ported yet: ROADMAP queue 1, item 9")
    if chunk_size is not None and chunk_size < 1:
        raise ValueError(f"chunk_size={chunk_size} must be >= 1")
    dev = resolve_device(device)
    mode = resolve_score_mode(use_kernel, dev)

    dims = (len(names), len(params_list), caps.shape[0], len(seeds))
    lane_idx = [g.ravel() for g in np.meshgrid(
        *[np.arange(d) for d in dims], indexing="ij")]
    lanes = dict(
        policies=tuple(names[i] for i in lane_idx[0]),
        params=tuple(params_list[i] for i in lane_idx[1]),
        capacities=caps[lane_idx[2]],
        keys=tuple(prng.key_data(seeds[i]) for i in lane_idx[3]))
    trace_list = [_trace_on(tr, dev) for tr in trace_list]
    make = lambda tr: _Engine(tr.sizes, tr.z_mean, estimate_z=estimate_z,
                              score_mode=mode, evict_top=None, **lanes)
    results = []
    if chunk_size is None:
        for tr in trace_list:          # one engine's state at a time
            eng = make(tr)
            eng.feed(*host_requests(tr))
            results.append(eng.result())
            _count(counters, eng)
    else:
        engines = [make(tr) for tr in trace_list]
        n_max = max(tr.n_requests for tr in trace_list)
        for lo in range(0, n_max, chunk_size):
            for tr, eng in zip(trace_list, engines):
                if lo < tr.n_requests:
                    eng.feed(*host_requests(tr, lo, lo + chunk_size))
        for eng in engines:
            results.append(eng.result())
            _count(counters, eng)
    shape = (len(trace_list),) + dims
    res = SimResult(*(
        torch.stack([getattr(r, f) for rs in results for r in rs])
        .reshape(shape) for f in _FIELDS))
    return SweepGrid(res, names, tuple(params_list), torch.from_numpy(caps),
                     seeds)


# ---------------------------------------------------------------------------
# Hierarchy grids
# ---------------------------------------------------------------------------
class HierSweepGrid(NamedTuple):
    """A swept hierarchy result with its axes.  ``result`` fields are
    shaped ``[n_traces, n_policies, n_params, n_l1_capacities,
    n_l2_capacities, n_seeds]``; the ``per_shard`` fields carry a trailing
    ``[n_shards]`` axis."""

    result: HierResult
    policies: Sequence[str]
    params: Sequence[PolicyParams]
    l1_capacities: torch.Tensor
    l2_capacities: torch.Tensor
    seeds: Sequence[int]
    n_shards: int

    def point(self, ti: int, li: int, pi: int, c1: int, c2: int,
              si: int) -> HierResult:
        """The :class:`HierResult` of one grid point."""
        ix = (ti, li, pi, c1, c2, si)
        return HierResult(
            per_shard=SimResult(*(getattr(self.result.per_shard, f)[ix]
                                  for f in _FIELDS)),
            l2=SimResult(*(getattr(self.result.l2, f)[ix]
                           for f in _FIELDS)))


def sweep_hier_grid(traces, n_shards: int, l1_capacities, l2_capacities,
                    policies, params=PolicyParams(), seeds=(0,),
                    l2_policy: str = "lru",
                    l2_params: PolicyParams | None = None,
                    estimate_z: bool = True, use_kernel=None,
                    devices: int | None = None, mesh=None, device=None,
                    counters: dict | None = None) -> HierSweepGrid:
    """Run a hierarchy grid on ``device`` (None: the card).

    traces         one :class:`HierTrace` or a sequence of them (e.g. one
                   base trace under several hop laws).
    n_shards       the L1 shard count (every trace must route within it).
    l1_capacities  per-shard L1 capacities; ``l2_capacities`` the shared
                   L2's (scalars or sequences, rounded to f32).
    policies       L1 policy name(s); ``l2_policy`` the one L2 policy, and
                   ``l2_params`` its params (default: stock, decoupled
                   from the swept ``params`` as in :func:`simulate_hier`).
    seeds          seed ``s`` is ``jax.random.key(s)``'s key data, split
                   per shard and for the L2.
    use_kernel     the writes, as in :func:`simulate_hier`.
    counters       accumulates requests, syncs, commits, scoring commits
                   and ``lane_requests`` (requests times points).

    Each point equals its :func:`repro_torch.core.hierarchy.simulate_hier`
    call bit for bit."""
    trace_list = ([traces] if isinstance(traces, HierTrace)
                  else list(traces))
    names, params_list = _check_axes(policies, params)
    if l2_policy not in POLICIES:
        raise ValueError(f"unknown policies [{l2_policy!r}]; known: "
                         f"{sorted(POLICIES)}")
    for tr in trace_list:
        check_shards(tr, n_shards)
    if devices is not None or mesh is not None:
        raise NotImplementedError(
            "devices= / mesh= (the multi-device sweep fabric) are not "
            "ported yet: ROADMAP queue 1, item 9")
    l2_params = PolicyParams() if l2_params is None else l2_params
    c1 = np.atleast_1d(np.asarray(l1_capacities, np.float32))
    c2 = np.atleast_1d(np.asarray(l2_capacities, np.float32))
    seeds = tuple(int(s) for s in np.atleast_1d(np.asarray(seeds)))
    dev = resolve_device(device)
    plain = plain_writes_of(use_kernel, dev)

    dims = (len(names), len(params_list), c1.shape[0], c2.shape[0],
            len(seeds))
    idx = [g.ravel() for g in np.meshgrid(
        *[np.arange(d) for d in dims], indexing="ij")]
    n_pts = idx[0].shape[0]
    trace_list = [tr if tr.device == dev else tr.to(dev)
                  for tr in trace_list]
    groups = []                          # traces that share one engine pair
    for ti, tr in enumerate(trace_list):
        for grp in groups:
            if same_requests(trace_list[grp[0]], tr):
                grp.append(ti)
                break
        else:
            groups.append([ti])

    out = [None] * len(trace_list)
    for grp in groups:
        tr = trace_list[grp[0]]
        # points major, the group's traces minor
        rep = lambda a: np.repeat(a, len(grp))
        hier = _Hier(tr.sizes, tr.z_mean, tr.hop_mean, int(n_shards),
                     tuple(names[i] for i in rep(idx[0])),
                     tuple(params_list[i] for i in rep(idx[1])),
                     c1[rep(idx[2])], c2[rep(idx[3])],
                     tuple(prng.key_data(seeds[i]) for i in rep(idx[4])),
                     np.tile(np.arange(len(grp)), n_pts), l2_policy,
                     l2_params, estimate_z, plain)
        *cols, _ = host_columns(tr)
        hops = np.stack([trace_list[ti].hop_draw.cpu().numpy()
                         for ti in grp]).astype(np.float32, copy=False)
        run_hier(hier, cols, hops, None)
        add_counters(counters, [hier.l1, hier.l2])
        if counters is not None:
            counters["lane_requests"] = (counters.get("lane_requests", 0)
                                         + hier.G * tr.n_requests)
        res = hier.results()
        for k, ti in enumerate(grp):
            out[ti] = res[k::len(grp)]

    shape = (len(trace_list),) + dims
    stack = lambda tier, f: torch.stack([
        getattr(getattr(r, tier), f) for rs in out for r in rs])
    per_shard = SimResult(*(stack("per_shard", f).reshape(shape + (
        int(n_shards),)) for f in _FIELDS))
    l2 = SimResult(*(stack("l2", f).reshape(shape) for f in _FIELDS))
    return HierSweepGrid(HierResult(per_shard=per_shard, l2=l2), names,
                         tuple(params_list), torch.from_numpy(c1),
                         torch.from_numpy(c2), seeds, int(n_shards))
