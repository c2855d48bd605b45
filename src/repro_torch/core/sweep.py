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
``mesh=`` split the lanes over a device mesh, one worker process a device
(:mod:`repro_torch.launch.fabric`); the results are the in-process grid's
bit for bit.

:func:`sweep_hier_grid` runs hierarchy grids (traces x L1 policies x params
x L1 capacities x L2 capacities x seeds) the same way: per request
sequence one L1 engine whose lanes are every point's shards and one L2
engine whose lanes are the points (:mod:`repro_torch.core.hierarchy`).
Traces that differ only in their hop draws (the hop-law axis of fig6)
share one engine pair, each lane reading its own trace's hops.  Through
the fabric its points are split, each point with its whole trace group.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..launch.fabric import lane_blocks, resolve_fabric, run_shards
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


def _lane_results(arr: np.ndarray) -> list[SimResult]:
    """An f32 ``[n_fields, lanes]`` host array as one 0-d-field
    :class:`SimResult` a lane."""
    t = torch.from_numpy(arr)
    return [SimResult(*(t[fi, li] for fi in range(len(_FIELDS))))
            for li in range(arr.shape[1])]


def _host_fields(results) -> np.ndarray:
    """Per-lane :class:`SimResult` objects as one host f32 ``[n_fields,
    lanes, ...]`` array (fields in :class:`SimResult` order)."""
    return np.stack([torch.stack([getattr(r, f) for r in results])
                     .cpu().numpy() for f in _FIELDS])


def _grid_lanes(dev, traces, lanes: dict, estimate_z: bool, mode: str,
                counters) -> list[list[SimResult]]:
    """A flat grid's engine loop over one block of lanes on ``dev``: one
    engine a trace, one engine's state at a time.  ``traces`` yields each
    trace's ``(sizes, z_mean, times, objs, z_draw)``: two tensors or host
    arrays, then the host request columns; ``lanes`` holds the block's
    policies, params, capacities and keys.  Returns per trace one
    :class:`SimResult` a lane."""
    results = []
    for sizes, z_mean, *cols in traces:
        eng = _Engine(torch.as_tensor(sizes, device=dev),
                      torch.as_tensor(z_mean, device=dev),
                      estimate_z=estimate_z, score_mode=mode,
                      evict_top=None, **lanes)
        eng.feed(*cols)
        results.append(eng.result())
        _count(counters, eng)
    return results


def _grid_shard(dev, traces, lanes: dict, estimate_z: bool, mode: str):
    """A fabric worker's task (:func:`repro_torch.launch.fabric.
    run_shards`): :func:`_grid_lanes` over the worker's block, returning
    (per trace an f32 ``[n_fields, lanes]`` host array, the engines'
    summed counters)."""
    stats = {}
    res = _grid_lanes(dev, traces, lanes, estimate_z, mode, stats)
    return [_host_fields(rs) for rs in res], stats


def _fabric_grid(fab, trace_list, lanes: dict, estimate_z: bool, mode: str,
                 counters) -> list[list[SimResult]]:
    """Run a flat grid's lanes in blocks over the mesh ``fab``: per trace,
    one :class:`SimResult` a lane, in the in-process order."""
    traces = [(tr.sizes.cpu().numpy(), tr.z_mean.cpu().numpy(),
               *host_requests(tr)) for tr in trace_list]
    payloads = []
    for blk in lane_blocks(len(lanes["policies"]), fab.size):
        payloads.append(None if blk.start == blk.stop else (
            traces, {k: v[blk] for k, v in lanes.items()}, estimate_z,
            mode))
    outs = [o for o in run_shards(fab, _grid_shard, payloads, counters)
            if o is not None]
    return [_lane_results(np.concatenate([o[ti] for o in outs], axis=1))
            for ti in range(len(trace_list))]


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
    devices     split the lanes over this many devices, one worker
                process each (:mod:`repro_torch.launch.fabric`): CUDA
                devices, or CPU workers with ``device="cpu"``.  None or 1
                runs in this process.
    mesh        an explicit 1-D ``data`` mesh
                (:func:`repro_torch.launch.mesh.make_data_mesh`) instead of
                ``devices``; always routes through the fabric, even with one
                device.  Neither may be combined with ``chunk_size``.
    counters    accumulates requests, syncs, commits and scoring commits
                over the engines, and ``lane_requests`` (requests times
                lanes).  Through the fabric it sums the workers'
                engines: ``requests`` (counted once) and
                ``lane_requests`` do not depend on the device count;
                ``syncs``, ``commits`` and ``scoring_commits`` grow with
                the number of engines (a lockstep commit or read-back
                counts once an engine, for all its lanes).  It also gains
                the workers' kernel ``launches`` (a dict by kernel),
                ``workers`` and ``worker_start_s``.

    Each point is bitwise equal to the single-lane :func:`simulate` call
    at the same trace, policy, params, capacity and key, whatever the
    device count and the lane-to-device assignment.
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
    fab = resolve_fabric(devices, mesh, device)
    if chunk_size is not None:
        if fab is not None:
            raise ValueError(
                "chunk_size is not supported with devices=/mesh=: the "
                "fabric's workers replay whole traces")
        if chunk_size < 1:
            raise ValueError(f"chunk_size={chunk_size} must be >= 1")
    dev = resolve_device(device) if fab is None else fab.devices[0]
    mode = resolve_score_mode(use_kernel, dev)

    dims = (len(names), len(params_list), caps.shape[0], len(seeds))
    lane_idx = [g.ravel() for g in np.meshgrid(
        *[np.arange(d) for d in dims], indexing="ij")]
    lanes = dict(
        policies=tuple(names[i] for i in lane_idx[0]),
        params=tuple(params_list[i] for i in lane_idx[1]),
        capacities=caps[lane_idx[2]],
        keys=tuple(prng.key_data(seeds[i]) for i in lane_idx[3]))
    if fab is not None:
        results = _fabric_grid(fab, trace_list, lanes, estimate_z, mode,
                               counters)
    elif chunk_size is None:
        results = _grid_lanes(
            dev, ((tr.sizes, tr.z_mean, *host_requests(tr))
                  for tr in trace_list), lanes, estimate_z, mode, counters)
    else:
        trace_list = [_trace_on(tr, dev) for tr in trace_list]
        engines = [_Engine(tr.sizes, tr.z_mean, estimate_z=estimate_z,
                           score_mode=mode, evict_top=None, **lanes)
                   for tr in trace_list]
        n_max = max(tr.n_requests for tr in trace_list)
        for lo in range(0, n_max, chunk_size):
            for tr, eng in zip(trace_list, engines):
                if lo < tr.n_requests:
                    eng.feed(*host_requests(tr, lo, lo + chunk_size))
        results = []
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


def _hier_points(dev, groups, n_shards: int, l2_policy: str, l2_params,
                 estimate_z: bool, plain: bool, counters) -> list[list]:
    """A hierarchy grid's engine loop over one block of points on ``dev``:
    one engine pair a trace group.  ``groups`` yields each group's
    ``(sizes, z_mean, hop_mean, cols, hops, spec)``: two tensors or host
    arrays, the hop mean, the host request columns (times, objs, shards,
    z_draw), the group's ``[H, T]`` hop table and the ``_Hier`` lanes of
    the block's points.  Returns per group the pair's
    :class:`HierResult` objects, points major, the group's traces minor."""
    out = []
    for sizes, z_mean, hop_mean, cols, hops, spec in groups:
        hier = _Hier(torch.as_tensor(sizes, device=dev),
                     torch.as_tensor(z_mean, device=dev), hop_mean,
                     n_shards, spec["policies"], spec["params"],
                     spec["l1_caps"], spec["l2_caps"], spec["keys"],
                     spec["hop_rows"], l2_policy, l2_params, estimate_z,
                     plain)
        run_hier(hier, cols, hops, None)
        add_counters(counters, [hier.l1, hier.l2])
        if counters is not None:
            counters["lane_requests"] = (counters.get("lane_requests", 0)
                                         + hier.G * cols[0].shape[0])
        out.append(hier.results())
    return out


def _hier_shard(dev, groups, n_shards: int, l2_policy: str, l2_params,
                estimate_z: bool, plain: bool):
    """A fabric worker's task: :func:`_hier_points` over the worker's
    block, returning (per group f32 ``[n_fields, lanes, n_shards]`` and
    ``[n_fields, lanes]`` host arrays, the engines' summed counters)."""
    stats = {}
    res = _hier_points(dev, groups, n_shards, l2_policy, l2_params,
                       estimate_z, plain, stats)
    return [(_host_fields([r.per_shard for r in rs]),
             _host_fields([r.l2 for r in rs])) for rs in res], stats


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
    devices, mesh  split the points over a device mesh, as in
                   :func:`sweep_grid`; each point keeps its trace group
                   (the traces that share an engine pair) in one worker.
    counters       accumulates requests, syncs, commits, scoring commits
                   and ``lane_requests`` (requests times points); through
                   the fabric as in :func:`sweep_grid`.

    Each point equals its :func:`repro_torch.core.hierarchy.simulate_hier`
    call bit for bit, whatever the device count."""
    trace_list = ([traces] if isinstance(traces, HierTrace)
                  else list(traces))
    names, params_list = _check_axes(policies, params)
    if l2_policy not in POLICIES:
        raise ValueError(f"unknown policies [{l2_policy!r}]; known: "
                         f"{sorted(POLICIES)}")
    for tr in trace_list:
        check_shards(tr, n_shards)
    fab = resolve_fabric(devices, mesh, device)
    l2_params = PolicyParams() if l2_params is None else l2_params
    c1 = np.atleast_1d(np.asarray(l1_capacities, np.float32))
    c2 = np.atleast_1d(np.asarray(l2_capacities, np.float32))
    seeds = tuple(int(s) for s in np.atleast_1d(np.asarray(seeds)))
    dev = resolve_device(device) if fab is None else fab.devices[0]
    plain = plain_writes_of(use_kernel, dev)

    dims = (len(names), len(params_list), c1.shape[0], c2.shape[0],
            len(seeds))
    idx = [g.ravel() for g in np.meshgrid(
        *[np.arange(d) for d in dims], indexing="ij")]
    n_pts = idx[0].shape[0]
    home = dev if fab is None else torch.device("cpu")
    trace_list = [tr if tr.device == home else tr.to(home)
                  for tr in trace_list]
    groups = []                          # traces that share one engine pair
    for ti, tr in enumerate(trace_list):
        for grp in groups:
            if same_requests(trace_list[grp[0]], tr):
                grp.append(ti)
                break
        else:
            groups.append([ti])

    def spec(grp, pts):
        """The ``_Hier`` lanes of points ``pts`` for a trace group:
        points major, the group's traces minor."""
        rep = lambda a: np.repeat(a[pts], len(grp))
        return dict(policies=tuple(names[i] for i in rep(idx[0])),
                    params=tuple(params_list[i] for i in rep(idx[1])),
                    l1_caps=c1[rep(idx[2])], l2_caps=c2[rep(idx[3])],
                    keys=tuple(prng.key_data(seeds[i])
                               for i in rep(idx[4])),
                    hop_rows=np.tile(np.arange(len(grp)), len(pts)))

    def hop_table(grp):
        return np.stack([trace_list[ti].hop_draw.cpu().numpy()
                         for ti in grp]).astype(np.float32, copy=False)

    def host(grp):
        """A group's host inputs to :func:`_hier_points`, but its lanes."""
        tr = trace_list[grp[0]]
        *cols, _ = host_columns(tr)
        sizes, z_mean = ((tr.sizes.numpy(), tr.z_mean.numpy())
                         if fab is not None else (tr.sizes, tr.z_mean))
        return sizes, z_mean, tr.hop_mean, tuple(cols), hop_table(grp)

    if fab is not None:
        inputs = [host(grp) for grp in groups]
        payloads = [None if blk.start == blk.stop else (
            [(*h, spec(grp, np.arange(n_pts)[blk]))
             for h, grp in zip(inputs, groups)],
            int(n_shards), l2_policy, l2_params, estimate_z, plain)
            for blk in lane_blocks(n_pts, fab.size)]
        outs = [o for o in run_shards(fab, _hier_shard, payloads, counters)
                if o is not None]
        results = []
        for gi in range(len(groups)):
            ps = torch.from_numpy(np.concatenate([o[gi][0] for o in outs],
                                                 axis=1))
            l2 = _lane_results(np.concatenate([o[gi][1] for o in outs],
                                              axis=1))
            results.append([HierResult(per_shard=SimResult(*(
                ps[fi, li] for fi in range(len(_FIELDS)))), l2=l2[li])
                for li in range(ps.shape[1])])
    else:
        results = _hier_points(
            dev, ((*host(grp), spec(grp, np.arange(n_pts)))
                  for grp in groups), int(n_shards), l2_policy, l2_params,
            estimate_z, plain, counters)
    out = [None] * len(trace_list)
    for grp, res in zip(groups, results):
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
