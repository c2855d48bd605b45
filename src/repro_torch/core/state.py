"""Simulator state for the delayed-hit cache: dense struct-of-arrays.

Every per-object field is an ``[L, N]`` tensor: ``L`` lanes (independent
simulations that share one trace, e.g. a policy and its LRU baseline) over a
universe of ``N`` objects.  The twelve f32 fields are views into one
``values [12, L, N]`` tensor and the two bool fields into one
``flags [2, L, N]`` tensor, so a point update of every field of every lane
is one launch of the lane-scatter kernel over the ``[12 * L, N]`` view
(:mod:`repro_torch.kernels.lane_scatter`).

The per-lane scalars (free capacity, clocks, Kahan sums, counters) are f32
``[L]`` tensors on the host: the simulator's control flow reads them every
request, and keeping them there saves a device round trip each time.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

INF = float("inf")

# Order of the f32 fields in SimState.values, and their initial values.
F32_FIELDS = ("complete_t", "issue_t", "last_access", "first_access",
              "gap_mean", "count", "z_est", "agg_sum", "agg_sq_sum",
              "agg_cnt", "episode_delay", "gd_h")
_F32_INIT = {"complete_t": INF, "last_access": -INF, "first_access": -INF}
# Order of the bool fields in SimState.flags.
BOOL_FIELDS = ("cached", "in_flight")

FIELD = {name: k for k, name in enumerate(F32_FIELDS)}


@dataclasses.dataclass
class ObjStats:
    """Per-object online statistics, each ``[L, N]`` (or ``[N]`` for one
    lane, or ``[L]`` gathered at one object per lane)."""

    cached: torch.Tensor         # bool: resident in cache
    in_flight: torch.Tensor      # bool: fetch outstanding
    complete_t: torch.Tensor     # f32: completion time of the outstanding fetch (inf if none)
    issue_t: torch.Tensor        # f32: time the outstanding fetch was issued
    last_access: torch.Tensor    # f32: time of the most recent request (-inf if never)
    first_access: torch.Tensor   # f32
    gap_mean: torch.Tensor       # f32: (windowed) mean inter-arrival time
    count: torch.Tensor          # f32: number of requests seen
    z_est: torch.Tensor          # f32: online estimate of the mean fetch latency
    agg_sum: torch.Tensor        # f32: sum of per-episode aggregate delays
    agg_sq_sum: torch.Tensor     # f32: sum of squared per-episode aggregate delays
    agg_cnt: torch.Tensor        # f32: number of completed miss episodes
    episode_delay: torch.Tensor  # f32: aggregate delay of the episode in flight
    gd_h: torch.Tensor           # f32: GreedyDual H value (MAD-style policies)

    def lane(self, li: int) -> "ObjStats":
        """Lane ``li`` as ``[N]`` views (shares storage)."""
        return ObjStats(**{f.name: getattr(self, f.name)[li]
                           for f in dataclasses.fields(self)})


@dataclasses.dataclass
class SimState:
    """Per-object statistics on the device plus per-lane host scalars."""

    values: torch.Tensor         # f32 [12, L, N], fields in F32_FIELDS order
    flags: torch.Tensor          # bool [2, L, N], fields in BOOL_FIELDS order
    free: torch.Tensor           # f32 [L] (host): free cache capacity
    gd_clock: torch.Tensor       # f32 [L] (host): GreedyDual inflation clock
    min_complete: torch.Tensor   # f32 [L] (host): min complete_t in flight
    lat_sum: torch.Tensor        # f32 [L] (host): Kahan-compensated latency
    lat_comp: torch.Tensor       # f32 [L] (host): Kahan compensation term
    n_hits: torch.Tensor         # f32 [L] (host) outcome counters
    n_delayed: torch.Tensor
    n_misses: torch.Tensor
    n_evictions: torch.Tensor

    @property
    def obj(self) -> ObjStats:
        """The fields as ``[L, N]`` views of ``values`` and ``flags``."""
        views = {n: self.values[k] for k, n in enumerate(F32_FIELDS)}
        views.update({n: self.flags[k] for k, n in enumerate(BOOL_FIELDS)})
        return ObjStats(**views)


def init_state(n_objects: int, capacity, z_prior: torch.Tensor,
               n_lanes: int = 1, device=None) -> SimState:
    """Fresh state for ``n_lanes`` lanes over ``n_objects`` objects.

    ``capacity`` is one size for every lane or one per lane, rounded to
    f32.  ``z_prior`` [N] seeds every lane's per-object latency estimate
    (the known mean of the fetch-latency model, as in the paper's
    setup)."""
    dev = torch.device(device) if device is not None else z_prior.device
    values = torch.zeros((len(F32_FIELDS), n_lanes, n_objects),
                         dtype=torch.float32, device=dev)
    for name, v in _F32_INIT.items():
        values[FIELD[name]].fill_(v)
    values[FIELD["z_est"]].copy_(
        z_prior.to(device=dev, dtype=torch.float32).reshape(1, n_objects)
        .expand(n_lanes, n_objects))
    flags = torch.zeros((len(BOOL_FIELDS), n_lanes, n_objects),
                        dtype=torch.bool, device=dev)
    s = lambda v: torch.full((n_lanes,), v, dtype=torch.float32)
    free = torch.from_numpy(np.broadcast_to(
        np.asarray(capacity, np.float32), (n_lanes,)).copy())
    return SimState(values=values, flags=flags, free=free,
                    gd_clock=s(0.0), min_complete=s(INF), lat_sum=s(0.0),
                    lat_comp=s(0.0), n_hits=s(0.0), n_delayed=s(0.0),
                    n_misses=s(0.0), n_evictions=s(0.0))


def shift_times(state: SimState, delta: float) -> SimState:
    """Rebase every absolute-time field by ``-delta``, in place.

    Only time points shift; durations, latency sums and the GreedyDual
    clock are shift-invariant.  ``delta == 0.0`` is a bitwise no-op."""
    for name in ("complete_t", "issue_t", "last_access", "first_access"):
        state.values[FIELD[name]].sub_(delta)
    state.min_complete.sub_(delta)
    return state


def kahan_add(total, comp, x):
    """Compensated accumulation; keeps long f32 sums exact to ~1 ulp.
    Four separate f32 operations in this order (tensors or f32 arrays)."""
    y = x - comp
    t = total + y
    comp = (t - total) - y
    return t, comp
