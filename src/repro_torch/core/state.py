"""Simulator state for the delayed-hit cache: dense struct-of-arrays, and
the slot table that maps raw object ids onto a smaller state.

Every per-object field is an ``[L, N]`` tensor: ``L`` lanes (independent
simulations that share one trace, e.g. a policy and its LRU baseline) over a
universe of ``N`` objects.  The twelve f32 fields are views into one
``values [12, L, N]`` tensor and the two bool fields into one
``flags [2, L, N]`` tensor, so the point updates of every field of every
lane are one launch of the point-update journal's kernel
(:mod:`repro_torch.kernels.point_update`).

The per-lane scalars (free capacity, clocks, Kahan sums, counters) are f32
``[L]`` tensors on the host: the simulator's control flow reads them every
request, and keeping them there saves a device round trip each time.

The slot table (:class:`SlotState`) is a fixed open-addressing table of
``S`` slots over the same dense machinery: objects insert on first touch
and keep their slot, so an ``[S]`` state replays a key space far larger
than the device could hold densely.  Its hash (:func:`_hash_u32`), home
slot and linear probe equal the JAX package's bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device

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


_TINY = {}      # dtype -> its smallest normal value


def flush_subnormals(x):
    """``x`` (a tensor or a numpy array) with its subnormal entries read as
    zero, in its own dtype: the rule XLA follows on the CPU and the TPU
    (flush-to-zero, denormals-are-zero), which the reference's results
    carry."""
    if isinstance(x, torch.Tensor):
        return x * (x.abs() >= torch.finfo(x.dtype).tiny)
    x = np.asarray(x)
    tiny = _TINY.get(x.dtype)
    if tiny is None:
        tiny = _TINY[x.dtype] = np.finfo(x.dtype).tiny
    return x * (np.abs(x) >= tiny)


def kahan_add(total, comp, x):
    """Compensated accumulation; keeps long f32 sums exact to ~1 ulp.
    Four separate f32 operations in this order (tensors or f32 arrays),
    each input and result flushed as the reference's are
    (:func:`flush_subnormals`)."""
    total, comp, x = (flush_subnormals(v) for v in (total, comp, x))
    y = flush_subnormals(x - comp)
    t = flush_subnormals(total + y)
    comp = flush_subnormals(flush_subnormals(t - total) - y)
    return t, comp


# ---------------------------------------------------------------------------
# The slot table: raw object ids onto S slots.  Slots are never vacated,
# only reclaimed in place under table-full pressure, so the linear-probing
# invariant holds and a table sized to the touched keys never reclaims.
# ---------------------------------------------------------------------------
SLOT_EMPTY = -1          # key_tab sentinel: no object resides in this slot
_M32 = 0xFFFFFFFF


def _hash_u32(x, seed) -> np.ndarray:
    """The lowbias32 avalanche finalizer of ``x`` (ids, wrapped to uint32)
    xor ``seed``, in uint32 arithmetic: a uint32 array shaped as ``x``."""
    x = np.asarray(x).astype(np.uint32) ^ np.uint32(int(seed) & _M32)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
        x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def slot_home(obj, seed, n_slots: int) -> np.ndarray:
    """The probe start slot of ``obj`` (int32, shaped as ``obj``)."""
    return (_hash_u32(obj, seed) % np.uint32(n_slots)).astype(np.int32)


def slot_probe(key_tab, obj: int, seed):
    """Linear-probe lookup in the host table ``key_tab`` (int32 [S]):
    ``(slot, found, empty)``.

    Walks from the home slot until it meets ``obj`` (``found``) or the
    first empty slot (``empty``, the insertion point).  A full wrap with
    neither means the table is full: both flags are False and ``slot`` is
    the home slot."""
    tab = np.asarray(key_tab)
    n = tab.shape[0]
    s = int(slot_home(obj, seed, n))
    for _ in range(n):
        k = int(tab[s])
        if k == obj or k == SLOT_EMPTY:
            return s, k == obj, k == SLOT_EMPTY
        s = s + 1 if s + 1 < n else 0
    return s, False, False


def slot_table_size(n_distinct: int, load: float = 0.5) -> int:
    """The next power of two holding ``n_distinct`` keys at most at
    ``load`` occupancy (floor 64).  At the default 0.5 the table always has
    headroom, so reclaim never fires and slot-mode results equal dense mode
    bit for bit."""
    if n_distinct < 0:
        raise ValueError(f"n_distinct={n_distinct} must be >= 0")
    if not 0.0 < load <= 1.0:
        raise ValueError(f"load={load} must be in (0, 1]")
    need = max(-(-n_distinct // load) if n_distinct else 1, 1)
    return 1 << max(6, (int(need) - 1).bit_length())


@dataclasses.dataclass
class SlotView:
    """The id->slot map beside an ``[S]`` :class:`SimState`, on the
    device: the scoring pass reads the per-slot sizes, and the slot
    engine's id tie-break (:func:`repro_torch.kernels.ref.
    tiebreak_argmin_ref`) reads the ids."""

    key_tab: torch.Tensor        # int32 [S]: object id in each slot (SLOT_EMPTY: none)
    sizes: torch.Tensor          # f32 [S]: that object's size (0 while empty)
    seed: int                    # uint32 hash seed (invisible in results)


@dataclasses.dataclass
class SlotState:
    """A dense one-lane :class:`SimState` over ``S`` slots and the
    :class:`SlotView` that maps raw ids onto them."""

    sim: SimState
    tab: SlotView


def init_slot_state(n_slots: int, capacity, seed: int = 0,
                    device=None) -> SlotState:
    """A fresh one-lane slot state with an all-empty table on ``device``
    (None: the card).  Per-slot ``z_est`` is written at insertion, from
    the inserted object's prior (the value dense mode starts from)."""
    if n_slots < 1:
        raise ValueError(f"n_slots={n_slots} must be >= 1")
    dev = resolve_device(device)
    zeros = torch.zeros(n_slots, dtype=torch.float32, device=dev)
    sim = init_state(n_slots, capacity, zeros, 1, dev)
    tab = SlotView(key_tab=torch.full((n_slots,), SLOT_EMPTY,
                                      dtype=torch.int32, device=dev),
                   sizes=zeros.clone(), seed=int(seed) & _M32)
    return SlotState(sim=sim, tab=tab)
