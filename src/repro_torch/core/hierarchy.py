"""Two-tier sharded cache hierarchy: L1 edge shards fronting a shared L2.

Requests are routed across ``n_shards`` L1 caches (a consistent object
hash, or per-request random routing); each shard runs the full delayed-hit
machinery with its own policy state.  An L1 miss is an arrival at the
shared L2, itself a delayed-hit cache whose misses fetch from the origin.
The L1's fetch time is

    Z_L1 = hop + R_L2(t),    R_L2(t) in {0, l2_complete_t - t, Z_origin}

the round-trip hop plus the L2's resolution time at the arrival instant
(0 on an L2 hit, the residual fetch time on an L2 delayed hit, the origin
draw on an L2 miss).

The L1 shards are lanes of one simulator engine
(:class:`repro_torch.core.simulator._Engine`) and the L2 is a second
engine, so each tier runs the single-tier commit/serve code.  A request
commits the L2's due fetches, then the shards' in lockstep; reads the
owning shard's bits at the object from the L1 engine's host mirror and
takes the miss there; serves the L2 gated on that miss; then serves the
owning shard.  Neither read costs a sync.  The engines take ``[L]``
fetch times and an ``[L]`` active mask for that: a masked lane keeps its
point and its counters.

Both tiers score through the policies' epilogues, as the reference's
hierarchy does; ``use_kernel`` chooses only the writes (the point-update
journal's kernel, or its plain version).

Randomness (origin draws, hop draws, random routing) is pre-drawn into
:class:`HierTrace`, so a grid and its single runs see the same inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from . import prng
from .distributions import Deterministic, MissLatency
from .ranking import PolicyParams
from .simulator import (SimResult, _Engine, add_counters, check_policies,
                        resolve_score_mode)
from .trace import Trace

__all__ = ["HierTrace", "HierResult", "check_shards", "make_hier_trace",
           "simulate_hier", "simulate_hier_chunked"]

# Knuth's multiplicative hash, standing in for a consistent-hash ring; the
# shard is taken from the high bits of the 32-bit product.
_HASH_MULT = 2654435761
_M32 = 0xFFFFFFFF
_F = np.float32
_ZERO = _F(0.0)


@dataclasses.dataclass
class HierTrace:
    """A request trace annotated for the hierarchy (tensors on one device).

    times     f32[T]: non-decreasing request times
    objs      i32[T]: requested object ids
    shards    i32[T]: the L1 shard serving each request
    sizes     f32[N]: object sizes
    z_mean    f32[N]: mean origin fetch time per object
    z_draw    f32[T]: the origin fetch time if request k misses at the L2
    hop_draw  f32[T]: the L1<->L2 round trip if request k misses at its L1
    hop_mean  the mean hop (an f32 value; seeds the L1's z_est prior)
    """

    times: torch.Tensor
    objs: torch.Tensor
    shards: torch.Tensor
    sizes: torch.Tensor
    z_mean: torch.Tensor
    z_draw: torch.Tensor
    hop_draw: torch.Tensor
    hop_mean: float

    @property
    def n_requests(self) -> int:
        return self.times.shape[0]

    @property
    def n_objects(self) -> int:
        return self.sizes.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sizes.device

    def to(self, device) -> "HierTrace":
        return HierTrace(*(x.to(device) for x in (
            self.times, self.objs, self.shards, self.sizes, self.z_mean,
            self.z_draw, self.hop_draw)), self.hop_mean)


def hash_shards(objs: torch.Tensor, n_shards: int) -> torch.Tensor:
    """The ``hash`` route: the high 16 bits of the 32-bit product of each
    id and Knuth's multiplier, modulo ``n_shards`` (int32)."""
    x = objs.to(torch.int64) & _M32
    return ((((x * _HASH_MULT) & _M32) >> 16) % n_shards).to(torch.int32)


def make_hier_trace(trace: Trace, n_shards: int, *,
                    generator: torch.Generator | None = None,
                    hop_mean: float = 0.0,
                    hop_dist: MissLatency = Deterministic(),
                    route: str = "hash") -> HierTrace:
    """Annotate a single-tier :class:`Trace` for the hierarchy.

    route     'hash': every object lives on one shard (:func:`hash_shards`,
              the reference's bit for bit); 'random': uniform per-request
              routing drawn from ``generator``.
    hop_dist  the unit-mean law of the hop, scaled by ``hop_mean``, drawn
              from ``generator`` after the routing.
    ``generator`` (None: a CPU generator seeded 0) draws on its own
    device; the draws are placed on the trace's device."""
    g = torch.Generator().manual_seed(0) if generator is None else generator
    dev = trace.sizes.device
    n = trace.n_requests
    if route == "hash":
        shards = hash_shards(trace.objs, n_shards)
    elif route == "random":
        shards = torch.randint(0, n_shards, (n,), generator=g,
                               device=g.device, dtype=torch.int64)
    else:
        raise ValueError(f"unknown route {route!r}; expected 'hash'|'random'")
    hm = float(np.float32(hop_mean))
    hop = hop_dist.sample(g, torch.full((n,), hm, dtype=torch.float32,
                                        device=g.device))
    return HierTrace(trace.times, trace.objs.to(torch.int32),
                     shards.to(device=dev, dtype=torch.int32), trace.sizes,
                     trace.z_mean, trace.z_draw,
                     hop.to(device=dev, dtype=torch.float32), hm)


@dataclasses.dataclass
class HierResult:
    """Per-tier outcome.  ``per_shard`` fields carry a trailing
    ``[n_shards]`` axis (end-to-end latencies, as the requests see them);
    ``l2``'s ``total_latency`` sums the L2's resolution times (hop
    excluded)."""

    per_shard: SimResult
    l2: SimResult

    @property
    def total_latency(self):
        return self.per_shard.total_latency.sum(-1)

    @property
    def n_hits(self):
        return self.per_shard.n_hits.sum(-1)

    @property
    def n_delayed(self):
        return self.per_shard.n_delayed.sum(-1)

    @property
    def n_misses(self):
        return self.per_shard.n_misses.sum(-1)

    @property
    def n_requests(self):
        return self.n_hits + self.n_delayed + self.n_misses

    @property
    def mean_latency(self):
        return self.total_latency / torch.clamp(self.n_requests, min=1.0)

    @property
    def hit_ratio(self):
        return self.n_hits / torch.clamp(self.n_requests, min=1.0)


def check_shards(trace: HierTrace, n_shards: int) -> None:
    """Reject shard ids with no lane to serve them."""
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} must be >= 1")
    smax = int(trace.shards.max()) if trace.n_requests else -1
    if smax >= n_shards:
        raise ValueError(
            f"trace routes to shard {smax} but n_shards={n_shards}; "
            f"rebuild the trace with make_hier_trace(trace, {n_shards})")


def same_requests(a: HierTrace, b: HierTrace) -> bool:
    """Whether two traces differ at most in their hop draws (one engine
    pair can then run both, each lane with its own hops)."""
    return a.hop_mean == b.hop_mean and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in (
            (a.times, b.times), (a.objs, b.objs), (a.shards, b.shards),
            (a.sizes, b.sizes), (a.z_mean, b.z_mean),
            (a.z_draw, b.z_draw)))


class _Hier:
    """One hierarchy of ``G`` points over one request sequence: an L1
    engine of ``G * n_shards`` lanes (point-major) and an L2 engine of
    ``G`` lanes.  Point ``g`` runs L1 ``policies[g]`` under ``params[g]``
    at ``l1_caps[g]`` a shard and an L2 at ``l2_caps[g]``; its key is
    split into one per shard and one for the L2, as the reference's
    ``_hier_init`` does; its hops are row ``hop_rows[g]`` of the fed hop
    table."""

    def __init__(self, sizes: torch.Tensor, z_mean: torch.Tensor,
                 hop_mean: float, n_shards: int, policies, params,
                 l1_caps, l2_caps, keys, hop_rows, l2_policy: str,
                 l2_params: PolicyParams, estimate_z: bool,
                 plain_writes: bool):
        S = n_shards
        G = len(policies)
        split = [prng.split(k, S + 1) for k in keys]
        rep = lambda xs: tuple(x for x in xs for _ in range(S))
        l1_prior = torch.tensor(hop_mean, dtype=torch.float32,
                                device=sizes.device) + z_mean
        self.l1 = _Engine(sizes, l1_prior,
                          np.repeat(np.asarray(l1_caps, np.float32), S),
                          rep(policies), rep(params),
                          tuple(k for ks in split for k in ks[:S]),
                          estimate_z, "rank", None, plain_writes)
        self.l2 = _Engine(sizes, z_mean, np.asarray(l2_caps, np.float32),
                          (l2_policy,) * G, (l2_params,) * G,
                          tuple(ks[S] for ks in split), estimate_z, "rank",
                          None, plain_writes)
        self.S, self.G = S, G
        self.owner0 = np.arange(G) * S
        self.lane_shard = np.tile(np.arange(S), G)
        self.hop_rows = np.asarray(hop_rows, np.int64)

    def feed(self, times, objs, shards, z_draw, hops) -> None:
        """Replay requests from host arrays (``hops`` f32 [H, k])."""
        l1, l2 = self.l1, self.l2
        with np.errstate(all="ignore"):
            for r in range(times.shape[0]):
                t = times[r:r + 1]
                i, s = int(objs[r]), int(shards[r])
                l2._commit_due(t)
                l1._commit_due(t)
                own = self.owner0 + s
                miss = ~(l1.m_bits[0, own, i] | l1.m_bits[1, own, i])
                l2_lat = (l2._serve(t, i, z_draw[r:r + 1], active=miss)
                          if miss.any() else np.zeros(self.G, _F))
                z_eff = hops[self.hop_rows, r] + np.where(miss, l2_lat,
                                                          _ZERO)
                l1._serve(t, i, np.repeat(z_eff, self.S),
                          active=self.lane_shard == s)
        l1.requests += times.shape[0]

    def results(self) -> list[HierResult]:
        """One :class:`HierResult` a point."""
        r1, r2 = self.l1.result(), self.l2.result()
        out = []
        for g in range(self.G):
            lanes = r1[g * self.S:(g + 1) * self.S]
            per_shard = SimResult(*(
                torch.stack([getattr(x, f.name) for x in lanes])
                for f in dataclasses.fields(SimResult)))
            out.append(HierResult(per_shard=per_shard, l2=r2[g]))
        return out


def host_columns(trace: HierTrace):
    """The request columns as host arrays: times, objs, shards, z_draw,
    hop_draw."""
    return (trace.times.cpu().numpy().astype(np.float32, copy=False),
            trace.objs.cpu().numpy(), trace.shards.cpu().numpy(),
            trace.z_draw.cpu().numpy().astype(np.float32, copy=False),
            trace.hop_draw.cpu().numpy().astype(np.float32, copy=False))


def run_hier(hier: _Hier, cols, hop_table: np.ndarray,
             chunk_size: int | None) -> None:
    """Feed ``hier`` the request columns ``cols`` (:func:`host_columns`)
    with the hop table ``[H, T]``, whole or ``chunk_size`` at a time."""
    times, objs, shards, z_draw = cols
    n = times.shape[0]
    step = n if chunk_size is None else chunk_size
    for lo in range(0, n, max(step, 1)):
        hi = min(lo + step, n)
        hier.feed(times[lo:hi], objs[lo:hi], shards[lo:hi], z_draw[lo:hi],
                  hop_table[:, lo:hi])


def plain_writes_of(use_kernel, dev) -> bool:
    """``use_kernel`` for the hierarchy, which scores through the
    epilogues: None or True writes through the point-update journal's
    kernel (its plain version on the CPU), 'ref' or False through the plain
    version."""
    return resolve_score_mode(use_kernel, dev) != "kernel"


def _simulate(trace, n_shards, l1_capacity, l2_capacity, policy, l2_policy,
              params, l2_params, key, estimate_z, use_kernel, device,
              counters, chunk_size) -> HierResult:
    dev = resolve_device(device)
    check_shards(trace, n_shards)
    check_policies((policy, l2_policy))
    params = PolicyParams() if params is None else params
    l2_params = PolicyParams() if l2_params is None else l2_params
    if trace.device != dev:
        trace = trace.to(dev)
    hier = _Hier(trace.sizes, trace.z_mean, trace.hop_mean, int(n_shards),
                 (policy,), (params,), [l1_capacity], [l2_capacity], (key,),
                 [0], l2_policy, l2_params, estimate_z,
                 plain_writes_of(use_kernel, dev))
    *cols, hop = host_columns(trace)
    run_hier(hier, cols, hop[None], chunk_size)
    add_counters(counters, [hier.l1, hier.l2])
    return hier.results()[0]


def simulate_hier(trace: HierTrace, n_shards: int, l1_capacity: float,
                  l2_capacity: float, policy: str = "stoch_vacdh",
                  l2_policy: str = "lru",
                  params: PolicyParams | None = None,
                  l2_params: PolicyParams | None = None,
                  key=(0, 0), estimate_z: bool = True, use_kernel=None,
                  device=None, counters: dict | None = None) -> HierResult:
    """Run the two-tier hierarchy over an annotated trace on ``device``
    (None: the card).

    Each L1 shard has ``l1_capacity`` and runs ``policy`` under
    ``params``; the shared L2 has ``l2_capacity`` and runs ``l2_policy``
    under ``l2_params``, which defaults to stock :class:`PolicyParams`,
    not to ``params`` (a grid's swept L1 params never re-parameterize its
    one L2).  ``estimate_z`` defaults to True: the L1's fetch law depends
    on the L2's state, so no prior is exact.  ``key`` is the key data
    split into one coin key per shard and one for the L2.  ``use_kernel``
    picks the writes (:func:`plain_writes_of`); ``counters`` accumulates
    requests, syncs, commits and scoring commits over both tiers.

    With ``n_shards=1``, ``l2_capacity=0`` and a zero hop the result equals
    single-tier :func:`repro_torch.core.simulate` bit for bit."""
    return _simulate(trace, n_shards, l1_capacity, l2_capacity, policy,
                     l2_policy, params, l2_params, key, estimate_z,
                     use_kernel, device, counters, None)


def simulate_hier_chunked(trace: HierTrace, n_shards: int,
                          l1_capacity: float, l2_capacity: float,
                          policy: str = "stoch_vacdh",
                          l2_policy: str = "lru",
                          params: PolicyParams | None = None,
                          l2_params: PolicyParams | None = None,
                          key=(0, 0), estimate_z: bool = True,
                          chunk_size: int = 65536, use_kernel=None,
                          device=None,
                          counters: dict | None = None) -> HierResult:
    """:func:`simulate_hier` fed ``chunk_size`` requests at a time from
    the host columns; bitwise equal to it at every chunk size (no padded
    tail: the loop stops at the last request)."""
    if chunk_size < 1:
        raise ValueError(f"chunk_size={chunk_size} must be >= 1")
    return _simulate(trace, n_shards, l1_capacity, l2_capacity, policy,
                     l2_policy, params, l2_params, key, estimate_z,
                     use_kernel, device, counters, int(chunk_size))
