"""Trace schema shared by the simulator, the generators and the benchmarks:
:class:`Trace` (tensors on one device) and :class:`RequestStream` (host
numpy, f64 times) for traces too long for an f32 clock or for the card."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device


@dataclasses.dataclass
class Trace:
    """A request trace over a universe of N objects (tensors on one device).

    times   f32[T]: non-decreasing absolute request times (seconds)
    objs    i32[T]: requested object id per request
    sizes   f32[N]: object sizes (MB or any consistent capacity unit)
    z_mean  f32[N]: mean fetch latency per object (L + c * size in the paper)
    z_draw  f32[T]: realized fetch duration if request k turns out to be a
                    miss; pre-drawn so every simulation is reproducible.
    """

    times: torch.Tensor
    objs: torch.Tensor
    sizes: torch.Tensor
    z_mean: torch.Tensor
    z_draw: torch.Tensor

    @property
    def n_requests(self) -> int:
        return self.times.shape[0]

    @property
    def n_objects(self) -> int:
        return self.sizes.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sizes.device


def draw_latencies(generator: torch.Generator, z_mean_per_req: torch.Tensor,
                   stochastic: bool, dist=None) -> torch.Tensor:
    """Realized fetch durations per request index (used only on a miss).

    ``dist`` (a :class:`repro_torch.core.distributions.MissLatency`)
    overrides ``stochastic`` (True: Exponential, False: the mean)."""
    if dist is not None:
        return dist.sample(generator, z_mean_per_req)
    if not stochastic:
        return z_mean_per_req.clone()
    e = torch.empty(z_mean_per_req.shape, dtype=torch.float32,
                    device=generator.device).exponential_(
                        1.0, generator=generator)
    return z_mean_per_req * e.to(z_mean_per_req.device)


def make_trace(times, objs, sizes, z_mean, generator=None, stochastic=True,
               dist=None, device=None) -> Trace:
    """Build a :class:`Trace` on ``device`` (None: the card), drawing the
    realized latencies from ``generator`` (a CPU generator seeded 0 when
    None)."""
    dev = resolve_device(device)
    f32 = lambda x: torch.as_tensor(
        x if isinstance(x, torch.Tensor) else np.asarray(x, np.float32),
        dtype=torch.float32, device=dev)
    times, sizes, z_mean = f32(times), f32(sizes), f32(z_mean)
    objs = torch.as_tensor(
        objs if isinstance(objs, torch.Tensor) else np.asarray(objs),
        device=dev).to(torch.int32)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    per_req = z_mean[objs.long()]
    z_draw = draw_latencies(generator, per_req.to(generator.device),
                            stochastic, dist=dist).to(dev)
    return Trace(times, objs, sizes, z_mean, z_draw)


def to_numpy(trace: Trace) -> Trace:
    """The trace's columns as host numpy arrays."""
    return Trace(*(x.cpu().numpy() for x in (
        trace.times, trace.objs, trace.sizes, trace.z_mean, trace.z_draw)))


class RequestStream(NamedTuple):
    """A host-side request stream over a (compacted) object universe.

    The device :class:`Trace` keeps times in f32, which loses inter-arrival
    gaps once absolute time passes ~2^24 time units; a stream keeps f64
    times on the host and the simulator rebases each chunk to its own start
    (:func:`repro_torch.core.simulator.simulate_stream`).

    times   f64[T] non-decreasing absolute request times
    objs    i32[T] dense object id per request
    sizes   f32[N] object sizes
    z_mean  f32[N] mean origin fetch latency per object
    z_draw  f32[T] realized fetch duration if request k misses
    """

    times: np.ndarray
    objs: np.ndarray
    sizes: np.ndarray
    z_mean: np.ndarray
    z_draw: np.ndarray

    @property
    def n_requests(self) -> int:
        return self.times.shape[0]

    @property
    def n_objects(self) -> int:
        return self.sizes.shape[0]


def auto_chunk_size(n_requests: int, target: int = 131072) -> int:
    """The smallest chunk size ``c`` with ``ceil(n / c) == ceil(n /
    target)``: the reference's pad-minimizing size (the port pads nothing,
    so here it only bounds a chunk's length near ``target``)."""
    if target < 1:
        raise ValueError(f"target={target} must be >= 1")
    n = max(int(n_requests), 1)
    k = -(-n // int(target))
    return -(-n // k)


def stream_of_trace(trace: Trace) -> RequestStream:
    """A :class:`Trace` as a host stream (times widened to f64)."""
    h = to_numpy(trace)
    return RequestStream(times=h.times.astype(np.float64),
                         objs=h.objs.astype(np.int32),
                         sizes=h.sizes.astype(np.float32),
                         z_mean=h.z_mean.astype(np.float32),
                         z_draw=h.z_draw.astype(np.float32))


def trace_of_stream(stream: RequestStream, device=None) -> Trace:
    """A stream as a :class:`Trace` on ``device`` (None: the card), times
    narrowed to f32: exact only while absolute times stay within f32
    precision."""
    dev = resolve_device(device)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return Trace(times=f32(np.asarray(stream.times).astype(np.float32)),
                 objs=torch.as_tensor(np.asarray(stream.objs, np.int32),
                                      device=dev),
                 sizes=f32(stream.sizes), z_mean=f32(stream.z_mean),
                 z_draw=f32(stream.z_draw))
