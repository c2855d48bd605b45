"""Trace schema shared by the simulator, the generators and the benchmarks."""
from __future__ import annotations

import dataclasses

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
