"""Device meshes for the sweep fabric (:mod:`repro_torch.launch.fabric`).

A :class:`Mesh` is an ordered tuple of ``torch.device``s with named axes;
it builds no process group and touches no device.  Its constructors are
functions, so importing this module never initialises CUDA.

    make_data_mesh(n_devices=None, devices=None)   1-D ``data`` mesh
    make_local_mesh(device=None)                   one device, axes
                                                   ("data", "model")

``make_data_mesh`` takes the visible CUDA devices in index order unless
``devices`` pins an explicit order: the fabric assigns lane blocks in mesh
order, and a permuted mesh must give the same results.  On the CPU,
``devices=["cpu"] * d`` stands for ``d`` devices (one worker process
each); a mesh never names one CUDA device twice.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["Mesh", "make_data_mesh", "make_local_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices`` in row-major order over ``axis_names``, whose sizes are
    ``axis_sizes``; ``shape`` maps each axis to its size, as a JAX mesh's
    does."""

    devices: tuple
    axis_names: tuple
    axis_sizes: tuple

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        object.__setattr__(self, "devices", devs)
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")
        n = 1
        for s in self.axis_sizes:
            n *= int(s)
        if n != len(devs) or n < 1:
            raise ValueError(f"a mesh of shape {self.axis_sizes} needs "
                             f"{n} devices, got {len(devs)}")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh holds devices of one type; got "
                             f"{[str(d) for d in devs]}")
        cuda = [d if d.index is not None else torch.device("cuda", 0)
                for d in devs if d.type == "cuda"]
        if len(set(cuda)) != len(cuda):
            raise ValueError(f"a mesh may not name one CUDA device twice; "
                             f"got {[str(d) for d in devs]}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, (int(s) for s in self.axis_sizes)))

    @property
    def size(self) -> int:
        return len(self.devices)


def _cuda_devices() -> list:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def make_data_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D ``data`` mesh over the first ``n_devices`` of ``devices``
    (default: every visible CUDA device, in index order).  A count below 1
    or above the devices given raises."""
    if devices is None:
        devs = _cuda_devices()
        where = "CUDA device(s) are visible"
    else:
        devs = [torch.device(d) for d in devices]
        where = "device(s) were given"
    if n_devices is not None:
        if n_devices < 1 or n_devices > len(devs):
            raise ValueError(
                f"n_devices={n_devices} but {len(devs)} {where}; on the "
                f"CPU pass devices=['cpu'] * n")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError(f"no device for the mesh: 0 {where}; on the CPU "
                         f"pass devices=['cpu'] * n")
    return Mesh(tuple(devs), ("data",), (len(devs),))


def make_local_mesh(device=None) -> Mesh:
    """One device (the card unless ``device="cpu"``) with the axis names
    ``("data", "model")``."""
    from .._device import resolve_device
    return Mesh((resolve_device(device),), ("data", "model"), (1, 1))
