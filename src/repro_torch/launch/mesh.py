"""Device meshes: the sweep fabric's (:mod:`repro_torch.launch.fabric`)
and the LM's production meshes.

A :class:`Mesh` is an ordered tuple of ``torch.device``s with named axes;
an :class:`AbstractMesh` only axis names and sizes.  Neither builds a
process group or touches a device.  Their constructors are functions, so
importing this module never initialises CUDA.

    make_data_mesh(n_devices=None, devices=None)   1-D ``data`` mesh
    make_local_mesh(device=None)                   one device, axes
                                                   ("data", "model")
    make_production_mesh(multi_pod=False)          (16, 16) over ("data",
                                                   "model") or (2, 16, 16)
                                                   over ("pod", "data",
                                                   "model"), abstract
    device_mesh(mesh, device_type)                 the ``torch.distributed``
                                                   ``DeviceMesh`` of a mesh
                                                   over the initialised
                                                   process group

``make_data_mesh`` takes the visible CUDA devices in index order unless
``devices`` pins an explicit order: the fabric assigns lane blocks in mesh
order, and a permuted mesh must give the same results.  On the CPU,
``devices=["cpu"] * d`` stands for ``d`` devices (one worker process
each); a mesh never names one CUDA device twice.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["AbstractMesh", "Mesh", "device_mesh", "make_data_mesh",
           "make_local_mesh", "make_production_mesh"]


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


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Named axes and their sizes, with no devices: what the sharding
    planner (:mod:`repro_torch.sharding.specs`) reads, as JAX's abstract
    mesh."""

    axis_names: tuple
    axis_sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, (int(s) for s in self.axis_sizes)))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= int(s)
        return n


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """Single pod: 16 x 16 = 256 devices over ("data", "model").
    Multi-pod: 2 pods x 256 = 512 over ("pod", "data", "model")."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def device_mesh(mesh, device_type: str | None = None):
    """The ``DeviceMesh`` of ``mesh`` (an :class:`AbstractMesh` or a
    :class:`Mesh`) over the default process group, which must be
    initialised with ``mesh.size`` ranks (the ``"fake"`` backend for a
    dry run, NCCL on cards).  ``device_type`` defaults to the devices'
    type of a :class:`Mesh` and to ``"cpu"`` for an abstract one."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("device_mesh needs an initialised process group")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"a mesh of {mesh.size} devices needs a world of "
                         f"{mesh.size} ranks, not {dist.get_world_size()}")
    if device_type is None:
        devs = getattr(mesh, "devices", None)
        device_type = devs[0].type if devs else "cpu"
    return init_device_mesh(device_type, tuple(int(s) for s in
                                               mesh.axis_sizes),
                            mesh_dim_names=tuple(mesh.axis_names))
