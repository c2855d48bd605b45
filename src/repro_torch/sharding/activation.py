"""Activation sharding constraints, decoupled from model code: the
counterpart of the JAX package's ``sharding/activation.py``.

Model code calls ``constrain(x, "<logical name>")``; the mapping from
logical names to specs is installed by the launcher
(:func:`activation_sharding`) or left empty, and then ``constrain`` is the
identity, which is what unit tests and single-card runs on plain tensors
use.  Where JAX's ``with_sharding_constraint`` tells the partitioner a
layout, the port's DTensor is eager: ``constrain`` redistributes a DTensor
to the rule's placements at once (the collective, if any, runs there).
The installed mesh is a ``torch.distributed`` ``DeviceMesh`` (or, for
:func:`dp_group_count` alone, any mesh with a ``shape``).
"""
from __future__ import annotations

import contextlib
import threading

from .specs import P, mesh_shape, placements

_state = threading.local()


def current_rules() -> dict | None:
    return getattr(_state, "rules", None)


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def activation_sharding(mesh, rules: dict):
    """Install logical-activation rules for the enclosed calls."""
    prev = (current_mesh(), current_rules())
    _state.mesh, _state.rules = mesh, rules
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def dp_group_count() -> int:
    """Data-parallel shards of the installed mesh (1 if none).  The MoE
    layer makes its data-dependent dispatch group-local with it."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    shape = mesh_shape(mesh)
    return shape.get("pod", 1) * shape.get("data", 1)


def axis_size(name: str) -> int:
    mesh = current_mesh()
    return 1 if mesh is None else mesh_shape(mesh).get(name, 1)


def fit_spec(mesh, spec, shape) -> P:
    """``spec`` cut to the rank of ``shape``, with the axes whose size
    does not divide their dim dropped (JAX ``constrain``'s rule)."""
    ms = mesh_shape(mesh)
    spec = tuple(spec)[:len(shape)]
    fixed = []
    for dim, axis in enumerate(spec):
        if axis is None:
            fixed.append(None)
            continue
        fixed.append(axis if shape[dim] % _prod(ms, axis) == 0 else None)
    return P(*fixed)


def _prod(ms: dict, axes) -> int:
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= ms[a]
    return n


def constrain(x, name: str):
    """Redistribute the DTensor ``x`` to the installed spec of ``name``;
    the identity on a plain tensor, an unknown name or with no rules."""
    from torch.distributed.tensor import DTensor
    mesh, rules = current_mesh(), current_rules()
    if (mesh is None or rules is None or name not in rules
            or not isinstance(x, DTensor)):
        return x
    ms = mesh_shape(mesh)
    # a split over axes of total size 1 is no split: left replicated, so
    # that a later reshape may merge that dim (DTensor refuses to reshape
    # a sharded dim of size 1)
    spec = P(*(a if a is None or _prod(ms, a) > 1 else None
               for a in fit_spec(mesh, rules[name], x.shape)))
    want = placements(x.device_mesh, spec)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)
