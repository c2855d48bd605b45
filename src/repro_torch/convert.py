"""Carry the reference's data across: numpy arrays and plain numbers in, the
port's objects out.

The JAX package cannot share tensors with this one, and the port cannot
regenerate ``jax.random`` streams, so a comparison hands both packages the
same arrays, including the pre-drawn miss latencies ``z_draw``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._device import resolve_device
from .core.distributions import make_distribution
from .core.hierarchy import HierTrace
from .core.ranking import PolicyParams
from .core.state import ObjStats
from .core.trace import Trace
from .models.ssm import F32_LEAVES


def trace_from_arrays(times, objs, sizes, z_mean, z_draw,
                      device=None) -> Trace:
    """A :class:`Trace` from array-likes (f32 times/sizes/latencies, int
    object ids), on ``device`` (None: the card)."""
    dev = resolve_device(device)
    f32 = lambda x: torch.as_tensor(np.array(x, np.float32), device=dev)
    return Trace(times=f32(times),
                 objs=torch.as_tensor(np.array(objs, np.int32),
                                      device=dev),
                 sizes=f32(sizes), z_mean=f32(z_mean), z_draw=f32(z_draw))


def hier_trace_from_arrays(times, objs, shards, sizes, z_mean, z_draw,
                           hop_draw, hop_mean, device=None) -> HierTrace:
    """A :class:`HierTrace` from array-likes (the reference's
    ``HierTrace`` fields in order), on ``device`` (None: the card)."""
    t = trace_from_arrays(times, objs, sizes, z_mean, z_draw, device)
    i32 = lambda x: torch.as_tensor(np.array(x, np.int32), device=t.device)
    return HierTrace(t.times, t.objs, i32(shards), t.sizes, t.z_mean,
                     t.z_draw,
                     torch.as_tensor(np.array(hop_draw, np.float32),
                                     device=t.device),
                     float(np.float32(hop_mean)))


def params_from_dict(d: dict) -> PolicyParams:
    """:class:`PolicyParams` from plain numbers.

    Keys are PolicyParams' fields (``omega``, ``cala_beta``, ``adapt_c``,
    ``cold_rate``, ``window``, ``resid`` or ``resid_rate``); ``dist`` is a
    law's registry name, or ``(name, {parameter: value})``."""
    d = dict(d)
    dist = d.pop("dist", "exponential")
    name, kw = (dist, {}) if isinstance(dist, str) else dist
    known = {f.name for f in dataclasses.fields(PolicyParams)} | {"resid"}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown PolicyParams keys: {sorted(unknown)}")
    return PolicyParams(dist=make_distribution(name, **dict(kw)), **d)


def obj_stats_from_arrays(device=None, **fields) -> ObjStats:
    """An :class:`ObjStats` from one array per field (bool ``cached`` and
    ``in_flight``, f32 otherwise), each ``[N]`` or ``[L, N]``."""
    dev = resolve_device(device)
    names = [f.name for f in dataclasses.fields(ObjStats)]
    missing = set(names) - set(fields)
    if missing:
        raise ValueError(f"missing ObjStats fields: {sorted(missing)}")
    out = {}
    for n in names:
        dt = np.bool_ if n in ("cached", "in_flight") else np.float32
        out[n] = torch.as_tensor(np.asarray(fields[n], dt), device=dev)
    return ObjStats(**out)


def lm_params_from_arrays(tree: dict, cfg, device=None) -> dict:
    """The port's LM parameters from the JAX package's parameter pytree
    given as numpy arrays (``transformer.init_params``).

    The stacked ``[L, ...]`` leaves of ``tree["layers"]`` are split into one
    dict per layer.  Weights keep their ``(d_in, d_out)`` layout, so no
    transpose is needed.  Every leaf takes its JAX dtype: the leaves the JAX
    package creates in f32 whatever the model's dtype
    (:data:`repro_torch.models.ssm.F32_LEAVES`) stay f32, every other leaf
    is cast to ``cfg.torch_dtype``, both via f32 (exact for bf16 and f32
    leaves)."""
    dev = resolve_device(device)

    def leaf(x, name):
        dt = torch.float32 if name in F32_LEAVES else cfg.torch_dtype
        return torch.as_tensor(np.array(x, np.float32), device=dev).to(dt)

    def tree_map(f, t, name=None):
        return ({k: tree_map(f, v, k) for k, v in t.items()}
                if isinstance(t, dict) else f(t, name))

    out = {k: tree_map(leaf, v, k) for k, v in tree.items() if k != "layers"}
    out["layers"] = [
        tree_map(lambda x, name, i=i: leaf(np.asarray(x)[i], name),
                 tree["layers"])
        for i in range(cfg.n_layers)]
    return out
