"""Int8 gradient compression with error feedback: the counterpart of the
JAX package's ``training/compression.py``.

Gradients are quantised to int8 with a shared per-tensor scale and the
quantisation residual is kept in an error-feedback buffer, added back the
next step (Karimireddy et al., "Error Feedback Fixes SignSGD", 2019).
:func:`compress_error_feedback` is the single-device building block.
:func:`compress_pod_reduce` is the compressed mean over the ``pod`` dim of
a ``torch.distributed`` ``DeviceMesh``, as the reference's shard_map body
does it: a MAX all-reduce of the shared scale, the gradient quantised to
int8 (the wire format), an int32 SUM all-reduce of the codes, and the
mean dequantised.  Without a ``pod`` dim it is the identity, as there.
"""
from __future__ import annotations

from typing import Any

import torch

from .optimizer import tree_leaves, tree_map


def quantize_int8(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(g / scale * 127), -127, 127)`` as int8, rounding half
    to even (``jnp.round``)."""
    return torch.clamp(torch.round(g / scale * 127.0), -127, 127).to(
        torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * (scale / 127.0)


def compress_error_feedback(grads: Any, err: Any):
    """Quantise ``grads + err`` to int8 per leaf; returns (the dequantised
    f32 grads, the new error buffer)."""
    def one(g, e):
        g = g.float() + e
        scale = torch.clamp(torch.max(torch.abs(g)), min=1e-8)
        deq = dequantize_int8(quantize_int8(g, scale), scale)
        return deq, g - deq

    pairs = [one(g, e) for g, e in zip(tree_leaves(grads),
                                       tree_leaves(err))]
    it_q, it_e = iter([p[0] for p in pairs]), iter([p[1] for p in pairs])
    return (tree_map(lambda _: next(it_q), grads),
            tree_map(lambda _: next(it_e), grads))


def init_error_buffer(grads_like: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def compress_pod_reduce(grads: Any, axis: str = "pod", mesh=None) -> Any:
    """Compressed mean of every gradient leaf over the ``axis`` dim of
    ``mesh`` (default: the mesh installed by
    :func:`repro_torch.sharding.activation.activation_sharding`); each
    rank's leaf is its pod's gradient, not yet reduced over ``axis``.  Per
    leaf: ``scale = max(max |g| over the pods, 1e-8)``, ``q =
    quantize_int8(g, scale)``, ``s`` = the int32 sum of ``q`` over the
    pods, result ``s * scale / 127 / n`` in f32.  A DTensor leaf is reduced
    in its local shard and keeps its placements.  Without such a dim the
    identity."""
    if mesh is None:
        from ..sharding.activation import current_mesh
        mesh = current_mesh()
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if axis not in names or not hasattr(mesh, "get_group"):
        return grads
    import torch.distributed as dist
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)

    def one(g):
        dt = None
        if hasattr(g, "device_mesh"):
            dt, g = g, g.to_local()
        gf = g.float()
        scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-8)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        s = quantize_int8(gf, scale).to(torch.int32)
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
        out = s.float() * (scale / 127.0) / n
        if dt is None:
            return out
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(out, dt.device_mesh, dt.placements,
                                  run_check=False, shape=dt.shape,
                                  stride=dt.stride())

    return tree_map(one, grads)
