"""Int8 gradient compression with error feedback: the counterpart of the
JAX package's ``training/compression.py``.

Gradients are quantised to int8 with a shared per-tensor scale and the
quantisation residual is kept in an error-feedback buffer, added back the
next step (Karimireddy et al., "Error Feedback Fixes SignSGD", 2019).
:func:`compress_error_feedback` is the single-device building block.
:func:`compress_pod_reduce` is the compressed mean over a mesh's ``pod``
axis; the port has no such axis yet (the sharding slice, ROADMAP queue 1
item 11, brings the mesh and the int8 wire), so it is the identity, which
is what the reference returns without a ``pod`` axis.
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


def compress_pod_reduce(grads: Any, axis: str = "pod") -> Any:
    """Compressed mean over the ``axis`` of a mesh; without one (always,
    on one card) the identity."""
    return grads
