"""Shared functional layers: parameters are plain dicts of tensors.

The counterpart of the JAX package's ``models/layers.py``.  Weights keep its
``(d_in, d_out)`` layout, so a layer is ``x @ w`` in both packages.  The
large products stay ``torch.matmul``, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sharding.activation import constrain


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w


def init_dense(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.bfloat16, scale: float | None = None):
    """N(0, scale^2) weights, ``scale`` = d_in^-1/2 by default, drawn in f32
    on the generator's device (the JAX init's law, not its numbers)."""
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (w * scale).to(dtype)


def init_embed(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.bfloat16):
    w = torch.randn((vocab, d), generator=generator, device=generator.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


def split_heads(t: torch.Tensor, n: int, d_head: int) -> torch.Tensor:
    """(..., n * d_head) -> (..., n, d_head).  A DTensor split over its
    last dim by a mesh dim whose size does not divide ``n`` (8 KV heads
    over a 16-wide ``model`` axis) is gathered over that mesh dim first:
    the split would cut heads apart."""
    if hasattr(t, "device_mesh"):
        from torch.distributed.tensor import Replicate, Shard
        mesh = t.device_mesh
        want = [Replicate() if isinstance(p, Shard) and p.dim == t.dim() - 1
                and n % mesh.size(i) else p
                for i, p in enumerate(t.placements)]
        if want != list(t.placements):
            t = t.redistribute(mesh, want)
    return t.reshape(*t.shape[:-1], n, d_head)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(..., n, d_head) -> (..., n * d_head).  A DTensor whose heads are
    split by a mesh dim whose size does not divide ``n`` (Hymba's 25 Mamba
    heads over a 16-wide ``model`` axis, as a decode step's state update
    leaves them) is gathered over that mesh dim first: DTensor cannot
    flatten an uneven split."""
    if hasattr(t, "device_mesh"):
        from torch.distributed.tensor import Replicate, Shard
        mesh, h = t.device_mesh, t.dim() - 2
        want = [Replicate() if isinstance(p, Shard) and p.dim == h
                and t.shape[h] % mesh.size(i) else p
                for i, p in enumerate(t.placements)]
        if want != list(t.placements):
            t = t.redistribute(mesh, want)
    return t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])


# ---------------------------------------------------------------------------
# Rotary position embeddings.  Half-split convention (LLaMA); applied in f32.
# ---------------------------------------------------------------------------
def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    half = d_head // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float):
    """x: (..., S, n, d_head); pos: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = pos[..., None].float() * freqs                  # (..., S, d/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def _gelu(x):
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


def mlp_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """Gated ('swiglu'/'geglu') or plain ('gelu'/'relu2') MLP."""
    if act in ("swiglu", "geglu"):
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        g = F.silu(g) if act == "swiglu" else _gelu(g)
        h = g * u
    elif act == "gelu":
        h = _gelu(x @ p["w_up"])
    elif act == "relu2":
        h = torch.square(F.relu(x @ p["w_up"]))
    else:
        raise ValueError(f"unknown mlp act {act!r}")
    h = constrain(h, "act_ffn")
    return h @ p["w_down"]


def mlp_init(generator: torch.Generator, d: int, f: int, act: str,
             dtype=torch.bfloat16) -> dict:
    p = {"w_up": init_dense(generator, d, f, dtype),
         "w_down": init_dense(generator, f, d, dtype)}
    if act in ("swiglu", "geglu"):
        p["w_gate"] = init_dense(generator, d, f, dtype)
    return p
