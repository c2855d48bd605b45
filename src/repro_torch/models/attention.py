"""Attention: GQA + RoPE + causal/sliding-window masks + logit softcap, with
a ring-buffer KV cache.

The counterpart of the JAX package's ``models/attention.py``.  The port's
main route is the JAX module's ``use_kernel=True`` branch, through the
custom ops of :mod:`repro_torch.kernels.ops`: a query block of more than
one position goes to the prefill kernel (``flash_attention``), a single
position to the decode kernel (``decode_attention``).  Each op's wrapper
launches its CUDA kernel for a tensor on the card and runs its plain
version for a tensor on the CPU; on DTensors the op's sharding rule runs
it shard by shard.  When autograd records (grad enabled and q, k or v
requiring grad), every query block goes through the prefill op, whose
gradients are the plain version's (the decode kernel has no backward; it
serves only).

``use_kernel="ref"`` runs the plain versions on any device (the on-card
oracle of the kernel path): from ``CHUNKED_Q_THRESHOLD`` = 8192 query
positions on, the q-chunked form of the JAX module's ``_sdpa_chunked``
(:func:`repro_torch.kernels.ref.flash_attention_chunked_ref`, 512 queries
a chunk against every key), so a 32k prefill never forms its whole
(Sq, Sk) logits.  Any other value of ``use_kernel`` than ``True`` and
``"ref"`` raises: the JAX module's ``False`` (its XLA einsum route) has no
counterpart here.  Under a mesh whose ``model`` axis does not divide the
KV heads, train and prefill repeat KV to the q heads before the op, as the
JAX module does, so the heads shard whole over ``model``; decode keeps the
grouped form.

The JAX module's ``_mask`` is :func:`repro_torch.kernels.ref.attention_keep`,
beside the plain versions that use it.

The cache is updated in place (the JAX version returns a new one); the
caller owns it, and nothing else holds the old contents.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from ..kernels.ref import decode_attention_ref, flash_attention_chunked_ref
from ..sharding.activation import axis_size, constrain
from .layers import apply_rope, init_dense, split_heads


def init_attn(generator: torch.Generator, d: int, n_heads: int, n_kv: int,
              d_head: int, dtype=torch.bfloat16) -> dict:
    return {
        "wq": init_dense(generator, d, n_heads * d_head, dtype),
        "wk": init_dense(generator, d, n_kv * d_head, dtype),
        "wv": init_dense(generator, d, n_kv * d_head, dtype),
        "wo": init_dense(generator, n_heads * d_head, d, dtype,
                         scale=(n_heads * d_head) ** -0.5),
    }


def sdpa(q, k, v, q_pos, k_pos, *, window: int = 0, softcap: float = 0.0,
         sink: int = 0, use_kernel=True) -> torch.Tensor:
    """q: (B,Sq,H,dh); k,v: (B,Sk,KV,dh). Returns (B,Sq,H,dh)."""
    h, kv = q.shape[2], k.shape[2]
    if h % kv:
        raise ValueError(f"{h} q heads are not a multiple of {kv} KV heads")
    if use_kernel is not True and use_kernel != "ref":
        raise ValueError(f"use_kernel must be True (the kernels) or 'ref' "
                         f"(their plain versions), not {use_kernel!r}")
    plain = use_kernel == "ref"
    sq = q.shape[1]
    if sq > 1 and kv != h and kv % axis_size("model"):
        k = torch.repeat_interleave(k, h // kv, dim=2)
        v = torch.repeat_interleave(v, h // kv, dim=2)
    recording = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    if plain:
        fn = (flash_attention_chunked_ref if sq > 1 or recording
              else decode_attention_ref)
        return fn(q, k, v, q_pos, k_pos, window=window, softcap=softcap,
                  sink=sink)
    op = ops.flash_attention if sq > 1 or recording else ops.decode_attention
    return op(q, k, v, q_pos, k_pos, int(window), float(softcap), int(sink))


def _put(buf: torch.Tensor, slots: torch.Tensor, vals: torch.Tensor):
    """``buf[:, slots] = vals`` for a (B, Sc, KV, dh) cache tensor,
    ``buf[slots] = vals`` for the (Sc,) positions.  A DTensor cache never
    splits its slot dim, so each shard writes its own rows in place, with
    ``vals`` laid out as ``buf`` first (DTensor's own indexed write has no
    rule for this in some PyTorch releases)."""
    if hasattr(buf, "device_mesh"):
        if hasattr(vals, "device_mesh"):
            vals = vals.redistribute(buf.device_mesh,
                                     buf.placements).to_local()
        elif not all(p.is_replicate() for p in buf.placements):
            raise ValueError("a plain tensor written into a split cache")
        buf = buf.to_local()
        if hasattr(slots, "to_local"):
            slots = slots.full_tensor()
    if buf.dim() == 1:
        buf[slots] = vals
    else:
        buf[:, slots] = vals


def _slot(pos: torch.Tensor, sink: int, ring: int) -> torch.Tensor:
    """Ring-buffer slots of absolute positions ``pos``: the sink prefix
    keeps its own slots, later positions wrap over the ``ring`` others."""
    return torch.where(pos < sink, pos, sink + (pos - sink) % ring)


def attn_apply(p: dict, x: torch.Tensor, *, n_heads: int, n_kv: int,
               d_head: int, pos: torch.Tensor, theta: float, window: int = 0,
               softcap: float = 0.0, sink: int = 0, cache: dict | None = None,
               use_kernel=True) -> tuple[torch.Tensor, dict | None]:
    """Full attention block (projections + rope + sdpa + output proj).

    ``cache``: None (training / stateless prefill) or a ring-buffer dict
    {k (B,Sc,KV,dh), v (B,Sc,KV,dh), kpos (Sc,) i32}: ``kpos`` records the
    absolute position stored in each slot (-1 = empty; masked out by the
    causal test).  Sliding-window archs size Sc = sink + window, full
    attention Sc = capacity.  K is stored *post-RoPE* so decode never
    re-rotates history.  ``pos`` is the (S,) i32 tensor of x's absolute
    positions, on x's device.  Returns (output, cache), the cache updated
    in place.
    """
    b, s, _ = x.shape
    dev = x.device
    q = split_heads(x @ p["wq"], n_heads, d_head)
    k = split_heads(x @ p["wk"], n_kv, d_head)
    v = split_heads(x @ p["wv"], n_kv, d_head)
    q = apply_rope(q, pos, theta)
    k = apply_rope(k, pos, theta)
    q = constrain(q, "act_heads")
    kw = dict(window=window, softcap=softcap, sink=sink,
              use_kernel=use_kernel)

    if cache is None:
        out = sdpa(q, k, v, pos, pos, **kw)
    elif s > 1:
        # Prefill: attend over the fresh full sequence, then pack the cache
        # (sink prefix + last `ring` tokens -> unique slots).
        out = sdpa(q, k, v, pos, pos, **kw)
        ring = cache["k"].shape[1] - sink
        if s > ring:
            sel = torch.arange(s - ring, s, device=dev)
            if sink:
                sel = torch.cat([torch.arange(sink, device=dev), sel])
            k, v, pos_w = k[:, sel], v[:, sel], pos[sel]
        else:
            pos_w = pos
        slots = _slot(pos_w.long(), sink, ring)
        cdt = cache["k"].dtype
        _put(cache["k"], slots, k.to(cdt))
        _put(cache["v"], slots, v.to(cdt))
        _put(cache["kpos"], slots, pos_w)
    else:
        # Decode: write the single new token, attend over the cache.
        slots = _slot(pos.long(), sink, cache["k"].shape[1] - sink)
        cdt = cache["k"].dtype            # may be fp8 (cfg.kv_dtype='f8')
        _put(cache["k"], slots, k.to(cdt))
        _put(cache["v"], slots, v.to(cdt))
        _put(cache["kpos"], slots, pos)
        ka = cache["k"].to(k.dtype) if cdt != k.dtype else cache["k"]
        va = cache["v"].to(v.dtype) if cdt != v.dtype else cache["v"]
        out = sdpa(q, ka, va, pos, cache["kpos"], **kw)
    out = out.reshape(b, s, n_heads * d_head)
    return out @ p["wo"], cache


def init_kv_cache(batch: int, capacity: int, n_kv: int, d_head: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    return {"k": torch.zeros((batch, capacity, n_kv, d_head), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, capacity, n_kv, d_head), dtype=dtype,
                             device=device),
            "kpos": torch.full((capacity,), -1, dtype=torch.int32,
                               device=device)}
