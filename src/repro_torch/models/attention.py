"""Attention: GQA + RoPE + causal/sliding-window masks + logit softcap, with
a ring-buffer KV cache.

The counterpart of the JAX package's ``models/attention.py``.  The port has
one route, the JAX module's ``use_kernel=True`` branch: a query block of
more than one position goes to the prefill kernel
(:func:`repro_torch.kernels.flash_attention.flash_attention`), a single
position to the decode kernel
(:func:`repro_torch.kernels.decode_attention.decode_attention`).  Each
wrapper launches its CUDA kernel for a tensor on the card and runs its
plain version for a tensor on the CPU; ``use_kernel="ref"`` runs the plain
versions on the card too (the on-card oracle of the kernel path).  When
autograd records (grad enabled and q, k or v requiring grad), every query
block goes through :class:`repro_torch.kernels.flash_attention.
FlashAttention`: the prefill kernel forward and the plain version's
gradients (the decode kernel has no backward; it serves only).  Any
other value of ``use_kernel`` than ``True`` and ``"ref"`` raises: the JAX
module's ``False`` (its XLA route) has no counterpart here.

The JAX module's ``_mask`` is :func:`repro_torch.kernels.ref.attention_keep`,
beside the plain versions that use it.  Not ported: the JAX module's XLA
einsum route and its q-chunked form
``_sdpa_chunked``; they exist there to let XLA/GSPMD lower and shard the
dry-run, which has no counterpart on one card.

The cache is updated in place (the JAX version returns a new one); the
caller owns it, and nothing else holds the old contents.
"""
from __future__ import annotations

import torch

from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import FlashAttention, flash_attention
from ..kernels.ref import decode_attention_ref, flash_attention_ref
from .layers import apply_rope, init_dense


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
    if not plain and torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        # training: the prefill kernel forward, the plain version's backward
        return FlashAttention.apply(q, k, v, q_pos, k_pos, window, softcap,
                                    sink)
    if q.shape[1] > 1:
        fn = flash_attention_ref if plain else flash_attention
    else:
        fn = decode_attention_ref if plain else decode_attention
    return fn(q, k, v, q_pos, k_pos, window=window, softcap=softcap,
              sink=sink)


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
    q = (x @ p["wq"]).reshape(b, s, n_heads, d_head)
    k = (x @ p["wk"]).reshape(b, s, n_kv, d_head)
    v = (x @ p["wv"]).reshape(b, s, n_kv, d_head)
    q = apply_rope(q, pos, theta)
    k = apply_rope(k, pos, theta)
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
        cache["k"][:, slots] = k.to(cdt)
        cache["v"][:, slots] = v.to(cdt)
        cache["kpos"][slots] = pos_w
    else:
        # Decode: write the single new token, attend over the cache.
        slots = _slot(pos.long(), sink, cache["k"].shape[1] - sink)
        cdt = cache["k"].dtype            # may be fp8 (cfg.kv_dtype='f8')
        cache["k"][:, slots] = k.to(cdt)
        cache["v"][:, slots] = v.to(cdt)
        cache["kpos"][slots] = pos
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
