"""Decode attention kernel: one new token per sequence against a KV cache
(``csrc/decode_attention.cu``).

It replaces the Pallas kernel of the JAX package's
``kernels/decode_attention.py``: one block per (batch row, KV head), whose
query tile is that head's GQA group, walks the cache in key tiles with an
online f32 softmax.  q is ``(B, 1, H, dh)``; the cache k/v are
``(B, Sc, KV, dh)`` in q's dtype (an fp8 cache is cast before the call);
``q_pos (1,)`` and the ring buffer's ``k_pos (Sc,)`` (any order, -1 for an
empty slot) are shared by every batch row.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import torch

from . import _build
from .flash_attention import _DTYPES, check_attention_args
from .ref import decode_attention_ref

# Kernel launches, one per wrapper call that launched on the card.
launches = {"decode_attention": 0}


def decode_attention(q, k, v, q_pos, k_pos, *, window: int = 0,
                     softcap: float = 0.0, sink: int = 0) -> torch.Tensor:
    """q (B,1,H,dh); k,v (B,Sc,KV,dh); q_pos (1,), k_pos (Sc,).
    Returns (B,1,H,dh)."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B,1,H,dh), got {list(q.shape)}")
    dev = check_attention_args(q, k, v, q_pos, k_pos)
    if dev.type == "cpu":
        return decode_attention_ref(q, k, v, q_pos, k_pos, window=window,
                                    softcap=softcap, sink=sink)
    b, _, h, dh = q.shape
    sc, kv = k.shape[1], k.shape[2]
    out = torch.empty((b, 1, h, dh), dtype=q.dtype, device=dev)
    qp = q_pos.to(torch.int32).contiguous()
    kp = k_pos.to(torch.int32).contiguous()
    with torch.cuda.device(dev):
        lib = _build.load("decode_attention")
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
            kp.data_ptr(), out.data_ptr(), b, sc, h, kv, dh,
            q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
            dh ** -0.5, int(window), float(softcap), int(sink),
            _DTYPES[q.dtype], stream), "decode_attention")
    launches["decode_attention"] += 1
    return out
