"""Decode attention kernel: one new token per sequence against a KV cache
(``csrc/decode_attention.cu``).

It replaces the Pallas kernel of the JAX package's
``kernels/decode_attention.py``.  The query tile of a block is (up to 8
heads of) a KV head's GQA group, as on the TPU; the cache is split into
ranges that blocks stream in parallel with an online f32 softmax, and the
last block of each q tile to finish (an atomic ticket) merges the ranges'
partial softmax states (:func:`decode_splits` picks the ranges).  q is
``(B, 1, H, dh)``; the cache k/v are ``(B, Sc, KV, dh)`` in q's dtype (an
fp8 cache is cast before the call); ``q_pos (1,)`` and the ring buffer's
``k_pos (Sc,)`` (any order, -1 for an empty slot) are shared by every
batch row.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import functools

import torch

from . import _build
from .flash_attention import _DTYPES, check_attention_args
from .ref import decode_attention_ref

# Kernel launches, one per wrapper call that launched on the card.
launches = {"decode_attention": 0}

SPLIT_ALIGN = 64      # a split's length is a multiple of this many slots
BLOCKS_PER_SM = 2     # the splits aim at this many blocks on each SM


def q_tile(group: int) -> int:
    """The q heads a block takes: the least of 1, 2, 4, 8 that holds the
    GQA group (a larger group takes several tiles of 8)."""
    return next((g for g in (1, 2, 4, 8) if group <= g), 8)


def decode_splits(sc: int, blocks: int, sms: int) -> tuple[int, int]:
    """``(n_split, split_len)`` for a cache of ``sc`` slots when the
    (batch row, KV head, q tile) grid has ``blocks`` blocks on a card of
    ``sms`` SMs: enough splits for about BLOCKS_PER_SM blocks an SM, each
    a multiple of SPLIT_ALIGN slots, every one non-empty (``(n_split - 1)
    * split_len < sc <= n_split * split_len``); a single split when ``sc``
    is small or the grid already fills the card."""
    want = max(1, -(-BLOCKS_PER_SM * sms // max(blocks, 1)))
    n = min(want, -(-sc // SPLIT_ALIGN))
    length = -(-sc // n)
    length = -(-length // SPLIT_ALIGN) * SPLIT_ALIGN
    return -(-sc // length), length


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# The merge tickets, one int per q tile, by (device, stream): zero between
# launches (the last block of a tile sets its ticket back to 0).
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def _ticket_buffer(dev, stream: int, n: int) -> torch.Tensor:
    key = (dev.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = _tickets[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                        device=dev)
    return t


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
    g = q_tile(h // kv)
    tiles = b * kv * -(-(h // kv) // g)
    with torch.cuda.device(dev):
        n_split, split_len = decode_splits(
            sc, tiles, _sm_count(torch.cuda.current_device()))
        part = torch.empty(b * h * n_split * (dh + 2) if n_split > 1 else 0,
                           dtype=torch.float32, device=dev)
        lib = _build.load("decode_attention")
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets = _ticket_buffer(dev, stream, tiles)
        _build.check(lib.decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
            kp.data_ptr(), out.data_ptr(), part.data_ptr(),
            tickets.data_ptr(), b, sc, h, kv, dh, g, n_split, split_len,
            q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
            dh ** -0.5, int(window), float(softcap), int(sink),
            _DTYPES[q.dtype], stream), "decode_attention")
    launches["decode_attention"] += 1
    return out
