"""Chunked gated-linear-attention kernel for mLSTM (xLSTM) and Mamba/SSD
(Hymba) heads (``csrc/gla_chunk.cu``).

It replaces the Pallas kernel of the JAX package's ``kernels/gla_chunk.py``:
one block per (batch row, head, 32 columns of dv) walks the chunks in
order, keeping its slice of the f32 ``(dk x dv)`` state and the ``(dk,)``
normaliser in shared memory.  q, k are ``(B, S, H, dk)`` and v ``(B, S, H,
dv)``, read through their strides (the last axis contiguous, every row on
a 16-byte boundary), in bf16 or f32; the log gates ``(B, S, H)`` are taken
in f32, and the within-chunk cumulative decay is formed here with
``torch.cumsum``, as the JAX wrapper forms it outside its kernel.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version :func:`repro_torch.kernels.ref.gla_chunk_plain`.
"""
from __future__ import annotations

import torch

from . import _build
from .flash_attention import _DTYPES, check_rows_16b
from .ref import gla_chunk_plain

MAX_CHUNK = 256
MAX_DK = 512

# Kernel launches, one per wrapper call that launched on the card.
launches = {"gla_chunk": 0}


def _check(q, k, v, log_f, log_i, chunk, init_state):
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 \
            or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"q, k must be (B,S,H,dk) and v (B,S,H,dv); got "
                         f"{list(q.shape)}, {list(k.shape)}, "
                         f"{list(v.shape)}")
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if log_f.shape != (b, s, h) or log_i.shape != (b, s, h):
        raise ValueError(f"gates must be ({b},{s},{h}); got "
                         f"{list(log_f.shape)}, {list(log_i.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of bf16/f32; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    chunk = min(chunk, s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    if init_state is not None:
        s0, n0 = init_state
        if s0.shape != (b, h, dk, dv) or n0.shape != (b, h, dk):
            raise ValueError(f"init_state must be ({b},{h},{dk},{dv}) and "
                             f"({b},{h},{dk}); got {list(s0.shape)}, "
                             f"{list(n0.shape)}")
    tensors = [q, k, v, log_f, log_i] + list(init_state or ())
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cuda":
        if chunk > MAX_CHUNK or dk > MAX_DK or dk % 8 or dv % 8:
            raise ValueError(f"the kernel takes chunk <= {MAX_CHUNK}, "
                             f"dk <= {MAX_DK}, and dk, dv multiples of 8; "
                             f"got chunk {chunk}, dk {dk}, dv {dv}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_rows_16b(name, t)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev, chunk


def gla_chunk(q, k, v, log_f, log_i, *, chunk: int = 256,
              normalize: bool = True, init_state=None):
    """q,k (B,S,H,dk); v (B,S,H,dv); log gates (B,S,H); S a multiple of
    ``min(chunk, S)``; ``init_state`` (S0 (B,H,dk,dv), n0 (B,H,dk)) or None
    (zeros).  Returns (y (B,S,H,dv) in q's dtype, (S_state (B,H,dk,dv),
    n (B,H,dk)) in f32)."""
    dev, chunk = _check(q, k, v, log_f, log_i, chunk, init_state)
    if dev.type == "cpu":
        return gla_chunk_plain(q, k, v, log_f, log_i, chunk=chunk,
                               normalize=normalize, init_state=init_state)
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    heads = lambda x: x.float().transpose(1, 2)            # (B,H,S)
    bc = torch.cumsum(heads(log_f).reshape(b, h, s // chunk, chunk),
                      dim=-1).reshape(b * h, s).contiguous()
    li = heads(log_i).reshape(b * h, s).contiguous()
    s0 = n0 = None
    if init_state is not None:
        s0, n0 = (x.float().contiguous() for x in init_state)
    y = torch.empty((b, s, h, dv), dtype=q.dtype, device=dev)
    sT = torch.empty((b, h, dk, dv), dtype=torch.float32, device=dev)
    nT = torch.empty((b, h, dk), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        lib = _build.load("gla_chunk")
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.gla_chunk(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bc.data_ptr(),
            li.data_ptr(), None if s0 is None else s0.data_ptr(),
            None if n0 is None else n0.data_ptr(), y.data_ptr(),
            sT.data_ptr(), nT.data_ptr(), b, s, h, dk, dv, chunk,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], dk ** -0.5,
            int(bool(normalize)), _DTYPES[q.dtype], stream), "gla_chunk")
    launches["gla_chunk"] += 1
    return y, (sT, nT)
