"""Prefill attention kernel: online-softmax causal attention with GQA,
sliding window, sink and tanh softcap (``csrc/flash_attention.cu``).

It replaces the Pallas kernel of the JAX package's
``kernels/flash_attention.py``.  q is ``(B, Sq, H, dh)`` and k/v are
``(B, Sk, KV, dh)``, read through their strides (the last axis contiguous,
every row on a 16-byte boundary), in bf16 or f32; ``q_pos (Sq,)`` and
``k_pos (Sk,)`` are the absolute positions, shared by every batch row,
with -1 for an empty key slot.  The softmax runs in f32 and the output
has q's dtype.  bf16 inputs take the tensor-core kernel (bf16 products
summed in f32, P split into two bf16 terms); f32 inputs take the
CUDA-core kernel, with both products in f32.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version in :mod:`repro_torch.kernels.ref`.

:func:`plain_grads` is the kernel's gradient: autograd of the plain
version, recomputed (the custom op ``repro_torch::flash_attention`` of
:mod:`repro_torch.kernels.ops` registers it).  That is what the JAX
trainer does (its Pallas kernels define no backward rule, so it trains
through its XLA route), so no backward kernel exists.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches, one per wrapper call that launched on the card.
launches = {"flash_attention": 0}


def check_rows_16b(name: str, t) -> None:
    """The kernels load rows of ``t`` (a (B, S, heads, d) tensor) 16 bytes
    at a time: its last axis must be contiguous and every row must start
    on a 16-byte boundary."""
    if t.stride(3) != 1:
        raise ValueError(f"{name}'s last axis must be contiguous")
    offs = [t.stride(i) * t.element_size() for i in range(3)
            if t.shape[i] > 1]
    if t.data_ptr() % 16 or any(o % 16 for o in offs):
        raise ValueError(f"{name}'s rows must start on 16-byte boundaries")


def check_attention_args(q, k, v, q_pos, k_pos):
    """Shapes, dtypes and devices shared by both attention kernels; returns
    the device."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B,Sq,H,dh) and k, v (B,Sk,KV,dh); got "
                         f"{list(q.shape)}, {list(k.shape)}, "
                         f"{list(v.shape)}")
    b, sq, h, dh = q.shape
    kb, sk, kv, kdh = k.shape
    if kb != b or kdh != dh or kv == 0 or h % kv:
        raise ValueError(f"k/v {list(k.shape)} do not fit q {list(q.shape)}"
                         f" (H must be a multiple of KV)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of bf16/f32; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q_pos.shape != (sq,) or k_pos.shape != (sk,):
        raise ValueError(f"q_pos must be ({sq},) and k_pos ({sk},); got "
                         f"{list(q_pos.shape)}, {list(k_pos.shape)}")
    devs = {t.device for t in (q, k, v, q_pos, k_pos)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cuda":
        if dh not in HEAD_DIMS:
            raise ValueError(f"d_head {dh} is not one of {HEAD_DIMS}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_rows_16b(name, t)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def flash_attention(q, k, v, q_pos, k_pos, *, window: int = 0,
                    softcap: float = 0.0, sink: int = 0) -> torch.Tensor:
    """q (B,Sq,H,dh); k,v (B,Sk,KV,dh); q_pos (Sq,), k_pos (Sk,) absolute
    positions.  Returns (B,Sq,H,dh)."""
    dev = check_attention_args(q, k, v, q_pos, k_pos)
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, q_pos, k_pos, window=window,
                                   softcap=softcap, sink=sink)
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=dev)
    qp = q_pos.to(torch.int32).contiguous()
    kp = k_pos.to(torch.int32).contiguous()
    with torch.cuda.device(dev):
        lib = _build.load("flash_attention")
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
            kp.data_ptr(), out.data_ptr(), b, sq, sk, h, kv, dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            dh ** -0.5, int(window), float(softcap), int(sink),
            _DTYPES[q.dtype], stream), "flash_attention")
    launches["flash_attention"] += 1
    return out


def plain_grads(q, k, v, q_pos, k_pos, grad_out, need, *, window, softcap,
                sink):
    """Gradients of q, k, v (None where ``need`` is false) from autograd
    of :func:`repro_torch.kernels.ref.flash_attention_ref`, recomputed on
    the same inputs."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip((q, k, v),
                                                             need)]
        out = flash_attention_ref(*ins, q_pos, k_pos, window=window,
                                  softcap=softcap, sink=sink)
        wrt = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad(out, wrt, grad_out))
    return [next(got) if n else None for n in need]
