"""Chunked gated-linear-attention kernel for mLSTM (xLSTM) and Mamba/SSD
(Hymba) heads (``csrc/gla_chunk.cu``).

It replaces the Pallas kernel of the JAX package's ``kernels/gla_chunk.py``.
bf16 takes the tensor-core route, four CUDA launches a call: a state
kernel forms every chunk's gates and own state contribution in parallel, a
scan kernel carries the states over the chunks in f32 and leaves each
chunk's entering state in a scratch as bf16 hi and lo planes, a score
kernel writes each chunk's decayed, masked scores once, and an output
kernel computes every (chunk, query rows, 128 columns of dv) tile in
parallel (:data:`STATE_TILE`, :data:`SCORE_TILE`, :data:`OUT_TILE`).  The
scratch is allocated here: ``nc*B*H*(8*dk*dv + 8*dk + 4*AP*AP*65/64)``
bytes with ``nc = S/chunk`` and ``AP = 64 ceil(chunk/64)`` (76 MB at
xLSTM-350M's prefill).  f32 takes the CUDA-core kernel, one launch, one
block per (batch row, head, 32 columns of dv) walking the chunks in order,
with the within-chunk cumulative decay formed here with ``torch.cumsum``,
as the JAX wrapper forms it outside its kernel.  q, k are ``(B, S, H,
dk)`` and v ``(B, S, H, dv)``, read through their strides (the last axis
contiguous, every row on a 16-byte boundary); the log gates ``(B, S, H)``
are taken in f32.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version
:func:`repro_torch.kernels.ref.gla_chunk_plain`.  ``launches`` counts one
per wrapper call, whatever the route launched.

:func:`plain_grads` is the kernel's gradient: autograd of
:func:`repro_torch.kernels.ref.gla_chunk_plain`, recomputed (the custom
op ``repro_torch::gla_chunk`` of :mod:`repro_torch.kernels.ops` registers
it), as the JAX trainer trains through its XLA route (the Pallas kernel
defines no backward rule).
"""
from __future__ import annotations

import torch

from . import _build
from .flash_attention import _DTYPES, check_rows_16b
from .ref import gla_chunk_plain

MAX_CHUNK = 256
MAX_DK = 512

# The tensor-core route's tiles, as csrc/gla_chunk.cu fixes them: the state
# kernel's block covers (dk rows, dv columns) of one chunk, the score
# kernel's a SCORE_TILE x SCORE_TILE tile of a chunk's scores, the output
# kernel's (query rows of a chunk, dv columns); the scan's block has
# SCAN_THREADS threads of 4 elements each.
STATE_TILE = (64, 64)
SCORE_TILE = 64
OUT_TILE = (128, 128)
SCAN_THREADS = 256
# Up to this dk (rounded up to 16) the output kernel's blocks take 64 query
# rows, not OUT_TILE[0].
OUT_SMALL_DK = 64

# Kernel launches, one per wrapper call that launched on the card.
launches = {"gla_chunk": 0}


def tc_blocks(b: int, s: int, h: int, dk: int, dv: int, chunk: int) -> dict:
    """Blocks of the tensor-core route's four grids for one call."""
    cdiv = lambda a, d: -(-a // d)
    nc, rt = s // chunk, cdiv(chunk, SCORE_TILE)
    rows = OUT_TILE[0] if cdiv(dk, 16) * 16 > OUT_SMALL_DK else 64
    return {"gla_state_kernel": nc * b * h * cdiv(dk, STATE_TILE[0])
            * cdiv(dv, STATE_TILE[1]),
            "gla_scan_kernel": cdiv(b * h * dk * (dv + 1) // 4, SCAN_THREADS),
            "gla_score_kernel": nc * b * h * rt * (rt + 1) // 2,
            "gla_out_kernel": nc * cdiv(chunk, rows) * b * h
            * cdiv(dv, OUT_TILE[1])}


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
    s0 = n0 = None
    if init_state is not None:
        s0, n0 = (x.float().contiguous() for x in init_state)
    y = torch.empty((b, s, h, dv), dtype=q.dtype, device=dev)
    sT = torch.empty((b, h, dk, dv), dtype=torch.float32, device=dev)
    nT = torch.empty((b, h, dk), dtype=torch.float32, device=dev)
    lf = lg = scr_s = scr_f = None
    if q.dtype == torch.bfloat16:
        # the kernels form bc, li from the (B, S, H) gates themselves, and
        # keep the chunks' states, normalisers and scores in the scratch
        lf, lg = (x.float().contiguous() for x in (log_f, log_i))
        bc = torch.empty((b * h, s), dtype=torch.float32, device=dev)
        li = torch.empty((b * h, s), dtype=torch.float32, device=dev)
        nc, ap = s // chunk, 64 * -(-chunk // 64)
        scr_s = torch.empty(2 * nc * b * h * dk * dv, dtype=torch.bfloat16,
                            device=dev)
        scr_f = torch.empty(
            nc * b * h * (dk * dv + 2 * dk + ap * ap * 65 // 64),
            dtype=torch.float32, device=dev)
    else:
        heads = lambda x: x.float().transpose(1, 2)        # (B,H,S)
        bc = torch.cumsum(heads(log_f).reshape(b, h, s // chunk, chunk),
                          dim=-1).reshape(b * h, s).contiguous()
        li = heads(log_i).reshape(b * h, s).contiguous()
    with torch.cuda.device(dev):
        lib = _build.load("gla_chunk")
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptr = lambda x: None if x is None else x.data_ptr()
        _build.check(lib.gla_chunk(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bc.data_ptr(),
            li.data_ptr(), ptr(lf), ptr(lg), ptr(s0), ptr(n0), y.data_ptr(),
            sT.data_ptr(), nT.data_ptr(), ptr(scr_s), ptr(scr_f), b, s, h,
            dk, dv, chunk, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            dk ** -0.5, int(bool(normalize)), _DTYPES[q.dtype], stream),
            "gla_chunk")
    launches["gla_chunk"] += 1
    return y, (sT, nT)


def plain_grads(q, k, v, log_f, log_i, s0, n0, grads_out, need, *, chunk,
                normalize):
    """Gradients of q, k, v, log_f, log_i, s0, n0 (None where ``need`` is
    false or the input is None) from autograd of
    :func:`repro_torch.kernels.ref.gla_chunk_plain`, recomputed on the same
    inputs."""
    with torch.enable_grad():
        ins = [None if t is None else t.detach().requires_grad_(n)
               for t, n in zip((q, k, v, log_f, log_i, s0, n0), need)]
        q, k, v, log_f, log_i, s0, n0 = ins
        init = None if s0 is None else (s0, n0)
        y, (sT, nT) = gla_chunk_plain(q, k, v, log_f, log_i,
                                      init_state=init, chunk=chunk,
                                      normalize=normalize)
        wrt = [t for t in ins if t is not None and t.requires_grad]
        got = iter(torch.autograd.grad((y, sT, nT), wrt, grads_out,
                                       allow_unused=True))
    return [next(got) if t is not None and t.requires_grad else None
            for t in ins]
