"""Linear-recurrence sequence mixers: mLSTM (xLSTM), Mamba-2-style SSD
(Hymba's parallel SSM heads) and sLSTM.

The counterpart of the JAX package's ``models/ssm.py``.  mLSTM and SSD are
one gated-linear-attention recurrence

    S_t = f_t * S_{t-1} + i_t * k_t v_t^T        (state: d_k x d_v per head)
    n_t = f_t * n_{t-1} + i_t * k_t              (mLSTM normalizer)
    y_t = q_t^T S_t [/ max(|q_t . n_t|, 1)]

run chunkwise over a prompt (:func:`chunked_gla`, the ``gla_chunk``
kernel) and one step at a time in decode (:func:`gla_decode_step`, plain
PyTorch, as in the JAX package).  ``use_kernel=True`` takes the kernel
(its plain version for CPU tensors), ``"ref"`` the plain version on any
device; the JAX module's XLA route (``use_kernel=False``) and its
``unroll`` knob have no counterpart here.  The kernel route is the custom
op ``torch.ops.repro_torch.gla_chunk`` (:mod:`repro_torch.kernels.ops`:
the kernel forward, the plain version's gradients when autograd records,
a DTensor sharding rule).  Parameters are
plain dicts; the leaves the JAX package keeps in f32 inside a bf16 model
(:data:`F32_LEAVES`) are f32 here too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.ref import gla_chunk_plain
from .layers import init_dense, merge_heads, split_heads

# Parameter leaves created in f32 whatever the model's dtype (the gate and
# step-size projections, the SSD decay and skip, the hybrid mixing scalars,
# the MoE router).
F32_LEAVES = frozenset({"w_gates", "w_dt", "a_log", "d_skip", "b_attn",
                        "b_mamba", "router"})


# ---------------------------------------------------------------------------
# Core chunkwise gated linear attention.
# Shapes: q,k (B,S,H,dk) v (B,S,H,dv); log_f, log_i (B,S,H) (log-space gates).
# ---------------------------------------------------------------------------
def chunked_gla(q, k, v, log_f, log_i, *, chunk: int = 256,
                normalize: bool = True, init_state=None, use_kernel=True):
    """Returns (y (B,S,H,dv) in q's dtype, (S (B,H,dk,dv), n (B,H,dk)))."""
    if use_kernel is not True and use_kernel != "ref":
        raise ValueError(f"use_kernel must be True (the kernel) or 'ref' "
                         f"(its plain version), not {use_kernel!r}")
    b, s = q.shape[:2]
    chunk = min(chunk, s)
    if s % chunk:
        # Pad to a chunk multiple with no-op tokens (f=1, i~0): the carried
        # state passes through unchanged and padded outputs are discarded.
        pad = chunk - s % chunk

        def padf(x, val):
            tail = torch.full((b, pad, *x.shape[2:]), val, dtype=x.dtype,
                              device=x.device)
            return torch.cat([x, tail], dim=1)

        y, st = chunked_gla(padf(q, 0), padf(k, 0), padf(v, 0),
                            padf(log_f, 0.0), padf(log_i, -30.0),
                            chunk=chunk, normalize=normalize,
                            init_state=init_state, use_kernel=use_kernel)
        return y[:, :s], st
    if use_kernel is True:
        # the kernel op: its forward on the card, the plain version's
        # gradients when autograd records
        return ops.gla_chunk_kernel_apply(q, k, v, log_f, log_i, chunk=chunk,
                                          normalize=normalize,
                                          init_state=init_state)
    return gla_chunk_plain(q, k, v, log_f, log_i, chunk=chunk,
                           normalize=normalize, init_state=init_state)


def gla_decode_step(q, k, v, log_f, log_i, state, *, normalize: bool = True):
    """Single-token recurrent update. q,k (B,H,dk), v (B,H,dv), gates (B,H)."""
    S, n = state
    dk = q.shape[-1]
    f = torch.exp(log_f.float())[..., None]
    i = torch.exp(log_i.float())[..., None]
    kf = k.float()
    S = f[..., None] * S + (i * kf)[..., None] * v.float()[..., None, :]
    n = f * n + i * kf
    qf = q.float() * dk ** -0.5
    # the contractions as products and sums over k, which a DTensor state
    # split over batch and heads runs shard by shard (an einsum flattens
    # (b, h) into a matmul's batch, which DTensor refuses for split dims)
    y = (qf[..., None] * S).sum(-2)
    if normalize:
        den = torch.clamp(torch.abs((qf * n).sum(-1)), min=1.0)
        y = y / den[..., None]
    return y.to(q.dtype), (S, n)


def init_gla_state(batch: int, n_heads: int, dk: int, dv: int, device=None):
    return (torch.zeros((batch, n_heads, dk, dv), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, n_heads, dk), dtype=torch.float32,
                        device=device))


def causal_conv(x, w, tail=None):
    """x (B,S,C), w (K,C) depthwise causal conv; ``tail`` (B,K-1,C) carries
    state across decode steps. Returns (y, new_tail)."""
    k = w.shape[0]
    pad = (torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device) if tail is None else tail)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    return y, (xp[:, -(k - 1):] if k > 1 else None)


def _conv_init(g: torch.Generator, conv_k: int, c: int, dtype):
    return (torch.randn((conv_k, c), generator=g, device=g.device)
            * 0.1).to(dtype)


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM): up-proj -> causal conv -> heads -> GLA -> gated down.
# ---------------------------------------------------------------------------
def init_mlstm(generator: torch.Generator, d: int, n_heads: int,
               proj_factor: float = 2.0, conv_k: int = 4,
               dtype=torch.bfloat16) -> dict:
    g, di = generator, int(d * proj_factor)
    return {
        "w_up": init_dense(g, d, 2 * di, dtype),           # x and z gate
        "conv": _conv_init(g, conv_k, di, dtype),
        "wq": init_dense(g, di, di, dtype),
        "wk": init_dense(g, di, di, dtype),
        "wv": init_dense(g, di, di, dtype),
        "w_gates": init_dense(g, di, 2 * n_heads, torch.float32),
        "skip": torch.ones((di,), dtype=dtype, device=g.device),
        "w_down": init_dense(g, di, d, dtype),
    }


def mlstm_apply(p, x, *, n_heads: int, state=None, conv_tail=None,
                chunk: int = 256, use_kernel=True):
    """x: (B,S,d). state/conv_tail carry decode state. Returns
    (out, (state, conv_tail))."""
    b, s, _ = x.shape
    xi, z = torch.chunk(x @ p["w_up"], 2, dim=-1)
    di = xi.shape[-1]
    dh = di // n_heads
    xc, conv_tail = causal_conv(xi, p["conv"], conv_tail)
    xc = F.silu(xc)
    q = split_heads(xc @ p["wq"], n_heads, dh)
    k = split_heads(xc @ p["wk"], n_heads, dh)
    v = split_heads(xi @ p["wv"], n_heads, dh)
    gates = split_heads(xc.float() @ p["w_gates"], n_heads, 2)
    # log-sigmoid as -softplus(-x), jax.nn.log_sigmoid's own form (and one
    # DTensor shards: it has no rule for the fused log_sigmoid op)
    log_i = -F.softplus(-gates[..., 0])
    log_f = -F.softplus(-gates[..., 1])
    if s == 1 and state is not None:
        y, state = gla_decode_step(q[:, 0], k[:, 0], v[:, 0],
                                   log_f[:, 0], log_i[:, 0], state)
        y = y[:, None]
    else:
        y, state = chunked_gla(q, k, v, log_f, log_i, chunk=chunk,
                               init_state=state, use_kernel=use_kernel)
    y = merge_heads(y) + xc * p["skip"]
    out = (y * F.silu(z)) @ p["w_down"]
    return out, (state, conv_tail)


# ---------------------------------------------------------------------------
# Mamba(-2/SSD-style) mixer for Hymba's parallel SSM heads.
# ---------------------------------------------------------------------------
def init_mamba(generator: torch.Generator, d: int, d_inner: int,
               n_heads: int, d_state: int, conv_k: int = 4,
               dtype=torch.bfloat16) -> dict:
    g = generator
    return {
        "w_in": init_dense(g, d, 2 * d_inner, dtype),        # x and z
        "conv": _conv_init(g, conv_k, d_inner, dtype),
        "w_bc": init_dense(g, d_inner, 2 * d_state * n_heads, dtype),
        "w_dt": init_dense(g, d_inner, n_heads, torch.float32),
        "a_log": torch.zeros((n_heads,), dtype=torch.float32,
                             device=g.device),                # A = -exp(a_log)
        "d_skip": torch.ones((n_heads,), dtype=torch.float32,
                             device=g.device),
        "w_out": init_dense(g, d_inner, d, dtype),
    }


def mamba_apply(p, x, *, n_heads: int, d_state: int, state=None,
                conv_tail=None, chunk: int = 256, use_kernel=True):
    """SSD: scalar decay per head; k=B, q=C, v=dt*x (head-split channels)."""
    b, s, _ = x.shape
    xi, z = torch.chunk(x @ p["w_in"], 2, dim=-1)
    d_inner = xi.shape[-1]
    ph = d_inner // n_heads                                   # channels/head
    xc, conv_tail = causal_conv(xi, p["conv"], conv_tail)
    xc = F.silu(xc)
    bc = split_heads(xc @ p["w_bc"], n_heads, 2 * d_state)
    bmat, cmat = torch.chunk(bc, 2, dim=-1)                   # (B,S,H,N)
    dt = F.softplus(xc.float() @ p["w_dt"])                   # (B,S,H)
    a = -torch.exp(p["a_log"])                                # (H,)
    log_f = dt * a
    log_i = torch.log(torch.clamp(dt, min=1e-6))
    v = split_heads(xc, n_heads, ph)
    # Note dk here = d_state, dv = channels-per-head.
    if s == 1 and state is not None:
        y, state = gla_decode_step(cmat[:, 0], bmat[:, 0], v[:, 0],
                                   log_f[:, 0], log_i[:, 0], state,
                                   normalize=False)
        y = y[:, None]
    else:
        y, state = chunked_gla(cmat, bmat, v, log_f, log_i, chunk=chunk,
                               normalize=False, init_state=state,
                               use_kernel=use_kernel)
    # the skip per head (v is xc split into heads)
    y = merge_heads(y + v * p["d_skip"][:, None].to(xc.dtype))
    out = (y * F.silu(z)) @ p["w_out"]
    return out, (state, conv_tail)


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM): scalar recurrence with exponential gating and a
# block-diagonal hidden-to-hidden recurrence, a Python loop over time.  As
# in the JAX package, no model config wires it in (``slstm_every = 0``).
# ---------------------------------------------------------------------------
def init_slstm(generator: torch.Generator, d: int, n_heads: int,
               dtype=torch.bfloat16) -> dict:
    g = generator
    dh = d // n_heads
    return {
        # input projections for i, f, z, o gates (4d)
        "w_x": init_dense(g, d, 4 * d, dtype),
        # block-diagonal recurrent weights per head: (H, dh, 4*dh)
        "w_h": (torch.randn((n_heads, dh, 4 * dh), generator=g,
                            device=g.device) * dh ** -0.5).to(dtype),
        "w_out": init_dense(g, d, d, dtype),
    }


def slstm_apply(p, x, *, n_heads: int, state=None):
    """x: (B,S,d). state: (c, n, h, m) each (B,H,dh) f32 — returns
    (out, state).

    Exponential gating with the max-stabilizer m (xLSTM eq. 19-25):
        i = exp(i~ - m'), f = exp(log-sigmoid(f~) + m - m')
        c = f*c + i*z ; n = f*n + i ; h = o * c/n
    """
    b, s, d = x.shape
    dh = d // n_heads
    gx = (x @ p["w_x"]).reshape(b, s, n_heads, 4 * dh)
    if state is None:
        z = torch.zeros((b, n_heads, dh), dtype=torch.float32,
                        device=x.device)
        state = (z, z + 1e-6, z, z)
    c, n, h, m = state
    w_h = p["w_h"].float()
    hs = []
    for t in range(s):
        rec = torch.einsum("bhd,hde->bhe", h, w_h)          # (B,H,4dh)
        it, ft, zt, ot = torch.chunk(gx[:, t].float() + rec, 4, dim=-1)
        log_f = F.logsigmoid(ft)
        m_new = torch.maximum(log_f + m, it)
        i = torch.exp(it - m_new)
        f = torch.exp(log_f + m - m_new)
        c = f * c + i * torch.tanh(zt)
        n = f * n + i
        h = torch.sigmoid(ot) * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    out = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    return out @ p["w_out"], (c, n, h, m)
