"""Plain PyTorch versions of the port's kernels.

The ranking and lane-scatter functions compute exactly what their CUDA
kernels compute, in the same f32 operation order, so on the card the two
agree bit for bit (those kernels are built with ``--fmad=false``).  The
attention functions are the JAX package's oracles (``kernels/ref.py``):
an f32 softmax over the whole key axis, where the kernels run an online
softmax over key tiles, so the two differ only in the order of f32 sums.
``flash_attention_split_p`` and ``decode_attention_splits`` emulate the
rounding and the order of the two attention kernels (tensor-core products
with P split into two bf16 terms; per-split partial softmax states and
their merge); only tests use them.
``gla_chunk_plain`` is the chunkwise form of the GLA kernel's arithmetic
(the kernel sums the same f32 products in another order);
``gla_chunk_ref`` is the sequential oracle and ``gla_chunk_split`` the
emulation of the GLA kernel's tensor-core route (chunk-local states, a
scan over chunks, f32 operands split into bf16 hi + lo), both for tests.
Every kernel wrapper runs its plain version here for tensors that lie on
the CPU; on a CUDA tensor it launches the kernel.
"""
from __future__ import annotations

import numpy as np
import torch

# Scores at or above this value count as +inf in the victim selection (the
# kernel family's sentinel convention, judged by value, never by index).
SENTINEL = 3.4e38


def eq16_scores(lam, z, resid, sizes, omega: float) -> torch.Tensor:
    """Paper eq. 16 with Theorem-2 moments:
    ``(E[D] + omega * sigma[D]) / (max(R, 1e-6) * max(s, 1e-6))``."""
    z2 = z * z
    e = z + lam * z2
    var = z2 + 6.0 * lam * z2 * z + 5.0 * lam * lam * z2 * z2
    return (e + omega * torch.sqrt(var)) / (
        torch.clamp(resid, min=1e-6) * torch.clamp(sizes, min=1e-6))


def _masked(f, cached):
    return torch.where(cached & (f < SENTINEL), f, float("inf"))


def ranking_scores_ref(lam, z, resid, sizes, cached, omega: float):
    """Eq.-16 scores plus the masked argmin victim.

    Returns ``(scores [N], victim_idx, victim_score)``: the lowest score
    over cached entries (first index on ties); entries not cached, or
    scoring at or above :data:`SENTINEL`, count as +inf."""
    f = eq16_scores(lam, z, resid, sizes, omega)
    masked = _masked(f, cached)
    idx = torch.argmin(masked)
    return f, idx.to(torch.int32), masked[idx]


def victim_order_ref(scores, cached, top: int):
    """Masked ascending victim order: the ``top`` lowest-scored cached
    objects in ascending ``(score, index)`` order, as ``(idx i32[top],
    vals f32[top])``.  Non-cached entries are +inf, so once the real
    victims run out the order continues with +inf sentinels (in index
    order) and any rank-compare admission check fails closed.  This is the
    sequence an evict-until-fit loop re-running a masked argmin after each
    eviction would visit."""
    masked = torch.where(cached, scores, float("inf"))
    vals, idx = torch.sort(masked, stable=True)
    return idx[:top].to(torch.int32), vals[:top]


def ranking_victim_order_ref(lam, z, resid, sizes, cached, omega: float,
                             top: int):
    """Eq.-16 scores and the ``top`` victim order over them, as
    ``(scores [N], idx i32[top], vals f32[top])``; scores at or above
    :data:`SENTINEL` count as +inf."""
    f = eq16_scores(lam, z, resid, sizes, omega)
    vals, idx = torch.sort(_masked(f, cached), stable=True)
    return f, idx[:top].to(torch.int32), vals[:top]


def lane_scatter_set_ref(x, idx, val, valid=None):
    """``x[l, idx[l]] = val[l]`` for every lane ``l`` where ``valid[l]``
    (all lanes when None), in place; returns ``x``.  An invalid lane keeps
    its own bits."""
    lanes = torch.arange(x.shape[0], device=x.device)
    idx = idx.long()
    val = val.to(x.dtype)
    if valid is not None:
        val = torch.where(valid, val, x[lanes, idx])
    x[lanes, idx] = val
    return x


def lane_scatter_add_ref(x, idx, val, valid=None):
    """``x[l, idx[l]] += val[l]`` per valid lane, in place (logical OR for
    bool ``x``); returns ``x``.  The sum is formed on the gathered element."""
    lanes = torch.arange(x.shape[0], device=x.device)
    idx = idx.long()
    cur = x[lanes, idx]
    new = cur | val.to(torch.bool) if x.dtype == torch.bool \
        else cur + val.to(x.dtype)
    if valid is not None:
        new = torch.where(valid, new, cur)
    x[lanes, idx] = new
    return x


_HOST_DTYPES = {torch.float32: np.float32, torch.int32: np.int32,
                torch.bool: np.bool_}


def lane_host_vals(dtype, val, rows: int) -> np.ndarray:
    """A write's values as a host array of x's dtype, ``[rows]`` (a scalar
    broadcasts): the one conversion both the batch kernel and its plain
    version see."""
    a = np.asarray(val)
    if a.ndim == 0:
        a = np.broadcast_to(a, (rows,))
    if a.shape != (rows,):
        raise ValueError(f"val must be [{rows}], got {list(a.shape)}")
    return np.ascontiguousarray(a.astype(_HOST_DTYPES[dtype], copy=False))


def lane_scatter_batch_ref(writes):
    """:func:`lane_scatter_set_ref` / :func:`lane_scatter_add_ref` applied
    in list order.  Each write is ``(x [R, N], idx [R], val [R], valid [R]
    or None, add)`` with host (numpy) ``idx``, ``val`` and ``valid``; an
    index outside [0, N) is skipped (masked off like an invalid row)."""
    for x, idx, val, valid, add in writes:
        rows, n = x.shape
        idx = torch.from_numpy(np.asarray(idx, np.int64)).to(x.device)
        ok = (idx >= 0) & (idx < n)
        if valid is not None:
            ok &= torch.from_numpy(np.asarray(valid, np.bool_)).to(x.device)
        val = torch.from_numpy(lane_host_vals(x.dtype, val, rows))
        fn = lane_scatter_add_ref if add else lane_scatter_set_ref
        fn(x, torch.where(ok, idx, 0), val.to(x.device), ok)


# ---------------------------------------------------------------------------
# Attention (the oracles of csrc/flash_attention.cu, csrc/decode_attention.cu)
# ---------------------------------------------------------------------------
NEG_INF = -1e30      # finite, as in the JAX kernels: never -inf - -inf


def attention_keep(q_pos, k_pos, window: int = 0, sink: int = 0):
    """Causal (+ sliding-window, + sink) keep-mask ``(Sq, Sk)``; a key at a
    negative position (an empty cache slot) is never kept."""
    keep = (k_pos[None, :] <= q_pos[:, None]) & (k_pos >= 0)[None, :]
    if window > 0:
        in_win = k_pos[None, :] > (q_pos[:, None] - window)
        if sink > 0:
            in_win |= (k_pos < sink)[None, :]
        keep &= in_win
    return keep


def flash_attention_ref(q, k, v, q_pos, k_pos, *, window: int = 0,
                        softcap: float = 0.0, sink: int = 0):
    """q (B,Sq,H,dh), k/v (B,Sk,KV,dh) -> (B,Sq,H,dh) in q's dtype; f32
    logits, softcap before the mask, f32 softmax and product with v."""
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, dh).float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * dh ** -0.5
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    keep = attention_keep(q_pos, k_pos, window, sink)
    logits = torch.where(keep[None, None, None], logits,
                         torch.tensor(NEG_INF, dtype=torch.float32,
                                      device=logits.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(b, sq, h, dh).to(q.dtype)


def decode_attention_ref(q, k, v, q_pos, k_pos, *, window: int = 0,
                         softcap: float = 0.0, sink: int = 0):
    """Single-token decode: q (B,1,H,dh) against k/v (B,Sk,KV,dh)."""
    return flash_attention_ref(q, k, v, q_pos, k_pos, window=window,
                               softcap=softcap, sink=sink)


def _logits(qg, k, q_pos, k_pos, window, softcap, sink, dh):
    """Scaled, softcapped and masked f32 logits ``(B,KV,G,Sq,Sk)`` of the
    grouped queries ``qg (B,Sq,KV,G,dh)`` against ``k (B,Sk,KV,dh)``, as
    :func:`flash_attention_ref` forms them."""
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * dh ** -0.5
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    keep = attention_keep(q_pos, k_pos, window, sink)
    return torch.where(keep[None, None, None], logits,
                       torch.tensor(NEG_INF, dtype=torch.float32,
                                    device=logits.device))


def _bf16_terms(p):
    """``p`` (f32) as the two bf16 terms ``hi = bf16(p)``, ``lo = bf16(p -
    hi)`` that the tensor-core kernel multiplies with v, back in f32."""
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


def flash_attention_split_p(q, k, v, q_pos, k_pos, *, window: int = 0,
                            softcap: float = 0.0, sink: int = 0,
                            block_k: int = 64):
    """The rounding of ``csrc/flash_attention.cu``'s tensor-core (bf16)
    route, for tests: q.k products summed in f32, an online softmax over
    key tiles of ``block_k``, and P split into bf16 ``hi + lo`` whose
    products with v are summed in f32.  Same arguments and result as
    :func:`flash_attention_ref`."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, dh).float()
    m = torch.full((b, kv, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, kv, g, sq), device=q.device)
    acc = torch.zeros((b, kv, g, sq, dh), device=q.device)
    for k0 in range(0, sk, block_k):
        ks = slice(k0, k0 + block_k)
        s = _logits(qg, k[:, ks], q_pos, k_pos[ks], window, softcap, sink,
                    dh)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        hi, lo = _bf16_terms(p)
        vt = v[:, ks].float()
        acc = (acc * alpha[..., None]
               + torch.einsum("bkgqs,bskd->bkgqd", hi, vt)
               + torch.einsum("bkgqs,bskd->bkgqd", lo, vt))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


def decode_attention_splits(q, k, v, q_pos, k_pos, *, n_split: int,
                            split_len: int, window: int = 0,
                            softcap: float = 0.0, sink: int = 0):
    """The order of ``csrc/decode_attention.cu``, for tests: the cache cut
    into ``n_split`` ranges of ``split_len`` slots, each range's partial
    softmax state ``(m_s, l_s, acc_s)`` in f32, then the merge
    ``M = max m_s``, ``l = sum l_s e^(m_s - M)``, ``acc = sum acc_s
    e^(m_s - M)``, ``out = acc / max(l, 1e-30)``.  A range with no visible
    slot has ``m_s = -1e30`` and ``l_s`` = its slot count.  Same arguments
    and result as :func:`decode_attention_ref`."""
    b, sq, h, dh = q.shape
    sc, kv = k.shape[1], k.shape[2]
    if not (n_split - 1) * split_len < sc <= n_split * split_len:
        raise ValueError(f"{n_split} splits of {split_len} do not cut "
                         f"{sc} slots into non-empty ranges")
    qg = q.reshape(b, sq, kv, h // kv, dh).float()
    ms, ls, accs = [], [], []
    for i in range(n_split):
        ks = slice(i * split_len, (i + 1) * split_len)
        s = _logits(qg, k[:, ks], q_pos, k_pos[ks], window, softcap, sink,
                    dh)
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgqs,bskd->bkgqd", p, v[:, ks].float()))
    m = torch.stack(ms)
    w = torch.exp(m - m.amax(0))
    l = (torch.stack(ls) * w).sum(0)
    acc = (torch.stack(accs) * w[..., None]).sum(0)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Chunked gated linear attention (the oracles of csrc/gla_chunk.cu)
# ---------------------------------------------------------------------------
def gla_chunk_ref(q, k, v, log_f, log_i, *, normalize: bool = True):
    """Sequential-recurrence oracle of chunked GLA (the JAX package's
    ``gla_chunk_ref``), one time step at a time; for tests.

    q,k (B,S,H,dk), v (B,S,H,dv), gates (B,S,H) log-space.  Returns
    (y (B,S,H,dv) in q's dtype, (S_state (B,H,dk,dv), n (B,H,dk)) in f32)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    scale = dk ** -0.5
    S = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, h, dk), dtype=torch.float32, device=q.device)
    ys = []
    for t in range(s):
        f = torch.exp(log_f[:, t].float())[..., None]            # (B,H,1)
        i = torch.exp(log_i[:, t].float())[..., None]
        kf = k[:, t].float()
        S = f[..., None] * S + (i * kf)[..., None] * v[:, t].float()[..., None, :]
        n = f * n + i * kf
        qf = q[:, t].float() * scale
        y = torch.einsum("bhk,bhkv->bhv", qf, S)
        if normalize:
            den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", qf, n)),
                              min=1.0)
            y = y / den[..., None]
        ys.append(y)
    return torch.stack(ys, dim=1).to(q.dtype), (S, n)


def gla_chunk_plain(q, k, v, log_f, log_i, *, chunk: int = 256,
                    normalize: bool = True, init_state=None):
    """The plain version of the ``gla_chunk`` kernel: the Pallas kernel's
    chunkwise arithmetic (``src/repro/kernels/gla_chunk.py``), one chunk
    at a time over every (batch, head) at once.

    Per chunk of L positions, with ``bc`` the within-chunk inclusive
    cumulative log decay: the decayed read of the carried state
    ``(q * exp(bc)) @ S``; the masked L x L scores
    ``A_ts = (q_t . k_s) exp(bc_t - bc_s + li_s)`` for s <= t (``where``
    discards the exp overflows above the diagonal); the normaliser
    ``max(|sum_s A_ts + q_t . n|, 1)``; the state carry.  q is scaled by
    dk^-1/2; everything runs in f32.  S must be a multiple of the chunk
    (after ``chunk = min(chunk, S)``).  ``init_state`` is ``(S0 (B,H,dk,dv),
    n0 (B,H,dk))``, zeros when None.  Returns (y (B,S,H,dv) in q's dtype,
    (S_state, n) in f32)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    heads = lambda x: x.float().permute(0, 2, 1, 3)              # (B,H,S,d)
    qf, kf, vf = heads(q) * dk ** -0.5, heads(k), heads(v)
    li = log_i.float().permute(0, 2, 1)                          # (B,H,S)
    bc = torch.cumsum(log_f.float().permute(0, 2, 1).reshape(
        b, h, nc, chunk), dim=-1).reshape(b, h, s)
    if init_state is None:
        S = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
        n = torch.zeros((b, h, dk), dtype=torch.float32, device=q.device)
    else:
        S, n = (x.float() for x in init_state)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=q.device).tril()
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        qc, kc, vc, bx, lx = qf[:, :, sl], kf[:, :, sl], vf[:, :, sl], \
            bc[:, :, sl], li[:, :, sl]
        qd = qc * torch.exp(bx)[..., None]
        y_inter = qd @ S
        n_inter = (qd @ n[..., None])[..., 0]
        gpos = bx[..., :, None] - bx[..., None, :] + lx[..., None, :]
        gmat = torch.where(tri, torch.exp(gpos), 0.0)
        A = (qc @ kc.transpose(-1, -2)) * gmat
        y = A @ vc + y_inter
        if normalize:
            den = torch.clamp(torch.abs(A.sum(-1) + n_inter), min=1.0)
            y = y / den[..., None]
        ys.append(y)
        b_end = bx[..., -1]
        kw = kc * torch.exp(b_end[..., None] - bx + lx)[..., None]
        S = torch.exp(b_end)[..., None, None] * S + kw.transpose(-1, -2) @ vc
        n = torch.exp(b_end)[..., None] * n + kw.sum(-2)
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3).to(q.dtype)
    return y, (S, n)


def gla_chunk_split(q, k, v, log_f, log_i, *, chunk: int = 256,
                    normalize: bool = True, init_state=None,
                    split: bool = True):
    """The order and rounding of ``csrc/gla_chunk.cu``'s tensor-core (bf16)
    route, for tests.  Same arguments and result as :func:`gla_chunk_plain`.

    1. Chunk-local states: ``dS_c = (k * w)^T v`` and ``dn_c = sum_s k_s
       w_s`` with ``w_s = exp(bc_end - bc_s + li_s)``; ``k * w`` is formed
       in f32 and split into bf16 ``hi + lo``, each term's product with v
       summed in f32.
    2. The scan: ``S_in[0] = S0`` (zeros when None), ``S_in[c+1] =
       exp(bc_end_c) S_in[c] + dS_c``, the same for n, in f32.
    3. Outputs: q and k as they are (bf16 values), the scale and the decays
       as row factors after the products; ``A_ts = (q_t . k_s) g_ts`` for
       s <= t, and ``S_in`` each split into ``hi + lo`` against bf16 v and
       q; ``y = scale (exp(bc_t) q_t . S_in + sum_s A_ts v_s)``, divided by
       ``max(|scale (sum_s A_ts + exp(bc_t) q_t . n_in)|, 1)`` when
       normalising.

    ``split=False`` keeps every operand in f32: the same decomposition
    with no rounding of its own."""
    b, s, h, dk = q.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    terms = _bf16_terms if split else (lambda x: (x, torch.zeros_like(x)))
    heads = lambda x: x.float().permute(0, 2, 1, 3)              # (B,H,S,d)
    qf, kf, vf = heads(q), heads(k), heads(v)
    li = log_i.float().permute(0, 2, 1)                          # (B,H,S)
    bc = torch.cumsum(log_f.float().permute(0, 2, 1).reshape(
        b, h, nc, chunk), dim=-1).reshape(b, h, s)
    if init_state is None:
        S = torch.zeros((b, h, dk, v.shape[-1]), dtype=torch.float32,
                        device=q.device)
        n = torch.zeros((b, h, dk), dtype=torch.float32, device=q.device)
    else:
        S, n = (x.float() for x in init_state)
    chunks = [slice(c * chunk, (c + 1) * chunk) for c in range(nc)]
    s_in, n_in = [], []
    for sl in chunks:                                 # 1-2. states, scan
        s_in.append(S)
        n_in.append(n)
        bx, lx = bc[:, :, sl], li[:, :, sl]
        kw = kf[:, :, sl] * torch.exp(bx[..., -1:] - bx + lx)[..., None]
        hi, lo = terms(kw)
        vc = vf[:, :, sl]
        ds = hi.transpose(-1, -2) @ vc + lo.transpose(-1, -2) @ vc
        e = torch.exp(bx[..., -1])
        S = e[..., None, None] * S + ds
        n = e[..., None] * n + kw.sum(-2)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=q.device).tril()
    scale = dk ** -0.5
    ys = []
    for sl, s0, n0 in zip(chunks, s_in, n_in):        # 3. outputs
        qc, kc, vc, bx, lx = qf[:, :, sl], kf[:, :, sl], vf[:, :, sl], \
            bc[:, :, sl], li[:, :, sl]
        dec = torch.exp(bx)
        sh, slo = terms(s0)
        acc = dec[..., None] * (qc @ sh + qc @ slo)
        gpos = bx[..., :, None] - bx[..., None, :] + lx[..., None, :]
        A = (qc @ kc.transpose(-1, -2)) * torch.where(tri, torch.exp(gpos),
                                                      0.0)
        ah, al = terms(A)
        y = scale * (acc + ah @ vc + al @ vc)
        if normalize:
            qn = dec * (qc @ n0[..., None])[..., 0]
            den = torch.clamp(torch.abs(scale * (A.sum(-1) + qn)), min=1.0)
            y = y / den[..., None]
        ys.append(y)
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3).to(q.dtype)
    return y, (S, n)
