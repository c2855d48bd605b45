"""The LM kernels as ``torch.library`` custom ops: the counterpart of the
JAX package's ``kernels/ops.py``.

    torch.ops.repro_torch.flash_attention(q, k, v, q_pos, k_pos, window,
                                          softcap, sink)
    torch.ops.repro_torch.decode_attention(...)        the same arguments
    torch.ops.repro_torch.gla_chunk(q, k, v, log_f, log_i, s0, n0, chunk,
                                    normalize) -> (y, S, n)

Each op runs its wrapper (:mod:`.flash_attention`,
:mod:`.decode_attention`, :mod:`.gla_chunk`: the CUDA kernel for a tensor
on the card, the plain version for one on the CPU), and has

- a fake implementation, so that a dry run under ``FakeTensorMode``
  traces the route the card runs and allocates nothing;
- a FLOP formula for ``FlopCounterMode``: the products the kernel does
  for the pairs its masks keep (causal, window), two per (query, key,
  head, feature) and product;
- a DTensor sharding rule: batch over any mesh dim, or heads when H and
  KV both divide every mesh dim (contiguous head blocks then keep whole
  GQA groups), or everything replicated; DTensor picks the rule that
  moves the least;
- gradients (``register_autograd``) from autograd of the plain version,
  recomputed in the backward (``plain_grads`` of :mod:`.flash_attention`
  and :mod:`.gla_chunk`; the JAX kernels define no backward, and the
  decode kernel has none here either).  On DTensors that
  backward runs shard by shard (``local_map``: batch rows and head blocks
  are independent), so it moves nothing between devices; a dry run
  counts its products and its local (B, H, Sq, Sk) f32 logits.

A dry run's memory counts each op's outputs, not a kernel's scratch.
"""
from __future__ import annotations

import torch
from torch import Tensor

from .decode_attention import decode_attention as _decode
from .flash_attention import flash_attention as _flash
from .flash_attention import plain_grads as fa_plain_grads
from .gla_chunk import gla_chunk as _gla
from .gla_chunk import plain_grads as gla_plain_grads

_NS = "repro_torch"


# ---------------------------------------------------------------------------
# flash_attention (prefill and training)
# ---------------------------------------------------------------------------
@torch.library.custom_op(f"{_NS}::flash_attention", mutates_args=())
def flash_attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                    k_pos: Tensor, window: int, softcap: float,
                    sink: int) -> Tensor:
    # contiguous, as the fake implementation says (the kernel's output is;
    # the plain version's need not be)
    return _flash(q, k, v, q_pos, k_pos, window=window, softcap=softcap,
                  sink=sink).contiguous()


@flash_attention.register_fake
def _(q, k, v, q_pos, k_pos, window, softcap, sink):
    return torch.empty_like(q)


def _fa_setup(ctx, inputs, output):
    q, k, v, q_pos, k_pos, window, softcap, sink = inputs
    ctx.save_for_backward(q, k, v, q_pos, k_pos)
    ctx.opts = (window, softcap, sink)


def _shard_local(placements, shapes, dims, mesh) -> list:
    """``placements`` kept where each is a ``Shard`` of one of ``dims``
    that divides every tensor of ``shapes`` evenly, else replicated."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for i, p in enumerate(placements):
        ok = isinstance(p, Shard) and p.dim in dims and all(
            sh[p.dim] % mesh.size(i) == 0 for sh in shapes)
        out.append(p if ok else Replicate())
    return out


def _grad_layout(g, t):
    """``g`` laid out as the input ``t`` was (the op's rule may have moved
    the input before the kernel ran); a pending sum's gradient is
    replicated."""
    from torch.distributed.tensor import Replicate
    want = [Replicate() if p.is_partial() else p for p in t.placements]
    return g.redistribute(g.device_mesh, want)


def _fa_backward(ctx, grad):
    from torch.distributed.tensor import DTensor
    window, softcap, sink = ctx.opts
    q, k, v, q_pos, k_pos = ctx.saved_tensors
    need = ctx.needs_input_grad[:3]
    if not isinstance(q, DTensor):
        grads = fa_plain_grads(q, k, v, q_pos, k_pos, grad, need,
                               window=window, softcap=softcap, sink=sink)
        return (*grads, None, None, None, None, None)
    # batch rows and head blocks are independent: each shard's gradients
    # from its own inputs, as the forward op's sharding rule ran them
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    pl = _shard_local(q.placements, (q.shape, k.shape), (0, 2), mesh)
    rep = [Replicate()] * mesh.ndim

    def local(q_, k_, v_, qp, kp, g_):
        return tuple(torch.zeros_like(t) if d is None else d.contiguous()
                     for t, d in zip((q_, k_, v_), fa_plain_grads(
                         q_, k_, v_, qp, kp, g_, need, window=window,
                         softcap=softcap, sink=sink)))

    grads = local_map(local, out_placements=(pl,) * 3,
                      in_placements=(pl, pl, pl, rep, rep, pl),
                      device_mesh=mesh, redistribute_inputs=True)(
                          q, k, v, q_pos, k_pos, grad)
    grads = [_grad_layout(g, t) if n else None
             for g, t, n in zip(grads, (q, k, v), need)]
    return (*grads, None, None, None, None, None)


flash_attention.register_autograd(_fa_backward, setup_context=_fa_setup)


# ---------------------------------------------------------------------------
# decode_attention (one query position against a cache; no backward)
# ---------------------------------------------------------------------------
@torch.library.custom_op(f"{_NS}::decode_attention", mutates_args=())
def decode_attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                     k_pos: Tensor, window: int, softcap: float,
                     sink: int) -> Tensor:
    return _decode(q, k, v, q_pos, k_pos, window=window, softcap=softcap,
                   sink=sink).contiguous()


@decode_attention.register_fake
def _(q, k, v, q_pos, k_pos, window, softcap, sink):
    return torch.empty_like(q)


# ---------------------------------------------------------------------------
# gla_chunk (mLSTM / SSD heads)
# ---------------------------------------------------------------------------
@torch.library.custom_op(f"{_NS}::gla_chunk", mutates_args=())
def gla_chunk(q: Tensor, k: Tensor, v: Tensor, log_f: Tensor,
              log_i: Tensor, s0: Tensor | None, n0: Tensor | None,
              chunk: int, normalize: bool) -> tuple[Tensor, Tensor, Tensor]:
    init = None if s0 is None else (s0, n0)
    y, (s, n) = _gla(q, k, v, log_f, log_i, chunk=chunk,
                     normalize=normalize, init_state=init)
    return y.contiguous(), s.contiguous(), n.contiguous()


def _gla_shapes(q, v):
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    return (q.new_empty((b, s, h, dv)),
            q.new_empty((b, h, dk, dv), dtype=torch.float32),
            q.new_empty((b, h, dk), dtype=torch.float32))


@gla_chunk.register_fake
def _(q, k, v, log_f, log_i, s0, n0, chunk, normalize):
    return _gla_shapes(q, v)


def _gla_setup(ctx, inputs, output):
    q, k, v, log_f, log_i, s0, n0, chunk, normalize = inputs
    ctx.save_for_backward(q, k, v, log_f, log_i, s0, n0)
    ctx.opts = dict(chunk=chunk, normalize=normalize)


def _gla_backward(ctx, gy, gs, gn):
    from torch.distributed.tensor import DTensor
    saved = ctx.saved_tensors
    need = ctx.needs_input_grad[:7]
    q = saved[0]
    if not isinstance(q, DTensor):
        grads = gla_plain_grads(*saved, (gy, gs, gn), need, **ctx.opts)
        return (*grads, None, None)
    # batch rows and heads are independent: each shard's gradients from
    # its own inputs
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    seq = _shard_local(q.placements, (q.shape,), (0, 2), mesh)
    state = [Shard(1) if isinstance(p, Shard) and p.dim == 2 else p
             for p in seq]
    has = [t is not None for t in saved]
    ins = [seq] * 5 + [state, state]

    def local(*args):
        tensors, grads_out = args[:-3], args[-3:]
        it = iter(tensors)
        full = [next(it) if h else None for h in has]
        got = gla_plain_grads(*full, tuple(grads_out), need, **ctx.opts)
        # in the plain version's layout, as on plain tensors: the ops
        # after them then take the same code paths (a CPU softplus
        # backward rounds otherwise on a contiguous tensor than on a
        # strided one), so DTensor steps equal plain ones bit for bit
        return tuple(torch.zeros_like(t) if g is None else g
                     for t, g in zip(full, got) if t is not None)

    # an output the loss does not use gets a plain zero gradient of the
    # global shape: split it as that output is
    from torch.distributed.tensor import distribute_tensor
    gy, gs, gn = (g if isinstance(g, DTensor) else distribute_tensor(
        g, mesh, pl) for g, pl in ((gy, seq), (gs, state), (gn, state)))
    live = [t for t in saved if t is not None]
    outs = [p for p, h in zip(ins, has) if h]
    got = iter(local_map(local, out_placements=tuple(outs),
                         in_placements=tuple(outs) + (seq, state, state),
                         device_mesh=mesh, redistribute_inputs=True)(
                             *live, gy, gs, gn))
    grads = [next(got) if h else None for h in has]
    grads = [_grad_layout(g, t) if n and g is not None else None
             for g, t, n in zip(grads, saved, need)]
    return (*grads, None, None)


gla_chunk.register_autograd(_gla_backward, setup_context=_gla_setup)


def gla_chunk_kernel_apply(q, k, v, log_f, log_i, *, chunk: int = 256,
                           normalize: bool = True, init_state=None):
    """Adapter with the ``models/ssm.py`` ``chunked_gla`` return
    convention: ``(y, (S, n))``."""
    s0, n0 = init_state if init_state is not None else (None, None)
    y, s, n = gla_chunk(q, k, v, log_f, log_i, s0, n0, chunk, normalize)
    return y, (s, n)


# ---------------------------------------------------------------------------
# FLOP formulas (products only; the kernels' elementwise work is not counted)
# ---------------------------------------------------------------------------
def visible_pairs(sq: int, sk: int, window: int) -> int:
    """(query, key) pairs the causal (and window) masks keep when the
    ``sq`` queries are the last ``sq`` of ``sk`` consecutive positions."""
    w = window if window > 0 else sk
    first = sk - sq + 1            # row i sees min(first + i, w) keys
    n = max(0, min(sq, w - first + 1))        # rows below the window cap
    return n * first + n * (n - 1) // 2 + (sq - n) * w


def attention_flops(q_shape, k_shape, window: int) -> int:
    b, sq, h, dh = q_shape
    sk = k_shape[1]
    return 4 * b * h * dh * visible_pairs(sq, sk, window)


def gla_flops(q_shape, v_shape, chunk: int) -> int:
    """Chunked GLA's products: each chunk's scores (c x c x dk, causal
    half), their product with v, the queries against the carried state
    and the state's update (dk x dv a position each)."""
    b, s, h, dk = q_shape
    dv = v_shape[-1]
    c = min(chunk, s)
    pairs = s * (c + 1) // 2
    return 2 * b * h * (pairs * (dk + dv) + 2 * s * dk * dv)


def _register_flops():
    from torch.utils.flop_counter import register_flop_formula
    ops = torch.ops.repro_torch

    @register_flop_formula([ops.flash_attention, ops.decode_attention])
    def _(q, k, v, q_pos, k_pos, window, softcap, sink, *a, out_shape=None,
          **kw):
        return attention_flops(q, k, window)

    @register_flop_formula(ops.gla_chunk)
    def _(q, k, v, log_f, log_i, s0, n0, chunk, normalize, *a,
          out_shape=None, **kw):
        return gla_flops(q, v, chunk)


# ---------------------------------------------------------------------------
# DTensor sharding rules
# ---------------------------------------------------------------------------
def _register_sharding():
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    ops = torch.ops.repro_torch
    R = Replicate()

    def heads_split(spec, *counts) -> bool:
        """Heads may split over a mesh dim when each count divides it
        (the rule is offered to every dim of the mesh)."""
        mesh = spec.mesh
        return all(n > 1 and n % mesh.size(i) == 0 for n in counts
                   for i in range(mesh.ndim))

    def attention_rules(q, k, *rest):
        rules = [([R], [R, R, R, R, R, None, None, None]),
                 ([Shard(0)], [Shard(0)] * 3 + [R, R, None, None, None])]
        if heads_split(q, q.shape[2], k.shape[2]):
            rules.append(([Shard(2)], [Shard(2)] * 3
                          + [R, R, None, None, None]))
        return rules

    @register_sharding([ops.flash_attention.default,
                        ops.decode_attention.default])
    def _(q, k, v, q_pos, k_pos, window, softcap, sink):
        return attention_rules(q, k)

    @register_sharding(ops.gla_chunk.default)
    def _(q, k, v, log_f, log_i, s0, n0, chunk, normalize):
        st = lambda p: p if s0 is not None else None
        pairs = [(R, R), (Shard(0), Shard(0))]
        if heads_split(q, q.shape[2]):
            pairs.append((Shard(2), Shard(1)))
        out = []
        for seq, state in pairs:
            out.append(([seq, state, state],
                        [seq] * 5 + [st(state), st(state), None, None]))
        return out


_register_flops()
_register_sharding()
