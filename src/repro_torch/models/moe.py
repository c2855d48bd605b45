"""Top-k mixture of experts with capacity dispatch.

The counterpart of the JAX package's ``models/moe.py``.  Tokens are
dispatched within their data-parallel group: ``dp_group_count()`` groups
of contiguous batch rows (1 without a mesh, or when it does not divide
the batch), each with its own capacity, as the JAX module does.  On
DTensors the data-dependent part (routing, the dispatch scatter, the
gather back) runs shard by shard through ``local_map``, so it stays
shard-resident as the JAX module keeps it; the expert FFN between runs
as DTensor products, with the JAX module's ``constrain`` hints
(``moe_experts`` on the (G, E, cap, d) buffers, ``moe_ffn``).  Expert
weights stay stacked ``(E, d, f)`` and each expert's FFN is one batched
product over its buffer of ``cap`` token slots, as the JAX module's
einsums are.

What follows the reference term for term, because a usual PyTorch MoE
would drop or route other tokens:

- ``cap = int(max(top_k * Tg * capacity_factor / E, 4))`` in Python
  floats, ``Tg`` a group's tokens;
- the router runs in f32 (``x`` cast to f32, an f32 router), then a
  softmax, and the top ``k`` experts come from a stable descending sort,
  so a tie (a token of zeros has equal probabilities) takes the lower
  index first, as ``lax.top_k`` does;
- the gates are renormalised over the chosen ``k``;
- a choice's slot in its expert's buffer is the count of earlier choices
  of that expert in its group's flattened token-major ``(token, choice)``
  order;
  a choice whose slot reaches ``cap`` is dropped: it adds a zero payload
  at slot ``cap - 1`` and takes nothing back (it rides the residual);
- the load-balance loss is ``E * sum(mean probs * choice shares) * k``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sharding.activation import constrain, dp_group_count
from .layers import _gelu, init_dense


def init_moe(generator: torch.Generator, d: int, f: int, n_experts: int,
             act: str, dtype=torch.bfloat16) -> dict:
    """An f32 ``(d, E)`` router and ``E`` stacked expert MLPs (``w_up``,
    ``w_down`` and, when gated, ``w_gate``), with the JAX init's laws."""
    g = generator

    def stacked(d_in, d_out):
        w = torch.randn((n_experts, d_in, d_out), generator=g,
                        device=g.device, dtype=torch.float32)
        return (w * d_in ** -0.5).to(dtype)

    experts = {"w_up": stacked(d, f), "w_down": stacked(f, d)}
    if act in ("swiglu", "geglu"):
        experts["w_gate"] = stacked(d, f)
    return {"router": init_dense(g, d, n_experts, torch.float32),
            "experts": experts}


def _expert_ffn(experts: dict, buf: torch.Tensor, act: str) -> torch.Tensor:
    """buf (G, E, C, d) -> (G, E, C, d) through each expert's own FFN: one
    batched product an expert over its groups' slots (E, G*C, d), which
    keeps the group dim (data-parallel) apart from the expert dim
    (expert-parallel) on DTensors."""
    if act not in ("swiglu", "geglu", "gelu", "relu2"):
        raise ValueError(f"unknown mlp act {act!r}")
    g, e, c, d = buf.shape
    x = buf.permute(1, 0, 2, 3).reshape(e, g * c, d)
    if act in ("swiglu", "geglu"):
        gate = torch.bmm(x, experts["w_gate"])
        up = torch.bmm(x, experts["w_up"])
        gate = F.silu(gate) if act == "swiglu" else _gelu(gate)
        h = gate * up
    elif act == "gelu":
        h = _gelu(torch.bmm(x, experts["w_up"]))
    else:
        h = torch.square(F.relu(torch.bmm(x, experts["w_up"])))
    h = constrain(h, "moe_ffn")
    out = torch.bmm(h, experts["w_down"])
    return out.reshape(e, g, c, d).permute(1, 0, 2, 3)


def capacity(top_k: int, tokens: int, capacity_factor: float,
             n_experts: int) -> int:
    """Slots of each expert's buffer for ``tokens`` tokens."""
    return int(max(top_k * tokens * capacity_factor / n_experts, 4))


def route(router: torch.Tensor, xt: torch.Tensor, top_k: int):
    """Router of the (T, d) tokens ``xt``: (probs (T, E) f32, gate values
    (T, k) renormalised, expert ids (T, k) int64, ties to the lower id)."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    return probs, vals, idx


def dispatch(gate_idx: torch.Tensor, n_experts: int, cap: int):
    """Slots of each group's flattened token-major choices ``gate_idx``
    (G, Tg, k): (expert ids (G, Tg*k), slot (G, Tg*k), keep (G, Tg*k)
    bool)."""
    flat_e = gate_idx.reshape(gate_idx.shape[0], -1)
    oh = F.one_hot(flat_e, n_experts)
    pos_in_e = torch.cumsum(oh, dim=1) - oh
    flat_pos = torch.gather(pos_in_e, 2, flat_e[..., None])[..., 0]
    keep = flat_pos < cap
    return flat_e, torch.where(keep, flat_pos, cap - 1), keep


def _route_dispatch(router, x, groups: int, batch: int, top_k: int,
                    cap: int):
    """Routing and the dispatch scatter of the rows of ``x`` (B_l, S, d)
    (the whole batch of ``batch`` rows, or one shard of it, holding
    ``groups * B_l / batch`` groups): (buf (G_l, E, cap, d), probs (T_l,
    E) f32, choice counts (G_l, E), expert ids, slot, keep (G_l, Tg*k),
    gate values (G_l, Tg*k, 1) in x's dtype)."""
    b, s, d = x.shape
    e = router.shape[1]
    g = groups * b // batch
    tg = b * s // g
    xt = x.reshape(b * s, d)
    probs, gate_vals, gate_idx = route(router, xt, top_k)
    gate_idx = gate_idx.reshape(g, tg, top_k)
    counts = F.one_hot(gate_idx.reshape(g, -1), e).sum(1)
    flat_e, slot, keep = dispatch(gate_idx, e, cap)
    tok_src = torch.arange(tg, device=x.device)[:, None].expand(
        tg, top_k).reshape(-1)
    grp = torch.arange(g, device=x.device)[:, None].expand(g, tg * top_k)
    xg = xt.reshape(g, tg, d)
    payload = torch.where(keep[..., None], xg[:, tok_src],
                          torch.zeros((), dtype=x.dtype, device=x.device))
    buf = torch.zeros((g, e, cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((grp, flat_e, slot), payload, accumulate=True)
    w = gate_vals.reshape(g, tg * top_k, 1).to(x.dtype)
    return buf, probs, counts, flat_e, slot, keep, w


def _combine(out_buf, flat_e, slot, keep, w, top_k: int):
    """Each group's kept choices gathered back from ``out_buf`` (G_l, E,
    cap, d), weighted by their gates and summed over a token's choices in
    order, as the reference's scatter-add does: (G_l * Tg, d)."""
    g, tk = flat_e.shape
    d = out_buf.shape[-1]
    grp = torch.arange(g, device=out_buf.device)[:, None].expand(g, tk)
    picked = out_buf[grp, flat_e, slot]
    picked = torch.where(keep[..., None], picked,
                         torch.zeros((), dtype=out_buf.dtype,
                                     device=out_buf.device))
    contrib = (picked * w).reshape(g * tk // top_k, top_k, d)
    combined = contrib[:, 0]
    for j in range(1, top_k):
        combined = combined + contrib[:, j]
    return combined


def _sharded(fn, split: tuple, whole: tuple, *, n_out: int,
             dp_split: bool):
    """``fn(*split, *whole)`` on each shard (``local_map``): the DTensors of
    ``split`` by batch rows over the mesh's data-parallel dims when
    ``dp_split`` (else whole), those of ``whole`` replicated, every other
    mesh dim replicated; its ``n_out`` results are DTensors split as
    ``split``, along their first dim."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = split[0].device_mesh
    rows = [Shard(0) if dp_split and n in ("pod", "data") else Replicate()
            for n in mesh.mesh_dim_names]
    rep = [Replicate()] * mesh.ndim
    ins = (rows,) * len(split) + (rep,) * len(whole)
    return local_map(fn, out_placements=(rows,) * n_out, in_placements=ins,
                     device_mesh=mesh, redistribute_inputs=True)(
                         *split, *whole)


def moe_apply(p: dict, x: torch.Tensor, *, top_k: int, act: str,
              capacity_factor: float = 1.25):
    """x: (B, S, d) -> (out (B, S, d), aux load-balance loss, f32)."""
    from torch.distributed.tensor import DTensor
    b, s, d = x.shape
    e = p["experts"]["w_up"].shape[0]
    groups = dp_group_count()
    if b % groups:
        groups = 1
    t = b * s
    cap = capacity(top_k, t // groups, capacity_factor, e)
    router = p["router"]
    if isinstance(x, DTensor):
        dp = groups > 1

        def rd(x_, router_):
            return _route_dispatch(router_, x_, groups, b, top_k, cap)

        buf, probs, counts, flat_e, slot, keep, w = _sharded(
            rd, (x,), (router,), n_out=7, dp_split=dp)
    else:
        buf, probs, counts, flat_e, slot, keep, w = _route_dispatch(
            router, x, groups, b, top_k, cap)

    # Switch-style load-balance aux loss (global)
    me = probs.mean(dim=0)
    ce = counts.sum(0).float() / (t * top_k)
    aux = e * torch.sum(me * ce) * top_k

    buf = constrain(buf, "moe_experts")
    out_buf = _expert_ffn(p["experts"], buf, act)
    out_buf = constrain(out_buf, "moe_experts")

    if isinstance(x, DTensor):
        def cb(ob, fe, sl, kp, w_):
            return _combine(ob, fe, sl, kp, w_, top_k)

        combined = _sharded(cb, (out_buf, flat_e, slot, keep, w), (),
                            n_out=1, dp_split=dp)
        return combined.reshape(b, s, d), aux
    return _combine(out_buf, flat_e, slot, keep, w, top_k).reshape(
        b, s, d), aux
