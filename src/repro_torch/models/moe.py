"""Top-k mixture of experts with capacity dispatch.

The counterpart of the JAX package's ``models/moe.py``.  On one card there
is one data-parallel group (the JAX module's ``dp_group_count()`` is 1
without a mesh), so the tokens of the whole batch share one capacity, and
its sharding hints (``constrain``) have no counterpart.  Expert weights
stay stacked ``(E, d, f)`` and each expert's FFN is one batched product
over its buffer of ``cap`` token slots, as the JAX module's einsums are.

What follows the reference term for term, because a usual PyTorch MoE
would drop or route other tokens:

- ``cap = int(max(top_k * T * capacity_factor / E, 4))`` in Python floats;
- the router runs in f32 (``x`` cast to f32, an f32 router), then a
  softmax, and the top ``k`` experts come from a stable descending sort,
  so a tie (a token of zeros has equal probabilities) takes the lower
  index first, as ``lax.top_k`` does;
- the gates are renormalised over the chosen ``k``;
- a choice's slot in its expert's buffer is the count of earlier choices
  of that expert in the flattened token-major ``(token, choice)`` order;
  a choice whose slot reaches ``cap`` is dropped: it adds a zero payload
  at slot ``cap - 1`` and takes nothing back (it rides the residual);
- the load-balance loss is ``E * sum(mean probs * choice shares) * k``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
    """buf (E, C, d) -> (E, C, d) through each expert's own FFN."""
    if act in ("swiglu", "geglu"):
        gate = torch.bmm(buf, experts["w_gate"])
        up = torch.bmm(buf, experts["w_up"])
        gate = F.silu(gate) if act == "swiglu" else _gelu(gate)
        h = gate * up
    elif act == "gelu":
        h = _gelu(torch.bmm(buf, experts["w_up"]))
    elif act == "relu2":
        h = torch.square(F.relu(torch.bmm(buf, experts["w_up"])))
    else:
        raise ValueError(f"unknown mlp act {act!r}")
    return torch.bmm(h, experts["w_down"])


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
    """Slots of the flattened token-major choices ``gate_idx`` (T, k):
    (expert ids (T*k,), slot (T*k,), keep (T*k,) bool)."""
    flat_e = gate_idx.reshape(-1)
    oh = F.one_hot(flat_e, n_experts)
    pos_in_e = torch.cumsum(oh, dim=0) - oh
    flat_pos = torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0]
    keep = flat_pos < cap
    return flat_e, torch.where(keep, flat_pos, cap - 1), keep


def moe_apply(p: dict, x: torch.Tensor, *, top_k: int, act: str,
              capacity_factor: float = 1.25):
    """x: (B, S, d) -> (out (B, S, d), aux load-balance loss, f32)."""
    b, s, d = x.shape
    e = p["experts"]["w_up"].shape[0]
    t = b * s
    cap = capacity(top_k, t, capacity_factor, e)
    xt = x.reshape(t, d)
    probs, gate_vals, gate_idx = route(p["router"], xt, top_k)

    # Switch-style load-balance aux loss (no op here waits for the card)
    me = probs.mean(dim=0)
    ce = F.one_hot(gate_idx.reshape(-1), e).sum(0).float() / (t * top_k)
    aux = e * torch.sum(me * ce) * top_k

    flat_e, slot, keep = dispatch(gate_idx, e, cap)
    tok_src = torch.arange(t, device=x.device)[:, None].expand(
        t, top_k).reshape(-1)
    payload = torch.where(keep[:, None], xt[tok_src],
                          torch.zeros((), dtype=x.dtype, device=x.device))
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((flat_e, slot), payload, accumulate=True)

    out_buf = _expert_ffn(p["experts"], buf, act)

    picked = out_buf[flat_e, slot]
    picked = torch.where(keep[:, None], picked,
                         torch.zeros((), dtype=x.dtype, device=x.device))
    w = gate_vals.reshape(t * top_k, 1).to(x.dtype)
    contrib = (picked * w).reshape(t, top_k, d)
    # the choices of a token summed in order, as the reference's
    # scatter-add does
    combined = contrib[:, 0]
    for j in range(1, top_k):
        combined = combined + contrib[:, j]
    return combined.reshape(b, s, d), aux
