"""A family module for ``reference/``, kept here for the discovery test,
which copies it into a copy of the benchmark as ``reference/moe.py``: the
mixture-of-experts family added as a new file, with no edit to a file
that is there.

Blocks of the dense family's attention and, in place of its MLP, top-k
experts: a float32 router, a softmax, the top k by a stable descending
sort (ties to the lower expert), the gates renormalised over the k; each
expert takes its choices in token-major order up to ``int(max(k x tokens
x capacity_factor / experts, 4))`` slots and drops the rest, which add
nothing (the program's ``models/moe.py``).  The load-balance loss is not
followed: the family's cells here only prefill.
"""
from __future__ import annotations

import torch

from . import dense
from .common import mm, rms_norm

LAYERS = dense.LAYERS
outer_leaves = dense.outer_leaves


def experts(cfg: dict) -> tuple[int, int]:
    """(experts, experts a token)."""
    return cfg["num_local_experts"], cfg["num_experts_per_tok"]


def geometry(cfg: dict) -> dict:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    e, k = experts(cfg)
    expert = d * f * (3 if cfg["as_run"]["mlp"] in dense.GATED else 2)
    return dict(dense.geometry(cfg),
                matrix_params=dense.attn_params(cfg) + k * expert + d * e)


def layer_leaves(cfg: dict) -> list:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    e, _ = experts(cfg)
    out = dense.attn_leaves(cfg) + [
        ("moe.router", (d, e), d ** -0.5, "float32"),
        ("moe.experts.w_up", (e, d, f), d ** -0.5, None),
        ("moe.experts.w_down", (e, f, d), f ** -0.5, None)]
    if cfg["as_run"]["mlp"] in dense.GATED:
        out.append(("moe.experts.w_gate", (e, d, f), d ** -0.5, None))
    return out


def port_fields(cfg: dict) -> dict:
    e, k = experts(cfg)
    return dict(dense.port_fields(cfg), family="moe", n_experts=e, top_k=k,
                capacity_factor=float(cfg["as_run"]["capacity_factor"]))


class Model(dense.Model):
    def __init__(self, cfg: dict, quant: str | None = None):
        super().__init__(cfg, quant)
        self.e, self.k = experts(cfg)
        self.cf = float(cfg["as_run"]["capacity_factor"])

    def feed_forward(self, p, x, rows=None):
        """``x`` plus its experts' outputs, routed over the whole
        sequence (the capacity counts every token)."""
        t = x.shape[0]
        h = rms_norm(x, p["ln2"], self.eps)
        m = p["moe"]
        probs = torch.softmax(mm(h.float(), m["router"], self.quant), -1)
        gate, idx = torch.sort(probs, dim=-1, descending=True,
                               stable=True)
        gate, idx = gate[:, :self.k], idx[:, :self.k]
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
        cap = int(max(self.k * t * self.cf / self.e, 4))
        flat = idx.reshape(-1)
        seen = torch.nn.functional.one_hot(flat, self.e)
        slot = (torch.cumsum(seen, 0) - seen).gather(1, flat[:, None])[:, 0]
        keep = slot < cap
        token = torch.arange(t, device=x.device).repeat_interleave(self.k)
        weight = gate.reshape(-1)
        out = torch.zeros_like(x)
        for ex in range(self.e):
            sel = (flat == ex) & keep
            if not bool(sel.any()):
                continue
            w = {n: m["experts"][n][ex] for n in m["experts"]}
            y = dense.mlp(h[token[sel]], w, self.act, self.quant)
            out.index_add_(0, token[sel], y * weight[sel, None])
        return x + out
