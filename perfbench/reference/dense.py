"""The dense family: pre-norm blocks of grouped-query attention with
rotary positions (causal, optionally a sliding window) and a SwiGLU or
tanh-GELU MLP, RMS norms, an untied head.

A family's module holds all that the benchmark knows of the family; the
harness finds it by a configuration file's ``reference`` key, so a new
family is a new module beside this one:

- ``geometry(cfg)``: the sizes the counts of ``yardstick`` read, with
  ``matrix_params``, the matrix parameters of a block that act on each
  token, and ``head_params``;
- ``outer_leaves(cfg)`` and ``layer_leaves(cfg)``: the weight tree in the
  order of the program's, each leaf's path, shape, scale (None: ones) and
  type (None: the served one); ``LAYERS`` marks where the blocks go;
- ``port_fields(cfg)``: the program's model fields that the file implies,
  which the harness holds against the program's own configuration;
- ``Model(cfg, quant)``: the equations, ``prefill`` and ``loss``.

Plain PyTorch in float32 with TF32 off, computed block by block and, for
attention, in query blocks against the keys a block can see, so that a
33 B model's 16k prefill fits beside its weights.  It imports nothing of
the program.  It follows the program's equations where a configuration's
``departures`` records a difference from the published model (RMS norms
with eps 1e-5, no biases, no RoPE scaling).
"""
from __future__ import annotations

import torch

from .common import (attention, cross_entropy, mm, precise, qz, rms_norm,
                     rope)

LAYERS = "layers"
# the file's MLP against the program's ``mlp_act``
PORT_ACT = {"swiglu": "swiglu", "gelu_tanh": "gelu"}
GATED = ("swiglu",)


def heads(cfg: dict) -> tuple[int, int, int]:
    """(query heads, key-value heads, head size)."""
    h = cfg["num_attention_heads"]
    return (h, cfg["num_key_value_heads"],
            cfg.get("head_dim") or cfg["hidden_size"] // h)


def attn_params(cfg: dict) -> int:
    d = cfg["hidden_size"]
    h, kv, dh = heads(cfg)
    return 2 * d * h * dh + 2 * d * kv * dh


def geometry(cfg: dict) -> dict:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    h, kv, dh = heads(cfg)
    mlp = d * f * (3 if cfg["as_run"]["mlp"] in GATED else 2)
    return dict(d=d, h=h, kv=kv, dh=dh, layers=cfg["num_hidden_layers"],
                vocab=cfg["vocab_size"],
                window=cfg.get("sliding_window") or 0,
                matrix_params=attn_params(cfg) + mlp,
                head_params=d * cfg["vocab_size"])


def outer_leaves(cfg: dict) -> list:
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    return [("embed", (v, d), 0.02, None), (LAYERS, None, None, None),
            ("final_norm", (d,), None, None),
            ("lm_head", (d, v), d ** -0.5, None)]


def attn_leaves(cfg: dict) -> list:
    d = cfg["hidden_size"]
    h, kv, dh = heads(cfg)
    return [("ln1", (d,), None, None),
            ("attn.wq", (d, h * dh), d ** -0.5, None),
            ("attn.wk", (d, kv * dh), d ** -0.5, None),
            ("attn.wv", (d, kv * dh), d ** -0.5, None),
            ("attn.wo", (h * dh, d), (h * dh) ** -0.5, None),
            ("ln2", (d,), None, None)]


def layer_leaves(cfg: dict) -> list:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    out = attn_leaves(cfg) + [("mlp.w_up", (d, f), d ** -0.5, None),
                              ("mlp.w_down", (f, d), f ** -0.5, None)]
    if cfg["as_run"]["mlp"] in GATED:
        out.append(("mlp.w_gate", (d, f), d ** -0.5, None))
    return out


def port_fields(cfg: dict) -> dict:
    run = cfg["as_run"]
    h, kv, dh = heads(cfg)
    return dict(family="dense", d_model=cfg["hidden_size"],
                d_ff=cfg["intermediate_size"], n_heads=h, n_kv_heads=kv,
                d_head=dh, n_layers=cfg["num_hidden_layers"],
                vocab=cfg["vocab_size"],
                sliding_window=cfg.get("sliding_window") or 0,
                rope_theta=float(cfg["rope_theta"]),
                mlp_act=PORT_ACT[run["mlp"]], dtype=run["dtype"],
                tie_embeddings=False, meta_tokens=0, logit_softcap=0.0,
                use_kernel=True)


def mlp(h, p, act, quant=None):
    if act == "swiglu":
        z = torch.nn.functional.silu(mm(h, p["w_gate"], quant)) \
            * mm(h, p["w_up"], quant)
    elif act == "gelu_tanh":
        z = torch.nn.functional.gelu(mm(h, p["w_up"], quant),
                                     approximate="tanh")
    else:
        raise ValueError(f"the dense reference has no MLP {act!r}")
    return mm(z, p["w_down"], quant)


class Model:
    """The equations of one configuration file."""

    def __init__(self, cfg: dict, quant: str | None = None):
        run = cfg["as_run"]
        if run["norm"] != "rms_norm" or run["bias"] or run["rope_scaling"]:
            raise ValueError(f"the {cfg['reference']} reference does not "
                             f"run {run}")
        self.h, self.kv, self.dh = heads(cfg)
        self.window = cfg.get("sliding_window") or 0
        self.theta = float(cfg["rope_theta"])
        self.eps = float(run["norm_eps"])
        self.act = run["mlp"]
        self.quant = quant

    def attend(self, p, x, pos, on_kv=None, layer=0):
        """``x`` plus its attention; ``on_kv(layer, k, v)`` sees the
        rotated keys and the values as the product's operands."""
        s = x.shape[0]
        hx = rms_norm(x, p["ln1"], self.eps)
        a = p["attn"]
        q = rope(mm(hx, a["wq"], self.quant).reshape(s, self.h, self.dh),
                 pos, self.theta)
        k = rope(mm(hx, a["wk"], self.quant).reshape(s, self.kv, self.dh),
                 pos, self.theta)
        v = mm(hx, a["wv"], self.quant).reshape(s, self.kv, self.dh)
        del hx
        if on_kv is not None:
            on_kv(layer, qz(k, self.quant), qz(v, self.quant))
        o = attention(q, k, v, self.window, self.quant)
        del q, k, v
        return x + mm(o.reshape(s, self.h * self.dh), a["wo"], self.quant)

    def feed_forward(self, p, x, rows: int = 4096):
        """``x`` plus its MLP, in blocks of ``rows`` positions."""
        out = []
        for r0 in range(0, x.shape[0], rows):
            xr = x[r0:r0 + rows]
            out.append(xr + mlp(rms_norm(xr, p["ln2"], self.eps), p["mlp"],
                                self.act, self.quant))
        return torch.cat(out)

    def block(self, p, x, pos, on_kv=None, layer=0):
        """One block over ``x (S, d)``."""
        return self.feed_forward(p, self.attend(p, x, pos, on_kv, layer))

    @torch.no_grad()
    def prefill(self, outer: dict, layer_fn, n_layers: int, tokens,
                on_kv=None) -> torch.Tensor:
        """The last position's float32 logits of a prefill of ``tokens
        (S,)``; ``layer_fn(l)`` gives block l's float32 weights, made when
        asked so that one block at a time is held in float32."""
        with precise():
            x = outer["embed"][tokens].float()
            pos = torch.arange(tokens.shape[0], device=x.device)
            for li in range(n_layers):
                x = self.block(layer_fn(li), x, pos, on_kv=on_kv, layer=li)
            last = rms_norm(x[-1:], outer["final_norm"], self.eps)
            return mm(last, outer["lm_head"], self.quant)[0]

    def loss(self, params: dict, tokens, labels) -> torch.Tensor:
        """Mean cross-entropy of one row: ``tokens, labels (S,)``."""
        x = params["embed"][tokens]
        pos = torch.arange(tokens.shape[0], device=x.device)
        for p in params["layers"]:
            x = self.block(p, x, pos)
        x = rms_norm(x, params["final_norm"], self.eps)
        return cross_entropy(mm(x, params["lm_head"], self.quant), labels)
