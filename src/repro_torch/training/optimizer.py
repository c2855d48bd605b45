"""AdamW with f32 master weights, global-norm clipping and a cosine
schedule: the counterpart of the JAX package's ``training/optimizer.py``.

The optimizer state is a tree shaped like the parameters (dicts, and the
port's list of per-layer dicts).  Every quantity of the update is an f32
tensor on the parameters' device, the bias corrections ``b1 ** step``
included, as the reference computes them.

Weight decay follows the reference's rule, decided on the rank a leaf has
in the JAX model's tree: JAX stacks the per-layer leaves ``[L, ...]``, so
it decays every leaf under ``layers`` that has one axis or more here (the
norms ``ln1``/``ln2`` included) and no 0-d one (``b_attn``/``b_mamba``),
and, outside ``layers``, the leaves of two axes or more (not
``final_norm``).  :func:`init_opt` records the rule per leaf.

:func:`apply_updates` updates the state's tensors in place (the JAX
trainer donates them) and returns them with the new parameters, which are
the master weights cast to each parameter's dtype and written into the
parameter tensors in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    master: Any      # f32 params
    m: Any           # f32 first moment
    v: Any           # f32 second moment
    step: torch.Tensor  # int32 scalar


def tree_map(f, *trees):
    """``f`` over the tensor leaves of trees of one structure (dicts and
    lists)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(f, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(f, *xs) for xs in zip(*trees))
    return f(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def decays(params: dict) -> dict:
    """The weight-decay rule as a tree of bools (see the module doc): a
    leaf decays when it has more than one axis in the JAX tree."""
    if not isinstance(params, dict):
        return tree_map(lambda x: x.dim() > 1, params)
    out = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = tree_map(lambda x: x.dim() + 1 > 1, v)
        else:
            out[k] = tree_map(lambda x: x.dim() > 1, v)
    return out


def init_opt(params: Any) -> OptState:
    """f32 master copy, zero moments, step 0, on the parameters' device."""
    leaf = tree_leaves(params)[0]
    return OptState(
        master=tree_map(lambda p: p.detach().float().clone(), params),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        step=torch.zeros((), dtype=torch.int32, device=leaf.device))


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up then cosine decay to ``min_lr_frac``, in f32."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the f32 sum of squares of every leaf."""
    total = None
    for g in tree_leaves(tree):
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params: Any, grads: Any, opt: OptState,
                  cfg: OptConfig) -> tuple[Any, OptState, dict]:
    """One AdamW step; returns (params, new state, {grad_norm, lr}).  The
    state's tensors and the parameters are updated in place."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = opt.step + 1
    lr = schedule(cfg, step)
    sf = step.float()
    b1t = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=sf.device), sf)
    b2t = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=sf.device), sf)

    def upd(g, m, v, master, p, decay):
        g = g.float() * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_((g * (1 - cfg.b2)).mul_(g))
        u = (m / b1t) / (torch.sqrt(v / b2t) + cfg.eps)
        if decay and cfg.weight_decay:
            u.add_(master * cfg.weight_decay)
        master.sub_(u.mul_(lr))
        p.copy_(master)

    for args in zip(tree_leaves(grads), tree_leaves(opt.m),
                    tree_leaves(opt.v), tree_leaves(opt.master),
                    tree_leaves(params), tree_leaves(decays(params))):
        upd(*args)
    return params, OptState(opt.master, opt.m, opt.v, step), {
        "grad_norm": gnorm, "lr": lr}
