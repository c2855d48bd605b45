"""Train and serve step factories: the counterpart of the JAX package's
``training/train_loop.py``.

``make_train_step`` builds the update: the loss and its gradients by
autograd (attention and GLA run their kernels forward and their plain
versions' gradients, :mod:`repro_torch.models.attention`,
:mod:`repro_torch.models.ssm`), microbatched gradient accumulation,
optionally the compressed cross-pod reduction, then AdamW.
``make_serve_steps`` builds prefill and decode.  Both are functions of
(params / opt / cache, batch); the preemption-safe outer loop lives in
:mod:`repro_torch.training.trainer`.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from ..models import transformer as tf
from .compression import compress_pod_reduce
from .optimizer import (OptConfig, OptState, apply_updates, tree_leaves,
                        tree_map)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    aux_coef: float = 0.01
    opt: OptConfig = OptConfig()
    compress_grads: bool = False   # int8 cross-pod DP reduction


def value_and_grad(params, cfg: ModelConfig, batch: dict,
                   aux_coef: float = 0.01):
    """((loss, {"ce", "aux"}), grads): ``tf.loss_fn`` and its gradient
    with respect to every parameter leaf, in the leaf's dtype (zeros for a
    leaf the loss does not use, as ``jax.grad`` gives)."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    it = iter(live)
    loss, metrics = tf.loss_fn(tree_map(lambda _: next(it), params), cfg,
                               batch, aux_coef=aux_coef)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    it = iter(grads)
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_map(lambda _: next(it), params))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)`` with the metrics ``loss``, ``ce``, ``aux``,
    ``grad_norm`` and ``lr`` (f32 scalars on the device).

    ``batch`` leaves have the global batch as their leading dim.  With one
    microbatch the gradients keep the parameters' dtype; with ``nm > 1``
    they are summed in f32 over ``nm`` sequential slices and divided by
    ``nm``, the loss too, and (as in the reference) ``ce`` reports that
    mean loss and ``aux`` 0.  The parameters and the optimizer state are
    updated in place (:func:`repro_torch.training.optimizer.apply_updates`).
    """
    def train_step(params, opt_state: OptState, batch: dict):
        nm = tcfg.microbatches
        if nm == 1:
            (loss, metrics), grads = value_and_grad(params, cfg, batch,
                                                    tcfg.aux_coef)
        else:
            size = next(iter(batch.values())).shape[0] // nm
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(nm):
                mb = {k: v[i * size:(i + 1) * size]
                      for k, v in batch.items()}
                (l_mb, _), g = value_and_grad(params, cfg, mb,
                                              tcfg.aux_coef)
                for a, b in zip(tree_leaves(grads), tree_leaves(g)):
                    a.add_(b)
                del g
                loss = loss + l_mb
            for a in tree_leaves(grads):
                a.div_(nm)
            loss = loss / nm
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        if tcfg.compress_grads:
            grads = compress_pod_reduce(grads)
        params, opt_state, om = apply_updates(params, grads, opt_state,
                                              tcfg.opt)
        return params, opt_state, dict(metrics, loss=loss, **om)

    return train_step


def make_serve_steps(cfg: ModelConfig):
    """Returns (prefill_step, decode_step).

    prefill_step(params, cache, batch)        -> (last_logits, cache)
    decode_step(params, cache, tokens, pos0)  -> (logits, cache)

    Both run without autograd; the cache is updated in place.
    """

    @torch.no_grad()
    def prefill_step(params, cache, batch: dict):
        logits, cache, _ = tf.forward(
            params, cfg, tokens=batch.get("tokens"),
            embeds=batch.get("embeds"), cache=cache, mode="prefill")
        return logits, cache

    @torch.no_grad()
    def decode_step(params, cache, tokens=None, embeds=None, pos0=0):
        logits, cache, _ = tf.forward(
            params, cfg, tokens=tokens, embeds=embeds, cache=cache,
            pos0=pos0, mode="decode")
        return logits, cache

    return prefill_step, decode_step
