"""Serve step factories: the counterpart of ``make_serve_steps`` in the JAX
package's ``training/train_loop.py``.  ``make_train_step`` (gradients,
AdamW, compressed reduction) is not ported yet: ROADMAP queue 1, item 11.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import transformer as tf


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
