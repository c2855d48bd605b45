"""Deterministic synthetic LM data: the counterpart of the JAX package's
``data/tokens.py``.

A batch is a pure function of (seed, step), so resuming needs no iterator
state.  The token stream is a Zipf-weighted order-1 Markov chain over the
vocab: ``base`` ids are drawn from the Zipf law, then
:func:`markov_tokens` mixes neighbours as the reference does.  The port
cannot regenerate ``jax.random.categorical``, so ``base`` comes from a
CPU ``torch.Generator`` seeded from ``(seed, step)`` (:func:`step_seed`)
and the batch is then moved to its device: ``torch.multinomial`` on the
card drew other tokens from the same seed in another process, which
would make a resumed run read other batches.  The law and the mixing are
the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1
    markov_jump: int = 7        # deterministic mixing stride


def _zipf_logits(vocab: int, alpha: float, device=None) -> torch.Tensor:
    r = torch.arange(1, vocab + 1, dtype=torch.float32, device=device)
    return -alpha * torch.log(r)


def step_seed(seed: int, step: int, stream: int = 0) -> int:
    """A 63-bit generator seed for (seed, step, stream)."""
    ss = np.random.SeedSequence([seed, step, stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def markov_tokens(base: torch.Tensor, vocab: int, jump: int):
    """(tokens, labels) of (B, S-1) from (B, S+1) Zipf ids ``base``:
    ``rolled = (base[:, :-1] * jump + base[:, 1:]) % vocab`` (B, S),
    tokens all its columns but the last and labels all but the first."""
    rolled = (base[:, :-1] * jump + base[:, 1:]) % vocab
    return rolled[:, :-1], rolled[:, 1:]


def batch_at(cfg: DataConfig, step: int, *, frontend: str = "none",
             d_model: int = 0, device=None) -> dict:
    """Batch for a given step on ``device`` (None: the card): int64
    ``labels`` (B, S-1), and int64 ``tokens`` (B, S-1) or, for a modality
    stub, f32 ``embeds`` (B, S-1, d_model) of N(0, 0.02^2); S-1 as in the
    reference, whose shift leaves ``seq_len - 1`` positions."""
    dev = resolve_device(device)
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab
    g = torch.Generator().manual_seed(step_seed(cfg.seed, step))
    probs = torch.softmax(_zipf_logits(v, cfg.zipf_alpha), dim=0)
    base = torch.multinomial(probs, b * (s + 1), replacement=True,
                             generator=g).reshape(b, s + 1)
    tokens, labels = markov_tokens(base, v, cfg.markov_jump)
    out = {"labels": labels.to(dev)}
    if frontend == "none":
        out["tokens"] = tokens.to(dev)
    else:
        ge = torch.Generator().manual_seed(step_seed(cfg.seed, step, 1))
        out["embeds"] = (torch.randn((b, s - 1, d_model), generator=ge)
                         * 0.02).to(dev)
    return out
