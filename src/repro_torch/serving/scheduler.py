"""Continuous-batching scheduler for the real-model serving path.

The counterpart of the JAX package's ``serving/scheduler.py``, with the
same behaviour: a request is prefilled when a slot frees up, then every
active request takes one decode call per tick (one call per slot, not a
batched decode), and each new token is the host ``argmax`` of the last
logits.  The scheduler only calls the (prefill_step, decode_step,
init_cache) closures it is given, e.g. those of
:func:`repro_torch.training.train_loop.make_serve_steps`; token ids are
placed on ``device`` (None: the card).

``pos_offset`` counts the positions a model puts before every prompt (a
hybrid model's meta tokens, ``cfg.meta_tokens``): a request's cache then
holds ``pos_offset + prompt + max_new + 1`` positions and its first decode
runs at ``pos0 = pos_offset + prompt``, as ``forward`` counts them.  At 0,
the default, the batcher is the JAX package's, which has no offset.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable

import numpy as np
import torch

from .._device import resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray            # prompt token ids
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class SchedulerConfig:
    max_batch: int = 8
    max_queue: int = 1024


class ContinuousBatcher:
    """Drives (prefill_step, decode_step) over a dynamic request set."""

    def __init__(self, scfg: SchedulerConfig, *, prefill_step: Callable,
                 decode_step: Callable, init_cache: Callable,
                 eos_id: int = -1, device=None, pos_offset: int = 0):
        self.cfg = scfg
        self.prefill_step = prefill_step
        self.decode_step = decode_step
        self.init_cache = init_cache
        self.eos_id = eos_id
        self.device = resolve_device(device)
        self.pos_offset = pos_offset
        self.waiting: deque[Request] = deque()
        self.active: list[dict] = []     # {req, cache, pos}

    def submit(self, req: Request) -> None:
        if len(self.waiting) >= self.cfg.max_queue:
            raise RuntimeError("queue full")
        self.waiting.append(req)

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def _start_one(self) -> None:
        req = self.waiting.popleft()
        toks = self._ids(req.tokens[None, :])
        pos = self.pos_offset + toks.shape[1]
        cache = self.init_cache(1, pos + req.max_new + 1)
        logits, cache = self.prefill_step(cache, {"tokens": toks})
        nxt = int(torch.argmax(logits[0, -1]))
        req.out.append(nxt)
        self.active.append({"req": req, "cache": cache, "pos": pos})

    def step(self) -> int:
        """One scheduler tick; returns number of completed requests."""
        while self.waiting and len(self.active) < self.cfg.max_batch:
            self._start_one()
        finished = 0
        still = []
        for slot in self.active:
            req = slot["req"]
            tok = self._ids([[req.out[-1]]])
            logits, slot["cache"] = self.decode_step(
                slot["cache"], tok, slot["pos"])
            slot["pos"] += 1
            nxt = int(torch.argmax(logits[0, -1]))
            req.out.append(nxt)
            if len(req.out) >= req.max_new or nxt == self.eos_id:
                req.done = True
                finished += 1
            else:
                still.append(slot)
        self.active = still
        return finished

    def drain(self, max_ticks: int = 10_000) -> int:
        done = 0
        ticks = 0
        while (self.waiting or self.active) and ticks < max_ticks:
            done += self.step()
            ticks += 1
        return done
