"""Prefill traffic: a closed loop of one request at a time through the
program's ``prefill_step`` (``training/train_loop.make_serve_steps``),
each prompt written into one cache that set-up makes at the traffic's
capacity, each request ending when the host has read the first token's
argmax from the last logits.

The prompt lengths (:func:`mix`) are the traffic file's ``levels``, each
a range of lengths from which ``per_level`` lengths are drawn uniformly
with the file's own ``mix_seed``, so that every run serves the same
lengths.  ``--seed`` draws their order (:func:`cycle`) and the token ids.
The window runs whole cycles until ``--seconds`` have passed, so every
run weighs the lengths alike.

The check, once the window has closed: the reference prefills two of the
window's requests, the last and a longest one (or, where the last is a
longest, one of another length drawn from the seed), and compares

- ``logits_err``: the worst relative L2 distance of a sampled request's
  last-position logits from the reference's;
- ``cache_err``: the worst relative L2 distance, over layers and over keys
  and values, of the cache slots the last request wrote from the
  reference's rotated keys and values at those positions;
- ``cache_pos_err``: the slots whose recorded position is not the one the
  last request wrote there (exact).
"""
from __future__ import annotations

import random
import time

import torch

from .. import weights
from ..harness import port_config
from ..yardstick import derive, family


def mix(traffic: dict) -> list:
    """The prompt lengths of one cycle, level by level."""
    spec = traffic["lengths"]
    rng = random.Random(spec["mix_seed"])
    return [rng.randint(lo, hi) for lo, hi in spec["levels"]
            for _ in range(spec["per_level"])]


def cycle(traffic: dict, seed: int) -> list:
    """The cycle a run serves: the mix in an order drawn from ``seed``."""
    lengths = mix(traffic)
    random.Random(derive(seed, "order")).shuffle(lengths)
    return lengths


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||, in float32."""
    want = want.float()
    return float(torch.linalg.vector_norm(got.float() - want)
                 / torch.linalg.vector_norm(want).clamp(min=1e-30))


class Entry:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg = cell.config
        self.cycle = cycle(cell.traffic, seed)
        self.vocab = self.cfg["vocab_size"]
        self.parts = {}

    # -- the program ------------------------------------------------------
    def make_step(self):
        from repro_torch.training.train_loop import make_serve_steps
        return make_serve_steps(self.pc)[0]

    def prompt(self, i: int, s: int, tag: str = "prompt") -> torch.Tensor:
        """Request ``i``'s ``(1, s)`` token ids, uniform over the vocab."""
        self.gen.manual_seed(derive(self.seed, tag, i))
        return torch.randint(0, self.vocab, (1, s), generator=self.gen,
                             device=self.device)

    def setup(self) -> None:
        t = time.perf_counter()
        from repro_torch.models import transformer as tf
        from repro_torch.training import train_loop  # noqa: F401
        self.parts["import_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.pc = port_config(self.cfg)
        self.params = weights.make(self.cfg, self.seed, self.device)
        self.cache = tf.init_cache(self.pc, 1, self.cell.traffic["capacity"],
                                   device=self.device)
        self.step = self.make_step()
        self.gen = torch.Generator(device=self.device)
        self.parts["weights_s"] = time.perf_counter() - t
        t = time.perf_counter()
        for j, s in enumerate(sorted(set(self.cycle))):   # warm each shape
            logits, _ = self.step(self.params, self.cache,
                                  {"tokens": self.prompt(j, s, "warm")})
            int(logits[0, -1].argmax())
        self.parts["warm_s"] = time.perf_counter() - t

    def window(self, seconds: float, span) -> dict:
        self.done = []              # (request, length, last logits)
        t0 = time.perf_counter()
        i = 0
        while True:
            for s in self.cycle:
                tokens = self.prompt(i, s)
                with span("bench.prefill_step"):
                    logits, _ = self.step(self.params, self.cache,
                                          {"tokens": tokens})
                with span("bench.read_token"):
                    int(logits[0, -1].argmax())
                self.done.append((i, s, logits[0, -1]))
                i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        lengths = [s for _, s, _ in self.done]
        last = torch.stack([lg for _, _, lg in self.done])
        failed = int((~torch.isfinite(last).all(dim=-1)).sum())
        return {"attempted": len(self.done), "failed": failed,
                "metrics": {"prefill_tok_s": sum(lengths) / window_s},
                "work": {"prefill_lengths": lengths}}

    def picked(self) -> list:
        """The requests judged: the last, and the last of the longest (or,
        where the last is a longest, one of another length drawn from the
        seed)."""
        last = self.done[-1]
        longest = max(s for _, s, _ in self.done)
        if last[1] != longest:
            return [last, [d for d in self.done if d[1] == longest][-1]]
        others = [d for d in self.done if d[1] != last[1]]
        if not others:
            return [last]
        rng = torch.Generator().manual_seed(derive(self.seed, "sample"))
        return [last, others[int(torch.randint(len(others), (1,),
                                               generator=rng))]]

    def release(self) -> None:
        """Keep what is judged (the picked requests' logits and the slots
        the last request wrote, on the host), free the rest."""
        pick = self.picked()
        self.sample = [(i, s, lg.float().cpu()) for i, s, lg in pick]
        s = pick[0][1]
        ring = self.cache[0]["attn"]["k"].shape[1]
        self.positions = torch.arange(max(0, s - ring), s)
        slots = (self.positions % ring).to(self.device)
        self.out_cache = [
            {k: c["attn"][k][0, slots].cpu() for k in ("k", "v")}
            | {"kpos": c["attn"]["kpos"][slots].cpu()} for c in self.cache]
        del self.params, self.cache, self.step, self.done

    # -- the check --------------------------------------------------------
    def outputs(self):
        """What the check judges: (sampled (request, length, logits), the
        last request's cache slots by layer)."""
        return self.sample, self.out_cache

    def check(self) -> dict:
        return compare(self, *self.outputs())


def reference_pass(entry, quant, requests, kv_positions, on_kv_layer):
    """The reference's last-position logits of each of ``requests``
    ((request, length) pairs); for the first, ``on_kv_layer(l, k, v)`` gets
    its rotated keys and values at ``kv_positions``."""
    cfg, dev, seed = entry.cfg, entry.device, entry.seed
    ref = family(cfg).Model(cfg, quant=quant)
    f32 = {k: v.float() for k, v in
           weights.make_outer(cfg, seed, dev).items()}

    def layer_fn(li):
        return weights.tree_map(torch.Tensor.float,
                                weights.make_layer(cfg, seed, li, dev))
    pos = kv_positions.to(dev)
    out = []
    for n, (i, s) in enumerate(requests):
        tokens = entry.prompt(i, s)[0]
        hook = None
        if n == 0:
            def hook(li, k, v):
                on_kv_layer(li, k[pos], v[pos])
        out.append(ref.prefill(f32, layer_fn, cfg["num_hidden_layers"],
                               tokens, on_kv=hook))
    return out


def compare(entry, sample, out_cache) -> dict:
    """The compared numbers of ``sample`` and ``out_cache`` (the program's
    outputs, or the control's) against the float32 reference."""
    errs = {"cache_err": 0.0}
    dev = entry.device

    def on_kv(li, k, v):
        got = out_cache[li]
        errs["cache_err"] = max(errs["cache_err"],
                                rel_err(got["k"].to(dev), k),
                                rel_err(got["v"].to(dev), v))
    logits = reference_pass(entry, None, [(i, s) for i, s, _ in sample],
                            entry.positions, on_kv)
    errs["logits_err"] = max(rel_err(lg.to(dev), want)
                             for (_, _, lg), want in zip(sample, logits))
    errs["cache_pos_err"] = float(sum(
        int((c["kpos"].long() != entry.positions).sum()) for c in out_cache))
    return errs


def control_outputs(entry, requests) -> tuple:
    """The control in the program's place: the reference with every
    product's operands in float8 e4m3, over the same requests, its keys and
    values at the last request's positions kept on the host."""
    kv = {}

    def keep(li, k, v):
        kv[li] = {"k": k.cpu(), "v": v.cpu(), "kpos": entry.positions}
    logits = reference_pass(entry, "fp8", requests, entry.positions, keep)
    sample = [(i, s, lg.cpu()) for (i, s), lg in zip(requests, logits)]
    return sample, [kv[li] for li in range(len(kv))]
