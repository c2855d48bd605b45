"""Training traffic: the program's ``make_train_step`` (forward, the
whole-vocabulary cross-entropy, the autograd backward, in-place AdamW) on
packed sequences, a few batches made on the device from the seed and
cycled, labels the tokens shifted by one.

Set-up builds one step with its weights and optimizer state and drives it
through its first three steps, on three batches whose rows all differ,
through the same call and feed as the window, which then goes on with the
same objects.  From those steps it keeps the program's readings:

- each step's loss;
- each leaf's first gradient as the optimizer got it (clipped), worked out
  from the first moment after step 1 (m / (1 - b1)): its norm, and its
  values at indices drawn from the seed;
- each leaf's change after three steps (the f32 master weights less the
  initial weights): its norm and its values at the same indices.

The check, once the window has closed, has the reference follow the same
three steps in float32 and compares, over the leaves whose reference
gradient is at least a thousandth of the median leaf's:

- ``loss_gap``: the largest gap between a step's losses;
- ``grad_norm_gap`` / ``change_norm_gap``: the worst leaf's gap between
  the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``grad_err`` / ``change_err``: the worst leaf's relative distance at
  the sampled indices (RMS of the difference over the larger of the
  reference's RMS of that leaf and of the median leaf).
"""
from __future__ import annotations

import statistics
import time

import torch

from .. import weights
from ..harness import port_config
from ..reference import common
from ..yardstick import derive, family

SAMPLE = 1 << 16          # sampled values a leaf
STEPS = 3                 # the steps the reference follows


class Entry:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg = cell.config
        t = cell.traffic
        self.rows, self.seq, self.n_batches = t["rows"], t["seq_len"], \
            t["batches"]
        self.opt_cfg = dict(t["opt"])
        self.parts = {}

    # -- the program ------------------------------------------------------
    def make_step(self):
        from repro_torch.training.optimizer import OptConfig
        from repro_torch.training.train_loop import (TrainConfig,
                                                     make_train_step)
        return make_train_step(self.pc,
                               TrainConfig(opt=OptConfig(**self.opt_cfg)))

    def batches(self) -> list:
        g = torch.Generator(device=self.device).manual_seed(
            derive(self.seed, "batches"))
        t = torch.randint(0, self.cfg["vocab_size"],
                          (self.n_batches, self.rows, self.seq + 1),
                          generator=g, device=self.device)
        return [{"tokens": b[:, :-1], "labels": b[:, 1:]} for b in t]

    def sample_index(self, i: int, n: int) -> torch.Tensor:
        g = torch.Generator(device=self.device).manual_seed(
            derive(self.seed, "sample", i))
        return torch.randint(0, n, (min(n, SAMPLE),), generator=g,
                             device=self.device)

    def setup(self) -> None:
        t = time.perf_counter()
        from repro_torch.training import train_loop  # noqa: F401
        from repro_torch.training.optimizer import init_opt, tree_leaves
        self.parts["import_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.pc = port_config(self.cfg)
        self.params = weights.make(self.cfg, self.seed, self.device)
        self.opt = init_opt(self.params)
        self.step = self.make_step()
        self.feed = self.batches()
        self.parts["weights_s"] = time.perf_counter() - t
        t = time.perf_counter()
        losses = []
        for n in range(STEPS):
            self.params, self.opt, m = self.step(self.params, self.opt,
                                                 self.feed[n])
            losses.append(float(m["loss"]))
            if n == 0:
                b1 = self.opt_cfg["b1"]
                grad = self.readings(x / (1 - b1)
                                     for x in tree_leaves(self.opt.m))
        self.got = {"loss": losses, "grad": grad,
                    "change": self.readings(self.changes(
                        tree_leaves(self.opt.master)))}
        self.steps_done = STEPS
        self.parts["warm_s"] = time.perf_counter() - t

    def changes(self, master: list):
        """Each leaf's change from the initial weights, made again a block
        at a time from the seed."""
        init = weights.initial_leaves(self.cfg, self.seed, self.device)
        for cur, p0 in zip(master, init, strict=True):
            yield cur.float() - p0.float()

    def readings(self, leaves) -> dict:
        """Norms and sampled values of each leaf, on the host."""
        norms, samples = [], []
        for i, x in enumerate(leaves):
            flat = x.reshape(-1).float()
            norms.append(float(torch.linalg.vector_norm(flat)))
            samples.append(flat[self.sample_index(i, flat.numel())].cpu())
        return {"norm": norms, "sample": samples}

    def window(self, seconds: float, span) -> dict:
        losses, pending = [], None
        t0 = time.perf_counter()
        while True:
            with span("bench.train_step"):
                self.params, self.opt, m = self.step(
                    self.params, self.opt,
                    self.feed[self.steps_done % self.n_batches])
            self.steps_done += 1
            losses.append(m["loss"])
            ev = torch.cuda.Event() if self.device.type == "cuda" else None
            if ev is not None:
                ev.record()
            if pending is not None:          # one step queued ahead
                with span("bench.wait_step"):
                    pending.synchronize()
            pending = ev
            if time.perf_counter() - t0 >= seconds:
                break
        with span("bench.wait_step"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - t0
        n = len(losses)
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return {"attempted": n, "failed": failed,
                "metrics": {"train_tok_s": n * self.rows * self.seq
                            / window_s},
                "work": {"train_steps": n, "rows": self.rows,
                         "seq_len": self.seq}}

    def release(self) -> None:
        del self.params, self.opt, self.step, self.feed

    # -- the check --------------------------------------------------------
    def outputs(self) -> dict:
        return self.got

    def check(self) -> dict:
        return compare(self.outputs(), reference_readings(self, None))


def reference_readings(entry, quant) -> dict:
    """The reference's (``quant`` None) or the control's (``"fp8"``)
    readings of the same three steps from the same weights and batches."""
    cfg, dev, seed = entry.cfg, entry.device, entry.seed
    ref = family(cfg).Model(cfg, quant=quant)
    params = weights.tree_map(lambda w: w.float().requires_grad_(),
                              weights.make(cfg, seed, dev))
    paths = weights.leaf_paths(params)
    leaves = [w for _, w in paths]
    decay = [common.decays(p, w) for p, w in paths]
    m = [torch.zeros_like(x) for x in leaves]
    v = [torch.zeros_like(x) for x in leaves]
    feed = entry.batches()
    losses = []
    with common.precise():
        for n in range(STEPS):
            total = 0.0
            for r in range(entry.rows):
                loss = ref.loss(params, feed[n]["tokens"][r],
                                feed[n]["labels"][r]) / entry.rows
                loss.backward()
                total += float(loss.detach())
            losses.append(total)
            grads = [x.grad for x in leaves]
            clipped = common.adamw([x.data for x in leaves], grads, m, v,
                                   decay, entry.opt_cfg, n + 1)
            if n == 0:
                grad = entry.readings(clipped)
            del clipped, grads
            for x in leaves:
                x.grad = None
    del m, v
    change = entry.readings(entry.changes([x.detach() for x in leaves]))
    return {"loss": losses, "grad": grad, "change": change}


def _leaf_gaps(got: dict, want: dict, counted: list) -> tuple[float, float]:
    """(worst norm gap, worst sampled relative distance) over the counted
    leaves."""
    med_norm = statistics.median(want["norm"][i] for i in counted)
    rms = [float(torch.sqrt(torch.mean(s * s))) for s in want["sample"]]
    med_rms = statistics.median(rms[i] for i in counted)
    gap = max(abs(got["norm"][i] - want["norm"][i])
              / max(want["norm"][i], med_norm) for i in counted)
    err = max(float(torch.sqrt(torch.mean(
        (got["sample"][i] - want["sample"][i]) ** 2)))
        / max(rms[i], med_rms) for i in counted)
    return gap, err


def compare(got: dict, want: dict) -> dict:
    """The compared numbers of the program's (or the control's) readings
    against the reference's.  Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone and are left
    out."""
    med = statistics.median(want["grad"]["norm"])
    counted = [i for i, n in enumerate(want["grad"]["norm"])
               if n >= 1e-3 * med]
    g_gap, g_err = _leaf_gaps(got["grad"], want["grad"], counted)
    c_gap, c_err = _leaf_gaps(got["change"], want["change"], counted)
    return {"loss_gap": max(abs(a - b) for a, b in zip(got["loss"],
                                                       want["loss"])),
            "grad_norm_gap": g_gap, "grad_err": g_err,
            "change_norm_gap": c_gap, "change_err": c_err}
