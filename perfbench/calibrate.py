"""Readings that the limits of a cell's check are set from, on the chip,
in one process: the program's compared numbers over many seeds, the
control's (the reference in float8 e4m3 in the program's place) over a
few, and, for a train cell, those of two faults planted in the program's
step: half of each batch left out, and the loss altered where it is
produced.  Not run by the benchmark's runs.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--half-batch-seeds 7,8,9] \\
        [--altered-seeds 10,11,12] [--witness-seeds 13] --seconds 2 \\
        --out perfbench/results/calibrate.jsonl

``--witness-seeds`` (a train cell) reads, step by step, how far the
program's losses lie from the reference's with the program in its own
type and in float32, and how far the reference's own losses move from its
updates (the reference at a learning rate of 0 against it), beside the
share of the program's weights that its steps moved.

Each reading is one JSON line of ``--out`` (and of standard output).
"""
import argparse
import copy
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _ints(text):
    return [int(x) for x in text.split(",") if x]


def fault(entry_cls, kind: str):
    """The train entry with a fault planted in its step."""
    class Faulty(entry_cls):
        def make_step(self):
            step = super().make_step()
            if kind == "fault_half_batch":
                half = self.rows // 2
                return lambda p, o, b: step(p, o, {k: v[:half]
                                                   for k, v in b.items()})

            def altered(p, o, b):
                p, o, m = step(p, o, b)
                return p, o, dict(m, loss=m["loss"] * 1.01)
            return altered
    return Faulty


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, default=[])
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--half-batch-seeds", type=_ints, default=[])
    p.add_argument("--altered-seeds", type=_ints, default=[])
    p.add_argument("--witness-seeds", type=_ints, default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from perfbench import harness
    cell = harness.load_cell(args.workload, ROOT)
    mod = harness.entry_module(cell)
    dev = torch.device("cuda")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    out = open(args.out, "a")

    def emit(kind, seed, numbers, **extra):
        line = json.dumps({"workload": args.workload, "kind": kind,
                           "seed": seed, "numbers": numbers, **extra})
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    def clean():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    for seed in args.seeds:
        t = time.perf_counter()
        res, checks = harness.run_cell(cell, seed, args.seconds, False)
        emit("program", seed, {k: v["value"] for k, v in checks.items()},
             metrics=res["metrics"], seconds=time.perf_counter() - t)
        clean()
    for seed in args.control_seeds:
        t = time.perf_counter()
        entry = mod.Entry(cell, seed, dev)
        if cell.traffic["entry"] == "prefill":
            entry.setup()
            entry.window(args.seconds, harness._no_span)
            entry.release()
            clean()
            ctl = mod.control_outputs(entry, [(i, s) for i, s, _ in
                                              entry.sample])
            numbers = mod.compare(entry, *ctl)
        else:
            numbers = mod.compare(mod.reference_readings(entry, "fp8"),
                                  mod.reference_readings(entry, None))
        emit("control_fp8", seed, numbers,
             seconds=time.perf_counter() - t)
        del entry
        clean()
    for kind, seeds in (("fault_half_batch", args.half_batch_seeds),
                        ("fault_altered_loss", args.altered_seeds)):
        for seed in seeds:
            res, checks = harness.run_cell(cell, seed, args.seconds, False,
                                           entry_cls=fault(mod.Entry, kind))
            emit(kind, seed, {k: v["value"] for k, v in checks.items()})
            clean()
    for seed in args.witness_seeds:
        for dtype in (cell.config["as_run"]["dtype"], "float32"):
            try:
                emit(f"witness_{dtype}", seed, witness(cell, mod, seed, dtype,
                                                       dev))
            except torch.cuda.OutOfMemoryError as e:
                emit(f"witness_{dtype}", seed, {"error": str(e)[:200]})
            clean()
    out.close()
    return 0


def in_type(cfg: dict, dtype: str) -> dict:
    """A configuration file with the program run in ``dtype``."""
    cfg = copy.deepcopy(cfg)
    cfg["as_run"]["dtype"] = dtype
    cfg["as_run"].setdefault("port_fields", {})["dtype"] = dtype
    return cfg


def witness(cell, mod, seed: int, dtype: str, dev) -> dict:
    """A train cell's three set-up steps with the program in ``dtype``:
    each step's loss gap to the reference, the reference's own loss moves
    from its updates (the reference at a learning rate of 0 against it),
    the share of the program's weights the steps moved, and the cell's
    compared numbers."""
    import torch
    from perfbench import weights
    c = copy.copy(cell)
    c.config = in_type(cell.config, dtype)
    entry = mod.Entry(c, seed, dev)
    entry.setup()
    moved = total = 0
    init = weights.initial_leaves(c.config, seed, dev)
    for cur, p0 in zip((w for _, w in weights.leaf_paths(entry.params)),
                       init, strict=True):
        moved += int((cur != p0).sum())
        total += cur.numel()
    entry.release()
    torch.cuda.empty_cache()
    got = entry.outputs()
    want = mod.reference_readings(entry, None)
    entry.opt_cfg = dict(entry.opt_cfg, lr=0.0)
    still = mod.reference_readings(entry, None)
    return {"loss_gap_by_step": [a - b for a, b in zip(got["loss"],
                                                       want["loss"])],
            "reference_move_by_step": [b - a for a, b in
                                       zip(still["loss"], want["loss"])],
            "weights_moved_share": moved / total,
            "compared": mod.compare(got, want)}


if __name__ == "__main__":
    sys.exit(main())
