"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
runs its entry's set-up, window and check, reads the per-layer metrics,
and forms the result.

Every file is found by name, so a cell, a traffic mix or a metric is
added as files and an entry of ``BENCHMARK.json``:

- ``configs/<config>.json``: a configuration as it is run;
- ``traffic/<traffic>.json``: a traffic mix; its ``entry`` names
  ``entries/<entry>.py``, which runs the window of that kind of work;
- ``limits/<workload>.json``: the limit of each number the cell's check
  compares;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``,
  which returns a number or None where it finds nothing to read;
- ``reference/<family>.py``: all that the benchmark knows of a model
  family, named by a configuration file's ``reference`` key: the plain
  reference's equations, the weight tree, the counts' sizes and the
  program's fields that a configuration implies.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

from .yardstick import ROOT, family, load_json, peaks

# Top-level module names that no process of the benchmark may hold: JAX and
# the JAX package the program was ported from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list       # names of the end-to-end metrics it reports
    per_layer: list        # names of the per-layer metrics it reports
    units: dict            # every metric's unit by name


def bench_file(root: Path = ROOT.parent) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def cell_metrics(bench: dict, workload: str) -> tuple[list, list]:
    """The end-to-end and per-layer metrics a cell reports: those that list
    it, and those without a list (a per-layer one where the cell reports
    the end-to-end metric it moves)."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    layer = []
    for m in bench["per_layer"]:
        ws = m.get("workloads")
        if (workload in ws) if ws is not None else (m["moves"] in e2e):
            layer.append(m["name"])
    return e2e, layer


def load_cell(workload: str, root: Path = ROOT.parent) -> Cell:
    bench = bench_file(root)
    w = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    here = Path(root) / "perfbench"
    e2e, layer = cell_metrics(bench, workload)
    return Cell(name=workload, config=load_json(Path(root) / c["file"]),
                traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(here / "limits" / f"{workload}.json"),
                chips=w["chips"], end_to_end=e2e, per_layer=layer,
                units={m["name"]: m["unit"]
                       for m in bench["end_to_end"] + bench["per_layer"]})


def entry_module(cell: Cell):
    return importlib.import_module(f"perfbench.entries.{cell.traffic['entry']}")


def metric_reader(name: str):
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def port_config(cfg: dict):
    """The program's ModelConfig for a configuration file: its registry
    entry with the file's ``as_run.port_fields``, held field by field
    against the fields that the family's module says the file implies, so
    that the program and the reference run one model."""
    from repro_torch.configs import registry
    run = cfg["as_run"]
    pc = dataclasses.replace(registry.get(run["registry"]),
                             **run.get("port_fields", {}))
    want = family(cfg).port_fields(cfg)
    got = {k: getattr(pc, k) for k in want}
    if got != want:
        raise ValueError(f"the program's {run['registry']} is not the "
                         f"configuration file's model: {got} against "
                         f"{want}")
    return pc


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> float | None:
    """The card's power limit in W, as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and each compared number beside its limit; a number the
    limits name and the check did not give, or that is not finite, fails."""
    out, ok = {}, True
    for name, lim in limits["checks"].items():
        v = checks.get(name)
        good = v is not None and math.isfinite(v) and v <= lim["limit"]
        ok &= good
        out[name] = {"value": v, "limit": lim["limit"]}
    return ok, out


@dataclasses.dataclass
class Context:
    """What a per-layer reader sees of a traced run."""
    config: dict
    traffic: dict
    work: dict
    window_s: float
    busy_s: float
    device: list
    peak: dict | None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None,
             entry_cls=None) -> tuple[dict, dict]:
    """One run: (the result, the compared numbers beside their limits).
    ``entry_cls`` puts another entry class in its place (the tests'
    faults)."""
    import torch
    t0 = time.perf_counter() if t0 is None else t0
    parts = {"start_s": time.perf_counter() - t0}
    if entry_cls is None:
        entry_cls = entry_module(cell).Entry
    entry = entry_cls(cell, seed, torch.device(device))
    if entry.device.type == "cuda":
        t = time.perf_counter()
        build_kernels()
        parts["kernels_s"] = time.perf_counter() - t
    entry.setup()
    setup_s = time.perf_counter() - t0
    parts.update(entry.parts)

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if entry.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        span = _span
    else:
        span = _no_span
    with span("bench.window"):
        done = entry.window(seconds, span)
    if prof is not None:
        prof.__exit__(None, None, None)
    on_card = entry.device.type == "cuda"
    mem = torch.cuda.max_memory_allocated(entry.device) if on_card else 0
    kind = torch.cuda.get_device_name(entry.device) if on_card else "cpu"

    entry.release()
    if on_card:
        torch.cuda.empty_cache()
    correct, checks = judge(entry.check(), cell.limits)

    result = {"correct": correct, "attempted": done["attempted"],
              "failed": done["failed"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": cell.chips if on_card else 0, "memory_peak_bytes": mem,
           "power_limit_w": power_limit() if on_card else None}
    if prof is None:
        values = dict(done["metrics"], setup_s=setup_s)
        result["metrics"] = {n: {"value": values[n], "unit": cell.units[n]}
                             for n in cell.end_to_end}
    else:
        from . import trace as tr_mod
        tr = tr_mod.from_profiler(prof)
        del prof
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        ctx = Context(config=cell.config, traffic=cell.traffic,
                      work=done["work"], window_s=tr.window_s,
                      busy_s=tr.busy_s, device=tr.device,
                      peak=peaks(kind))
        metrics = {}
        for name in cell.per_layer:
            v = metric_reader(name)(ctx)
            if v is not None:
                metrics[name] = {"value": v, "unit": cell.units[name]}
        result["metrics"] = metrics
        result["breakdown"] = tr_mod.breakdown(tr)
    result["device"] = dev
    result["setup_parts"] = parts
    result["checks"] = checks
    return result, checks


def build_kernels() -> None:
    """The program's CUDA kernels, built into the checkout
    (``src/repro_torch/kernels/build/``) where a library is missing, as
    only the first run of a checkout finds them; later runs find them all.
    The time it takes is set-up, and each run reports it apart
    (``setup_parts.kernels_s``)."""
    from repro_torch.kernels import _build
    _build.build_all()


def _span(name):
    from torch.profiler import record_function
    return record_function(name)


def _no_span(name):
    return contextlib.nullcontext()


def emit(result: dict, checks: dict) -> None:
    """The set-up's parts, then each compared number beside its limit as
    the last lines on standard error; the result as the last line of
    standard output."""
    parts = " ".join(f"{k} {v!r}" for k, v in result["setup_parts"].items())
    print(f"setup parts: {parts}", file=sys.stderr, flush=True)
    for name, c in checks.items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
