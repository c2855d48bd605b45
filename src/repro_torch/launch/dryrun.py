"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake world
of 256 or 512 ranks, allocating nothing; the counterpart of the JAX
package's ``launch/dryrun.py``.

Run one cell:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch grok-1-314b \\
        --shape train_4k --mesh single
Run everything (each cell in a fresh subprocess):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
One device's share of a cut cell (a 1x1 mesh, a fake world of one):
    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch stablelm-1.6b --shape train_4k --mesh local --global-batch 4
``--layers N`` cuts the model's depth to N layers (default: the config's),
for a cell that one card runs at a cut depth; the record's ``n_layers`` is
the depth traced.

Where the JAX package lowers and compiles its step on 256/512 fake host
devices, the port runs its step once, eagerly, as DTensors over a
``DeviceMesh`` of the ``"fake"`` process-group backend (every collective
returns at once) under ``FakeTensorMode`` (no tensor has storage).  A
process group is process-global, as JAX's ``XLA_FLAGS`` is, so ``--all``
runs each cell in a process of its own.  The record keeps the JAX
record's keys:

- ``memory``: ``argument_bytes`` (the inputs' local shards),
  ``output_bytes`` (the outputs' local shards that are new) and
  ``alias_bytes`` (those that are inputs updated in place),
  ``peak_bytes``, the most bytes of local storage alive at once over the
  step (the inputs, and every local op's outputs until they are freed),
  ``temp_bytes`` = peak - arguments.  This is what
  ``torch.distributed._tools.mem_tracker.MemTracker`` counts, kept by the
  dry run's own dispatch mode: the MemTracker of PyTorch 2.11 also counts
  the global-shape tensors of DTensor's shape propagation (1,188 GiB for
  StableLM's train_4k cell, against 37.7 GiB without them);
- ``cost``: ``flops`` (``torch.utils.flop_counter``'s formulas, with the
  port's kernel ops' own, over the local ops a device runs) and ``bytes``
  (each local op's tensor inputs read once and outputs written once, a
  broadcast view at its storage's size: the eager port fuses nothing);
- ``collectives``: ``wire_bytes`` and ``counts`` by kind of the
  collectives the step issues, priced by JAX's ring model
  (:func:`ring_wire`, ``parse_collectives`` there).

The port runs every layer in Python, so nothing is counted once for a
loop: the records need no calibration and count as calibrated.  On a
CPU-typed mesh DTensor would run an all-to-all as all-gather + chunk
(gloo has none); the dry run issues the all-to-all op itself (its fake
implementation), so the record holds the collective the model asked for.

Records go to ``src/repro_torch/launch/results/dryrun/<arch>@<shape>@<mesh>
[@tag].json`` (git-ignored).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import weakref
from pathlib import Path

RESULTS = Path(__file__).resolve().parent / "results" / "dryrun"

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def ring_wire(kind: str, payload: float, g: int) -> float:
    """Per-device wire bytes of one collective (JAX's ring model): an
    all-reduce moves 2 (g-1)/g of its payload, a permute all of it, the
    others (g-1)/g; ``payload`` is the result's bytes on one device."""
    if g <= 1 and kind != "collective-permute":
        return 0.0
    if kind == "all-reduce":
        return 2.0 * payload * (g - 1) / g
    if kind == "collective-permute":
        return float(payload)
    return payload * (g - 1) / max(g, 1)


def summarize(events) -> dict:
    """``{"wire_bytes": {kind: bytes, "total": ...}, "counts": {kind: n}}``
    of (kind, payload bytes, group size) events, as JAX's
    ``parse_collectives`` sums them (a group of one is no collective)."""
    totals, counts = {}, {}
    for kind, payload, g in events:
        if g <= 1 and kind != "collective-permute":
            continue
        totals[kind] = totals.get(kind, 0.0) + ring_wire(kind, payload, g)
        counts[kind] = counts.get(kind, 0) + 1
    totals["total"] = sum(totals.values())
    return {"wire_bytes": totals, "counts": counts}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _collective_kinds():
    import torch
    f = torch.ops._c10d_functional
    return {f.all_gather_into_tensor.default: "all-gather",
            f.reduce_scatter_tensor.default: "reduce-scatter",
            f.all_reduce.default: "all-reduce",
            f.all_to_all_single.default: "all-to-all",
            torch.ops._dtensor.shard_dim_alltoall.default: "all-to-all"}


def cost_mode():
    """A dispatch mode that counts, over the local (per-device) ops it
    sees, FLOPs, bytes moved and collectives; DTensor ops are left to
    DTensor (``NotImplemented``), and the ops of DTensor's own sharding
    propagation (run under another fake mode) are not counted."""
    import torch
    from torch._guards import active_fake_mode
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import flop_registry

    kinds = _collective_kinds()
    wait = torch.ops._c10d_functional.wait_tensor.default

    class CostMode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.events = []
            self.live = self.peak = 0
            self._held = {}
            self._fake = None

        def __enter__(self):
            self._fake = active_fake_mode()
            return super().__enter__()

        def hold(self, t) -> None:
            """Count ``t``'s storage as live until it is freed."""
            st = t.untyped_storage()
            key = st._cdata
            if key in self._held:
                return
            self._held[key] = st.nbytes()
            self.live += self._held[key]
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

        def _free(self, key) -> None:
            self.live -= self._held.pop(key, 0)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(t is DTensor or issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            if active_fake_mode() is not self._fake or func is wait:
                return out
            outs = [t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)]
            for t in outs:
                self.hold(t)
            kind = kinds.get(func)
            if kind is not None:
                group = args[-1]
                g = _resolve_process_group(group).size() \
                    if isinstance(group, str) else group.size()
                self.events.append((kind, _nbytes(out), g))
                return out
            packet = func.overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            if not func.is_view:
                ins = [t for t in tree_flatten((args, kwargs))[0]
                       if isinstance(t, torch.Tensor)]
                self.bytes += sum(_moved(t) for t in ins + outs)
            return out

    return CostMode()


def _moved(t) -> int:
    """Bytes an op moves for ``t``: a broadcast view reads its storage
    once, not once an element of the view."""
    return min(_nbytes(t), t.untyped_storage().nbytes())


def _issue_all_to_all():
    """Make DTensor issue its all-to-all op on a CPU-typed mesh (it would
    fall back to all-gather + chunk there); under ``FakeTensorMode`` the
    op's fake implementation runs."""
    import torch
    from torch.distributed.tensor import placement_types
    if not hasattr(torch.ops._dtensor, "shard_dim_alltoall") or not hasattr(
            placement_types, "shard_dim_alltoall"):
        return

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    placement_types.shard_dim_alltoall = shard_dim_alltoall


def _propagation_in_own_fake_mode():
    """DTensor computes an op's output shapes by running it on global
    fake tensors, in the fake mode that is active if there is one; the dry
    run gives that its own mode, so that the counters and the memory
    tracker (which count only ops of the dry run's mode) see only the
    local ops a device runs."""
    from torch.distributed.tensor import _sharding_prop
    if hasattr(_sharding_prop, "detect_fake_mode"):
        _sharding_prop.detect_fake_mode = lambda *a, **kw: None


def _cached_redistribute_plans():
    """DTensor prices each candidate sharding of each op by planning the
    moves to it; under ``FakeTensorMode`` it counts as tracing and skips
    its plan cache, which makes a step on a 3-D mesh take minutes.  The
    plans depend only on the (hashable) source and target specs, so the
    dry run caches them."""
    import functools
    from torch.distributed.tensor import _redistribute
    fn = getattr(_redistribute, "_gen_transform_infos_non_cached", None)
    if fn is None or hasattr(fn, "cache_info"):
        return
    _redistribute._gen_transform_infos_non_cached = functools.lru_cache(
        maxsize=None)(fn)


def _strided_shard_outside_fake():
    """DTensor sizes a strided shard (a sequence-sharded residual, or a
    batch-sharded one, flattened into a product's rows) by splitting an
    index tensor and reading it back; under ``FakeTensorMode`` that read
    has no value, and outside it the split costs ~70 ms a call (xLSTM's
    train_4k on the multi-pod mesh makes tens of thousands of them).  The
    dry run computes the same sizes and offsets in closed form
    (:func:`strided_shard_size_and_offset`), and runs DTensor's own code
    outside fake mode where it cannot (a symbolic size or rank, or a
    PyTorch without offset modes)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types
    cls = getattr(placement_types, "_StridedShard", None)
    fn = getattr(cls, "local_shard_size_and_offset", None)
    if fn is None or getattr(fn, "_outside_fake", False):
        return
    static = isinstance(cls.__dict__.get("local_shard_size_and_offset"),
                        staticmethod)
    modes = getattr(placement_types, "_StridedShardOffsetMode", None)

    def sized(*a, **kw):
        # (self, size, chunks, rank[, offset_mode]) as DTensor passes them
        if not static and modes is not None and 4 <= len(a) <= 5 \
                and not kw and hasattr(a[0], "_split_factor_int") \
                and all(type(x) is int for x in a[1:4]):
            mode = modes(a[4] if len(a) == 5 else modes.FIRST)
            return strided_shard_size_and_offset(
                a[1], a[0]._split_factor_int(), a[2], a[3],
                mode.name.lower())
        with unset_fake_temporarily():
            return fn(*a, **kw)

    sized._outside_fake = True
    if static:
        sized = staticmethod(sized)
    cls.local_shard_size_and_offset = sized


def strided_shard_size_and_offset(size: int, split_factor: int,
                                  chunks: int, rank: int,
                                  mode: str = "first"):
    """``_StridedShard.local_shard_size_and_offset`` in closed form: the
    dim of ``size`` is chunked (``torch.chunk``'s ceil-sized pieces) into
    ``split_factor`` pieces, each of those into ``chunks``, and ``rank``
    holds its piece of every one.  Returns (its size, its first index or
    -1 if it has none), (size, every index) or (size, None) for the
    ``mode`` "first", "all" or "none"."""
    first = -(-size // split_factor)
    n, idx = 0, []
    for j in range(split_factor):
        lo, hi = min(first * j, size), min(first * (j + 1), size)
        second = -(-(hi - lo) // chunks)
        a, b = min(second * rank, hi - lo), min(second * (rank + 1), hi - lo)
        n += max(0, b - a)
        if b > a and (mode == "all" or not idx):
            idx.extend(range(lo + a, lo + b))
    if mode == "none":
        return n, None
    if mode == "all":
        return n, idx
    return n, idx[0] if idx else -1


def _local(x):
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def _leaves(tree) -> list:
    import torch
    from torch.utils._pytree import tree_flatten
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _storage_key(t):
    return t.untyped_storage()._cdata


def init_world(world: int) -> None:
    """The fake process group of ``world`` ranks, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"this process already has a world of "
                               f"{dist.get_world_size()}, not {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def trace_cell(cell) -> dict:
    """Run a cell's step once under ``FakeTensorMode`` (its inputs must be
    fake DTensors) and return ``memory``, ``cost`` and ``collectives``."""
    args = [_local(x) for x in _leaves(cell.args)]
    arg_bytes = sum(_nbytes(t) for t in args)
    arg_keys = {_storage_key(t) for t in args}
    cm = cost_mode()
    for t in args:
        cm.hold(t)
    with cm:
        out = cell.fn(*cell.args)
    outs = [_local(x) for x in _leaves(out)]
    seen, new, alias = set(), 0, 0
    for t in outs:
        key = _storage_key(t)
        if key in seen:
            continue
        seen.add(key)
        if key in arg_keys:
            alias += _nbytes(t)
        else:
            new += _nbytes(t)
    peak = cm.peak
    return {
        "memory": {"argument_bytes": arg_bytes, "output_bytes": new,
                   "alias_bytes": alias, "peak_bytes": peak,
                   "temp_bytes": peak - arg_bytes},
        "cost": {"flops": float(cm.flops), "bytes": float(cm.bytes),
                 "transcendentals": 0.0},
        "collectives": summarize(cm.events),
    }


def dry_run(cfg, shape: str, mesh, *, tcfg=None, seq_shard=None,
            layout: str = "tp_fsdp", global_batch: int | None = None
            ) -> dict:
    """Trace the cell of ``cfg`` at ``shape`` on the abstract ``mesh`` over
    a fake world of ``mesh.size`` ranks (initialised here if need be):
    ``memory``, ``cost``, ``collectives`` and ``build_s`` / ``run_s``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from .cells import input_specs
    from .mesh import device_mesh
    t0 = time.time()
    init_world(mesh.size)
    _issue_all_to_all()
    _propagation_in_own_fake_mode()
    _strided_shard_outside_fake()
    _cached_redistribute_plans()
    dmesh = device_mesh(mesh, "cpu")
    with FakeTensorMode():
        cell = input_specs(cfg, shape, dmesh, tcfg, seq_shard=seq_shard,
                           layout=layout, global_batch=global_batch)
        build_s = round(time.time() - t0, 2)
        t1 = time.time()
        rec = trace_cell(cell)
    rec["build_s"] = build_s
    rec["run_s"] = round(time.time() - t1, 2)
    return rec


def run_cell(arch: str, shape: str, mesh_kind: str, *, seq_shard=None,
             microbatches: int = 1, remat=None, kv_dtype=None,
             layout: str = "tp_fsdp", out_dir: Path = RESULTS,
             tag: str = "", global_batch: int | None = None,
             layers: int | None = None) -> dict:
    """Trace one cell on the production mesh (``mesh_kind`` "single" or
    "multi"), or on one device ("local", a 1x1 mesh), and write its
    record; a failure is recorded with its error, never hidden.
    ``global_batch`` cuts the shape's batch, ``layers`` the depth."""
    from ..configs import registry
    from ..training.optimizer import OptConfig
    from ..training.train_loop import TrainConfig
    from .mesh import AbstractMesh, make_production_mesh

    cfg = registry.get(arch)
    overrides = {}
    if remat is not None:
        overrides["remat"] = remat
    if kv_dtype is not None:
        overrides["kv_dtype"] = kv_dtype
    if layers is not None:
        overrides["n_layers"] = layers
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    mesh = (AbstractMesh(("data", "model"), (1, 1)) if mesh_kind == "local"
            else make_production_mesh(multi_pod=(mesh_kind == "multi")))
    tcfg = TrainConfig(microbatches=microbatches, opt=OptConfig())
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "devices": mesh.size, "tag": tag, "microbatches": microbatches,
           "layout": layout, "calibrated": True,
           "global_batch": global_batch, "n_layers": cfg.n_layers}
    try:
        rec.update(dry_run(cfg, shape, mesh, tcfg=tcfg, seq_shard=seq_shard,
                           layout=layout, global_batch=global_batch))
        rec["ok"] = True
        m = rec["memory"]
        print(f"[dryrun] {arch}@{shape}@{mesh_kind}: OK  "
              f"peak={m['peak_bytes'] / 2**30:.2f}GiB/dev  "
              f"flops/dev={rec['cost']['flops']:.3e}  "
              f"coll={rec['collectives']['wire_bytes']['total'] / 2**20:.1f}"
              f"MiB  ({rec['run_s']} s)", flush=True)
    except Exception as e:  # noqa: BLE001 - recorded, the cell marked failed
        import traceback
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {arch}@{shape}@{mesh_kind}: FAIL "
              f"{rec['error'][:300]}", flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"@{tag}" if tag else ""
    path = out_dir / f"{arch}@{shape}@{mesh_kind}{suffix}.json"
    path.write_text(json.dumps(rec, indent=1))
    return rec


def all_cells() -> list:
    from ..configs import registry
    from ..configs.base import shapes_for
    return [(arch, shape, mesh_kind)
            for arch, cfg in registry.ARCHS.items()
            for shape in shapes_for(cfg)
            for mesh_kind in ("single", "multi")]


def cell_command(arch: str, shape: str, mesh_kind: str,
                 extra: list | tuple = ()) -> list:
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            arch, "--shape", shape, "--mesh", mesh_kind, *extra]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "local"])
    ap.add_argument("--global-batch", type=int, default=None,
                    help="cut the shape's global batch (one cell)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model's depth (one cell; default: the "
                         "config's)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--kv-dtype", default=None, choices=[None, "bf16", "f8"])
    ap.add_argument("--seq-shard", default="auto",
                    choices=["auto", "on", "off"])
    ap.add_argument("--layout", default="tp_fsdp",
                    choices=["tp_fsdp", "fsdp"])
    ap.add_argument("--out-dir", default=str(RESULTS))
    args = ap.parse_args(argv)
    out_dir = Path(args.out_dir)

    if args.all:
        failures = 0
        for arch, shape, mesh_kind in all_cells():
            suffix = f"@{args.tag}" if args.tag else ""
            path = out_dir / f"{arch}@{shape}@{mesh_kind}{suffix}.json"
            if path.exists() and not args.force:
                if json.loads(path.read_text()).get("ok"):
                    continue
            extra = ["--microbatches", str(args.microbatches), "--seq-shard",
                     args.seq_shard, "--layout", args.layout, "--out-dir",
                     str(out_dir)]
            for flag, val in (("--remat", args.remat), ("--tag", args.tag),
                              ("--kv-dtype", args.kv_dtype)):
                if val:
                    extra += [flag, val]
            try:
                r = subprocess.run(cell_command(arch, shape, mesh_kind,
                                                extra),
                                   timeout=args.timeout, check=False)
                failures += bool(r.returncode)
            except subprocess.TimeoutExpired:
                failures += 1
                out_dir.mkdir(parents=True, exist_ok=True)
                path.write_text(json.dumps({
                    "arch": arch, "shape": shape, "mesh": mesh_kind,
                    "tag": args.tag, "ok": False,
                    "error": f"timed out after {args.timeout} s"}, indent=1))
                print(f"[dryrun] {arch}@{shape}@{mesh_kind}: FAIL timed out",
                      flush=True)
        print(f"[dryrun --all] done, {failures} failed cells")
        return 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    seq_shard = {"on": True, "off": False}.get(args.seq_shard)
    rec = run_cell(args.arch, args.shape, args.mesh,
                   microbatches=args.microbatches, remat=args.remat,
                   kv_dtype=args.kv_dtype, seq_shard=seq_shard,
                   layout=args.layout, out_dir=out_dir, tag=args.tag,
                   global_batch=args.global_batch, layers=args.layers)
    return 0 if rec.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
