"""The port's dry run (``repro_torch.launch.dryrun``) and roofline
(``repro_torch.launch.roofline``) against the JAX package on the CPU.

- Smoke-size dense, MoE, hybrid and xLSTM configs traced on fake worlds
  of 16 ranks (a 4x4 ``(data, model)`` mesh) and 8 ranks (2x2x2 ``(pod,
  data, model)``), one subprocess a cell with a time limit (a process group is
  process-global): each ``ok``, its argument bytes the planner's local
  shard bytes, the collectives it needs present.
- The ring model against JAX's ``parse_collectives`` on the same (kind,
  payload, group) lines.
- ``model_flops`` equal to JAX's for every cell of ``all_cells()``, and
  ``analyze`` equal to JAX's with its three TPU constants swapped for the
  port's H100 ones.
"""
import json
import math
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro.configs import registry as jregistry
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import roofline as jroofline
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.launch import cells, dryrun, roofline
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.sharding import specs

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"4x4": (("data", "model"), (4, 4)),
          "2x2x2": (("pod", "data", "model"), (2, 2, 2))}
SMOKE = [("stablelm-1.6b", "train_4k", "4x4"),
         ("phi3.5-moe-42b-a6.6b", "decode_32k", "4x4"),
         ("hymba-1.5b", "prefill_32k", "4x4"),
         ("stablelm-1.6b", "prefill_32k", "2x2x2"),
         ("phi3.5-moe-42b-a6.6b", "decode_32k", "2x2x2"),
         ("hymba-1.5b", "prefill_32k", "2x2x2"),
         ("hymba-1.5b", "decode_32k", "4x4"),
         ("xlstm-350m", "decode_32k", "2x2x2")]
BATCH = 8          # the smoke cells' global batch (divides every DP size)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def _planned_argument_bytes(cfg, shape, mesh) -> int:
    cell = cells.input_specs(cfg, shape, mesh, global_batch=BATCH)
    total = 0

    def walk(a, s):
        nonlocal total
        if isinstance(s, specs.P):
            n = math.prod(specs.local_shape(mesh, a.shape, s))
            total += n * a.element_size()
            return
        if isinstance(a, dict):
            for k in a:
                walk(a[k], s[k])
            return
        for x, y in zip(a, s):
            walk(x, y)

    walk(cell.args, cell.specs)
    return total


@pytest.mark.parametrize("arch,shape,mesh_name", SMOKE)
def test_smoke_cells_trace_on_a_fake_world(arch, shape, mesh_name):
    names, sizes = MESHES[mesh_name]
    code = textwrap.dedent(f"""
        import json
        from repro_torch.configs import registry
        from repro_torch.launch.dryrun import dry_run
        from repro_torch.launch.mesh import AbstractMesh
        rec = dry_run(registry.smoke({arch!r}), {shape!r},
                      AbstractMesh({names!r}, {sizes!r}),
                      global_batch={BATCH})
        print(json.dumps(rec))
    """)
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    mesh = AbstractMesh(names, sizes)
    cfg = registry.smoke(arch)
    m = rec["memory"]
    assert m["argument_bytes"] == _planned_argument_bytes(cfg, shape, mesh)
    assert m["peak_bytes"] >= m["argument_bytes"] > 0
    assert m["temp_bytes"] == m["peak_bytes"] - m["argument_bytes"]
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes"] > 0
    coll = rec["collectives"]
    assert coll["wire_bytes"]["total"] == pytest.approx(sum(
        v for k, v in coll["wire_bytes"].items() if k != "total"))
    kinds = set(coll["counts"])
    assert kinds <= set(dryrun.KINDS)
    # FSDP weights are gathered and tensor-parallel partial sums reduced
    assert "all-gather" in kinds
    assert kinds & {"all-reduce", "reduce-scatter"}
    if shape == "train_4k":
        # the updates change every parameter and optimizer leaf in place;
        # the batch and the optimizer's int32 step count are not returned
        assert m["alias_bytes"] == m["argument_bytes"] - (
            _batch_bytes(cfg, mesh)) - 4


def _batch_bytes(cfg, mesh) -> int:
    cell = cells.input_specs(cfg, "train_4k", mesh, global_batch=BATCH)
    b = cell.args[2]
    sp = cell.specs[2]
    return sum(math.prod(specs.local_shape(mesh, b[k].shape, sp[k]))
               * b[k].element_size() for k in b)


def _jax_parse_collectives():
    """JAX's ``parse_collectives``.  Its module sets ``XLA_FLAGS`` (512
    host devices) when imported, which would reach every JAX test that
    this worker runs later, so the variable is put back at once."""
    prev = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev
    return jdryrun.parse_collectives


def _hlo_line(kind, dtype, shape, g, iota):
    dims = ",".join(str(n) for n in shape)
    groups = (f"replica_groups=[{64 // g},{g}]<=[64]" if iota else
              "replica_groups={{" + ",".join(str(i) for i in range(g))
              + "}}")
    return (f"  %c.1 = {dtype}[{dims}]{{0}} {kind}({dtype}[{dims}] %p), "
            f"{groups}, to_apply=%add")


def test_ring_model_matches_jax_parse_collectives():
    lines, events = [], []
    nbytes = {"bf16": 2, "f32": 4, "s8": 1, "s32": 4}
    for i, kind in enumerate(dryrun.KINDS):
        for g in (1, 2, 4, 16):
            for dt in ("bf16", "f32", "s8"):
                shape = (g * 3, 5 + i)
                lines.append(_hlo_line(kind, dt, shape, g, iota=g == 4))
                events.append((kind, nbytes[dt] * math.prod(shape), g))
    parse = _jax_parse_collectives()
    want = parse("\n".join(lines))
    got = dryrun.summarize(events)
    assert got["counts"] == want["counts"]
    assert set(got["wire_bytes"]) == set(want["wire_bytes"])
    for k, v in want["wire_bytes"].items():
        assert got["wire_bytes"][k] == pytest.approx(v, rel=1e-12), k
    for kind, payload, g in events:
        if g > 1 or kind == "collective-permute":
            one = parse(_hlo_line(
                kind, "s8", (payload,), g, iota=False))
            assert dryrun.ring_wire(kind, payload, g) == pytest.approx(
                one["wire_bytes"][kind], rel=1e-12)


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_model_flops_equal_jax_for_every_cell(arch):
    cfg, jcfg = registry.get(arch), jregistry.get(arch)
    shapes = {s for a, s, _ in dryrun.all_cells() if a == arch}
    assert shapes
    for s in shapes:
        assert roofline.model_flops(cfg, SHAPES[s]) == \
            jroofline.model_flops(jcfg, JSHAPES[s])


def _record(arch, shape, mesh, scale):
    return {"arch": arch, "shape": shape, "mesh": mesh, "ok": True,
            "tag": "", "devices": 512 if mesh == "multi" else 256,
            "memory": {"peak_bytes": 3.5e10 * scale},
            "cost": {"flops": 2.0e14 * scale, "bytes": 4.0e12 / scale},
            "collectives": {"wire_bytes": {"total": 1.5e10 * scale}}}


@pytest.mark.parametrize("scale", [0.01, 1.0, 7.0])
def test_analyze_equals_jax_with_the_h100_constants(monkeypatch, scale):
    monkeypatch.setattr(jroofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jroofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jroofline, "ICI_BW", roofline.LINK_BW)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989.4e12, 3.35e12, 50e9)
    for arch, shape, mesh in dryrun.all_cells()[::5]:
        rec = _record(arch, shape, mesh, scale)
        got, want = roofline.analyze(rec), jroofline.analyze(rec)
        assert got.pop("calibrated") and not want.pop("calibrated")
        assert got.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, float):
                assert got[k] == pytest.approx(v, rel=1e-12), k
            else:
                assert got[k] == v, k


def test_table_and_load_all_read_records(tmp_path):
    good = _record("stablelm-1.6b", "train_4k", "single", 1.0)
    bad = {"arch": "grok-1-314b", "shape": "train_4k", "mesh": "single",
           "ok": False, "error": "RuntimeError: no strategy"}
    (tmp_path / "a.json").write_text(json.dumps(good))
    (tmp_path / "b.json").write_text(json.dumps(bad))
    rows = roofline.load_all(results=tmp_path)
    assert [r["ok"] for r in rows] == [True, False]
    text = roofline.table(rows)
    assert "stablelm-1.6b | train_4k |" in text and "grok" not in text


@pytest.mark.parametrize("split_factor", [1, 2, 3, 16, 256])
@pytest.mark.parametrize("chunks", [1, 2, 3, 16])
def test_strided_shard_sizes_equal_dtensors(split_factor, chunks):
    """The dry run's closed-form strided-shard size and offsets equal
    DTensor's own (an index tensor split and read back) for every rank and
    offset mode, on even, ragged and empty dims."""
    from torch.distributed.tensor import placement_types
    fn = placement_types._StridedShard.local_shard_size_and_offset
    assert not getattr(fn, "_outside_fake", False)    # DTensor's own
    modes = placement_types._StridedShardOffsetMode
    for size in (0, 1, 5, 17, 48, 4096, 4099):
        for dim in (0, 1):
            p = placement_types._StridedShard(dim, split_factor=split_factor)
            for rank in range(chunks):
                for mode in modes:
                    want = p.local_shard_size_and_offset(size, chunks, rank,
                                                         mode)
                    got = dryrun.strided_shard_size_and_offset(
                        size, split_factor, chunks, rank, mode.name.lower())
                    assert tuple(got) == tuple(want), (size, dim, rank, mode)


def test_hymba_decode_cell_with_heads_split_unevenly():
    """Hymba's decode cell at full width (one layer) on a 4x4 fake world:
    its 25 Mamba heads split unevenly over the 4-wide ``model`` axis after
    the decode step's state update, and ``merge_heads`` gathers them
    before the flatten that DTensor refuses for an uneven split."""
    code = textwrap.dedent("""
        import dataclasses, json
        from repro_torch.configs import registry
        from repro_torch.launch.dryrun import dry_run
        from repro_torch.launch.mesh import AbstractMesh
        cfg = dataclasses.replace(registry.get("hymba-1.5b"), n_layers=1)
        rec = dry_run(cfg, "decode_32k",
                      AbstractMesh(("data", "model"), (4, 4)),
                      global_batch=8)
        print(json.dumps(rec["collectives"]["counts"]))
    """)
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["all-gather"] > 0
