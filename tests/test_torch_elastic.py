"""The port's launch cells, elastic restore and the pod-compressed
gradient mean against the JAX package on the CPU.

- ``input_specs`` of every (arch, shape) of ``all_cells()`` on the 1x1
  mesh: every input a ``meta`` tensor, with JAX's shapes and dtypes and
  JAX's ``NamedSharding`` specs (the port's per-layer leaves against JAX's
  stacked ones, the leading L entry dropped); the same inputs as DTensors
  over a one-rank ``DeviceMesh``.
- ``CheckpointManager.restore(shardings=)`` onto a 2-rank gloo mesh: each
  rank's slice equals its part of the saved array; a shape mismatch
  raises.
- ``compress_pod_reduce`` over a 2-rank gloo ``pod`` mesh against the
  formula built from JAX's ``quantize_int8`` / ``dequantize_int8``, and
  against JAX's own ``compress_pod_reduce`` run in a subprocess with 2
  forced host devices (jax 0.9 runs it under ``jax.set_mesh``).
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch import cells as jcells
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.training import compression as jcomp
from repro_torch.configs import registry
from repro_torch.launch import cells
from repro_torch.launch.dryrun import all_cells
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.sharding.specs import P
from repro_torch.training.checkpoint import CheckpointManager

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = sorted({(a, s) for a, s, _ in all_cells()})


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def _flat(tree, prefix=""):
    if isinstance(tree, P):
        return {prefix: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(_flat(getattr(tree, k), f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _jax_flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/" + "/".join(str(getattr(p, "key", getattr(p, "idx",
                                                         getattr(p, "name",
                                                                 p))))
                           for p in path)] = leaf
    return out


def _stacked(path: str) -> tuple[str, bool]:
    """The JAX path of a port leaf: the layer index under ``layers`` (a
    parameter) or right after the arg index (a cache) dropped."""
    parts = path.split("/")
    if "layers" in parts:
        i = parts.index("layers")
        if i + 1 < len(parts) and parts[i + 1].isdigit():
            return "/".join(parts[:i + 1] + parts[i + 2:]), True
    if len(parts) > 2 and parts[1] == "1" and parts[2].isdigit():
        return "/".join(parts[:2] + parts[3:]), True      # the cache arg
    return path, False


@pytest.fixture(scope="module")
def jmesh():
    return jax_local_mesh()


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_jax_on_the_local_mesh(jmesh, arch, shape):
    cfg = registry.get(arch)
    cell = cells.input_specs(cfg, shape, make_local_mesh(device="cpu"))
    jcell = jcells.input_specs(jregistry.get(arch), shape, jmesh)
    assert cell.kind == jcell.kind and cell.donate == jcell.donate
    assert cell.name == jcell.name
    got, spec = _flat(cell.args), _flat(cell.specs)
    want = _jax_flat(jcell.args)
    assert set(got) == set(spec)
    keys = {}
    for k, t in got.items():
        jk, stacked = _stacked(k)
        keys[jk] = True
        j = want[jk]
        assert t.device.type == "meta", k
        assert tuple(j.shape) == ((cfg.n_layers,) if stacked else ()) + \
            tuple(t.shape), k
        assert str(t.dtype).split(".")[-1] == str(j.dtype), k
        js = () if j.sharding is None else tuple(j.sharding.spec)
        js = js + (None,) * (len(j.shape) - len(js))
        if stacked:
            assert js[0] is None
            js = js[1:]
        assert tuple(spec[k]) + (None,) * (t.dim() - len(spec[k])) == js, k
    assert set(keys) == set(want)


def test_input_specs_as_dtensors_on_a_one_rank_mesh(tmp_path):
    code = textwrap.dedent("""
        import sys, torch, torch.distributed as dist
        from torch.distributed.tensor import DTensor
        from repro_torch.configs import registry
        from repro_torch.launch import cells
        from repro_torch.launch.mesh import device_mesh, make_local_mesh
        dist.init_process_group("gloo", init_method="file://" + sys.argv[1],
                                rank=0, world_size=1)
        dm = device_mesh(make_local_mesh(device="cpu"))
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            cell = cells.input_specs(registry.smoke("stablelm-1.6b"), shape,
                                     dm, global_batch=2)
            leaves = [x for x in torch.utils._pytree.tree_flatten(
                cell.args)[0] if isinstance(x, torch.Tensor)]
            assert all(isinstance(x, DTensor) for x in leaves)
            assert all(x.to_local().device.type == "meta" for x in leaves)
            print(shape, len(leaves), cell.kind)
        dist.destroy_process_group()
    """)
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path / "pg")],
                       env=_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "decode_32k" in r.stdout


# ---------------------------------------------------------------------------
# two-rank gloo worlds
# ---------------------------------------------------------------------------
def _run_ranks(code: str, tmp: pathlib.Path, world: int = 2) -> list:
    """``code`` in ``world`` processes (``RANK``, ``WORLD``, ``TMP``
    defined, a gloo group initialised); each prints one JSON line last."""
    head = textwrap.dedent("""
        import json, sys, numpy as np, torch, torch.distributed as dist
        RANK, WORLD, TMP = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
        dist.init_process_group("gloo", init_method="file://" + TMP + "/pg",
                                rank=RANK, world_size=WORLD)
    """)
    # every rank leaves together, without a group teardown at exit (gloo
    # can abort a process whose peer has already gone)
    tail = "\nsys.stdout.flush()\ndist.barrier()\nimport os\nos._exit(0)\n"
    procs = [subprocess.Popen([sys.executable, "-c",
                               head + textwrap.dedent(code) + tail, str(r),
                               str(world), str(tmp)], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, out + err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


def _saved(tmp: pathlib.Path):
    rng = np.random.default_rng(5)
    tree = {"w": torch.from_numpy(rng.standard_normal((6, 4)).astype(
                np.float32)),
            "layers": [{"b": torch.from_numpy(
                rng.standard_normal((4, 10)).astype(np.float32)).to(
                    torch.bfloat16)}],
            "s": torch.tensor(3, dtype=torch.int32)}
    CheckpointManager(tmp / "ckpt").save(7, tree, block=True)
    return tree


def test_restore_onto_a_two_rank_mesh(tmp_path):
    tree = _saved(tmp_path)
    outs = _run_ranks("""
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.sharding.specs import P
        from repro_torch.training.checkpoint import CheckpointManager
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
        tmpl = {"w": torch.empty(6, 4), "layers": [{"b": torch.empty(
            4, 10, dtype=torch.bfloat16)}], "s": torch.empty((), dtype=
            torch.int32)}
        sh = {"w": (mesh, P("data", None)),
              "layers": [{"b": (mesh, P(None, "data"))}],
              "s": (mesh, P())}
        got = CheckpointManager(TMP + "/ckpt").restore(7, tmpl, shardings=sh)
        out = {}
        for k, x in (("w", got["w"]), ("b", got["layers"][0]["b"]),
                     ("s", got["s"])):
            out[k] = [str(x.placements), list(x.shape), str(x.dtype),
                      x.to_local().float().tolist()]
        print(json.dumps(out))
    """, tmp_path)
    w = tree["w"].numpy()
    b = tree["layers"][0]["b"].float().numpy()
    for r, out in enumerate(outs):
        assert out["w"][1] == [6, 4] and out["b"][1] == [4, 10]
        assert out["b"][2] == "torch.bfloat16"
        np.testing.assert_array_equal(np.array(out["w"][3]),
                                      w[3 * r:3 * r + 3])
        np.testing.assert_array_equal(np.array(out["b"][3]),
                                      b[:, 5 * r:5 * r + 5])
        assert out["s"][3] == 3 and "Replicate" in out["s"][0]


def test_restore_shape_mismatch_raises(tmp_path):
    _saved(tmp_path)
    mgr = CheckpointManager(tmp_path / "ckpt")
    bad = {"w": torch.empty(4, 6), "layers": [{"b": torch.empty(
        4, 10, dtype=torch.bfloat16)}], "s": torch.empty((),
                                                          dtype=torch.int32)}
    with pytest.raises(ValueError, match="shape mismatch for /w"):
        mgr.restore(7, bad)
    with pytest.raises(ValueError, match="shape mismatch for /w"):
        mgr.restore(7, bad, shardings={"w": None, "layers": [{"b": None}],
                                       "s": None})


_POD_CODE = """
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.training.compression import compress_pod_reduce
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("pod",))
    g = np.load(TMP + f"/g{RANK}.npy")
    out = compress_pod_reduce({"a": torch.from_numpy(g)}, mesh=mesh)
    assert compress_pod_reduce({"a": 1}, axis="data", mesh=mesh) == {"a": 1}
    print(json.dumps(out["a"].tolist()))
"""


def test_compress_pod_reduce_matches_the_int8_formula(tmp_path):
    rng = np.random.default_rng(11)
    gs = [rng.standard_normal((5, 7)).astype(np.float32) * (r + 1)
          for r in range(2)]
    for r, g in enumerate(gs):
        np.save(tmp_path / f"g{r}.npy", g)
    outs = _run_ranks(_POD_CODE, tmp_path)
    scale = jnp.maximum(max(jnp.max(jnp.abs(jnp.asarray(g))) for g in gs),
                        1e-8)
    qs = [jcomp.quantize_int8(jnp.asarray(g), scale) for g in gs]
    s = sum(q.astype(jnp.int32) for q in qs)
    want = np.asarray(s.astype(jnp.float32) * (scale / 127.0) / 2)
    for out in outs:
        np.testing.assert_array_equal(np.array(out, np.float32), want)
    # one pod's codes, through JAX's dequantisation, is its share
    np.testing.assert_allclose(
        np.asarray(jcomp.dequantize_int8(qs[0], scale)), gs[0],
        atol=float(scale) / 127)


def test_compress_pod_reduce_matches_jax_on_two_host_devices(tmp_path):
    """JAX's ``compress_pod_reduce`` replicates each leaf over ``pod``
    (its shard_map in_specs), so both pods hold the same gradient; the
    port's 2-rank mean of the same gradient must equal it bit for bit."""
    g = np.random.default_rng(12).standard_normal((6, 5)).astype(np.float32)
    for r in range(2):
        np.save(tmp_path / f"g{r}.npy", g)
    code = textwrap.dedent("""
        import os, sys, json
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        import jax, jax.numpy as jnp, numpy as np
        from repro.training.compression import compress_pod_reduce
        mesh = jax.make_mesh((2,), ("pod",),
                             axis_types=(jax.sharding.AxisType.Explicit,))
        g = {"a": jnp.asarray(np.load(sys.argv[1]))}
        with jax.set_mesh(mesh):
            out = jax.jit(compress_pod_reduce)(g)
        print(json.dumps(np.asarray(out["a"]).tolist()))
    """)
    env = _env()
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", code,
                        str(tmp_path / "g0.npy")], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    want = np.array(json.loads(r.stdout.strip().splitlines()[-1]),
                    np.float32)
    outs = _run_ranks(_POD_CODE, tmp_path)
    for out in outs:
        np.testing.assert_array_equal(np.array(out, np.float32), want)
