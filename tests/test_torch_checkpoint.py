"""The port's checkpoints (``repro_torch.training.checkpoint``): the JAX
package's layout, read and written both ways bit for bit, crash-safe
writes and garbage collection, and an asynchronous save that later
in-place updates cannot reach."""
import json
import threading
from typing import NamedTuple

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.training.checkpoint import CheckpointManager as JaxCkpt
from repro_torch.configs import registry
from repro_torch.models import transformer as tf
from repro_torch.training import checkpoint as ckpt_mod
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import OptState, init_opt, tree_leaves


class Pair(NamedTuple):
    first: object
    second: object


def _numpy_tree(rng):
    return {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "bf": rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16),
            "i": rng.integers(-9, 9, (7,)).astype(np.int32),
            "flag": np.array([True, False, True]),
            "nt": Pair(np.float32(2.5),
                       rng.standard_normal(3).astype(ml_dtypes.bfloat16)),
            "lst": [rng.standard_normal(2).astype(np.float32)]}


def _torch_of(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _map(f, t):
    if isinstance(t, dict):
        return {k: _map(f, v) for k, v in t.items()}
    if hasattr(t, "_fields"):
        return type(t)(*(_map(f, v) for v in t))
    if isinstance(t, list):
        return [_map(f, v) for v in t]
    return f(t)


def _bits(x) -> np.ndarray:
    """The raw bits of a leaf (numpy, JAX or torch) as an unsigned view."""
    if isinstance(x, torch.Tensor):
        x, _ = ckpt_mod.to_host(x)
    a = np.asarray(x)
    return a.view(np.uint8 if a.dtype.itemsize == 1 else
                  {2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def _assert_bitwise(got, want):
    g = ckpt_mod._flatten(got)
    w = ckpt_mod._flatten(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(_bits(g[k]), _bits(w[k]), err_msg=k)


def test_port_writes_what_jax_restores(tmp_path):
    tree = _numpy_tree(np.random.default_rng(0))
    cm = CheckpointManager(tmp_path)
    cm.save(4, _map(_torch_of, tree), block=True)
    manifest = json.loads((tmp_path / "step_4" / "manifest.json"
                           ).read_text())["leaves"]
    assert manifest["/bf"]["dtype"] == "bfloat16"
    assert manifest["/nt/second"]["dtype"] == "bfloat16"
    assert manifest["/i"]["dtype"] == "int32"
    got = JaxCkpt(tmp_path).restore(4, _map(jnp.asarray, tree))
    assert got["bf"].dtype == jnp.bfloat16 and got["i"].dtype == jnp.int32
    assert isinstance(got["nt"], Pair)
    _assert_bitwise(got, tree)


def test_jax_writes_what_the_port_restores(tmp_path):
    tree = _numpy_tree(np.random.default_rng(1))
    JaxCkpt(tmp_path).save(2, _map(jnp.asarray, tree), block=True)
    cm = CheckpointManager(tmp_path)
    assert cm.latest_step() == 2
    template = _map(lambda x: torch.zeros_like(_torch_of(x)), tree)
    got = cm.restore(2, template)
    assert got["bf"].dtype == torch.bfloat16
    assert got["flag"].dtype == torch.bool
    assert isinstance(got["nt"], Pair) and isinstance(got["lst"], list)
    _assert_bitwise(got, tree)


def test_fp8_leaves_round_trip(tmp_path):
    x = torch.randn(16).to(torch.float8_e4m3fn)
    cm = CheckpointManager(tmp_path)
    cm.save(1, {"x": x}, block=True)
    got = cm.restore(1, {"x": torch.zeros_like(x)})
    assert got["x"].dtype == torch.float8_e4m3fn
    assert torch.equal(got["x"].view(torch.uint8), x.view(torch.uint8))
    j = JaxCkpt(tmp_path).restore(1, {"x": jnp.zeros(16, jnp.float8_e4m3fn)})
    np.testing.assert_array_equal(_bits(j["x"]), _bits(x))


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones(4, dtype=torch.bfloat16)}}
    cm = CheckpointManager(tmp_path, keep=2)
    cm.save(1, tree, block=True)
    cm.save(2, {"w": tree["w"] + 1, "nested": {"b": tree["nested"]["b"]}},
            block=True)
    assert cm.latest_step() == 2
    assert not list(tmp_path.glob("*.tmp"))
    got = cm.restore(2, tree)
    torch.testing.assert_close(got["w"], tree["w"] + 1)
    assert got["nested"]["b"].dtype == torch.bfloat16
    # a write that never finished leaves only its .tmp, which is not a step
    (tmp_path / "step_9.tmp").mkdir()
    assert sorted(cm.steps()) == [1, 2] and cm.latest_step() == 2


def test_checkpoint_gc_keeps_latest(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, {"x": torch.tensor(float(s))}, block=True)
    assert sorted(cm.steps()) == [3, 4]


def test_restore_shape_mismatch_raises(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(1, {"w": torch.ones(4, 4)}, block=True)
    with pytest.raises(ValueError, match="shape mismatch"):
        cm.restore(1, {"w": torch.zeros(2, 2)})


def test_async_save_is_a_snapshot(tmp_path, monkeypatch):
    """The save copies CPU tensors before it returns: an in-place update
    made while the write is still blocked does not reach the files."""
    gate = threading.Event()
    real = np.save

    def slow_save(*a, **kw):
        gate.wait(10)
        return real(*a, **kw)

    monkeypatch.setattr(ckpt_mod.np, "save", slow_save)
    w = torch.zeros(1000)
    bf = torch.zeros(8, dtype=torch.bfloat16)
    cm = CheckpointManager(tmp_path)
    cm.save(1, {"w": w, "bf": bf})
    w.add_(7.0)
    bf.add_(3.0)
    gate.set()
    cm.wait()
    got = cm.restore(1, {"w": w, "bf": bf})
    assert float(got["w"].abs().max()) == 0.0
    assert float(got["bf"].float().abs().max()) == 0.0


def test_opt_state_round_trip_restores_onto_the_templates_device(tmp_path):
    cfg = registry.smoke("phi3.5-moe-42b-a6.6b")
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    opt = init_opt(params)
    state = {"params": params, "opt": opt}
    cm = CheckpointManager(tmp_path)
    cm.save(3, state, block=True)
    template = {"params": tf.init_params(torch.Generator().manual_seed(1),
                                         cfg), "opt": init_opt(params)}
    got = cm.restore(3, template)
    assert isinstance(got["opt"], OptState) and int(got["opt"].step) == 0
    for a, b in zip(tree_leaves(got), tree_leaves(state)):
        assert a.dtype == b.dtype and a.device.type == "cpu"
        assert torch.equal(a, b)
    assert got["params"]["layers"][1]["moe"]["router"].dtype == torch.float32
