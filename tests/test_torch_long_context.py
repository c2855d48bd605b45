"""long_500k on the CPU: a decode at batch 1, 524,288 positions deep, for the
sub-quadratic archs (xLSTM-350M and Hymba-1.5B) at smoke size.

The cache is filled from a seed as it stands before position
``meta + 524,288 - 3``: xLSTM's GLA state and conv tail; Hymba's too, with
its ring (8 sink slots and the 32-slot window of the smoke config) holding
the sink and the last 32 positions before that one.  Three decode steps
follow, at positions meta + 524,288 - 3 ... - 1, where Hymba's RoPE angles
reach 5.2e5 rad and the ring's slot arithmetic wraps far from its start.

- The port's ``make_serve_steps`` decode against the JAX one at the same
  ``pos0``, on the same weights (``lm_params_from_arrays``) and the same
  cache, in f32: logits within 1e-3 of max |logit| (PERF.md section 2).
- The long_500k cell through ``launch.cells.input_specs`` as DTensors on
  a one-rank gloo mesh against plain tensors, bit for bit (the script of
  ``test_torch_family_cells.py``).
- The dry run's ``--layers`` flag: a cut cell records the depth it traced,
  and without the flag the config's.
"""
import dataclasses
import functools
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("xlstm-350m", "hymba-1.5b")
DEPTH = 524_288                 # long_500k's positions
STEPS = 3
REL = 1e-3                      # of max |logit|


def _family_cells():
    spec = importlib.util.spec_from_file_location(
        "family_cells", ROOT / "tests" / "test_torch_family_cells.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _filled_cache(cfg, first: int, rng) -> list:
    """Per-layer numpy leaves of a batch-1 cache before position
    ``first``, in the port's layout."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.attention import _slot
    import torch
    out = []
    for c in tf.init_cache(cfg, 1, cfg.meta_tokens + DEPTH, "cpu"):
        layer = {}
        if "attn" in c:
            sink = cfg.meta_tokens
            ring = c["attn"]["k"].shape[1] - sink
            pos = torch.cat([torch.arange(min(sink, first)),
                             torch.arange(max(sink, first - ring), first)])
            kpos = np.full(c["attn"]["kpos"].shape, -1, np.int32)
            kpos[_slot(pos, sink, ring).numpy()] = pos.numpy()
            layer["attn"] = {
                "k": rng.standard_normal(c["attn"]["k"].shape).astype(
                    np.float32),
                "v": rng.standard_normal(c["attn"]["v"].shape).astype(
                    np.float32),
                "kpos": kpos}
        if "ssm" in c:
            layer["ssm"] = {k: rng.standard_normal(t.shape).astype(
                np.float32) for k, t in c["ssm"].items()}
        out.append(layer)
    return out


@functools.lru_cache(maxsize=None)
def _decodes(arch):
    """(port logits, JAX logits) of the three decode steps, and the
    positions they ran at."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import registry as jregistry
    from repro.models import transformer as jtf
    from repro.training.train_loop import make_serve_steps as jmake
    from repro_torch.configs import registry
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.training.train_loop import make_serve_steps
    jcfg = dataclasses.replace(jregistry.smoke(arch), dtype="float32",
                               use_kernel=True)
    jparams = jtf.init_params(jax.random.key(41), jcfg)
    cfg = dataclasses.replace(registry.smoke(arch), dtype="float32")
    params = lm_params_from_arrays(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    first = cfg.meta_tokens + DEPTH - STEPS
    rng = np.random.default_rng(41)
    layers = _filled_cache(cfg, first, rng)
    toks = rng.integers(0, cfg.vocab, (STEPS, 1, 1)).astype(np.int32)
    cache = [{g: {k: torch.from_numpy(v.copy()) for k, v in d.items()}
              for g, d in layer.items()} for layer in layers]
    jcache = {g: {k: jnp.stack([jnp.asarray(x[g][k]) for x in layers])
                  for k in layers[0][g]} for g in layers[0]}
    _, decode = make_serve_steps(cfg)
    _, jdecode = jmake(jcfg)
    jdec = jax.jit(lambda c, t, p: jdecode(jparams, c, tokens=t, pos0=p))
    got, want = [], []
    for i in range(STEPS):
        lg, cache = decode(params, cache, tokens=torch.from_numpy(toks[i]),
                           pos0=torch.tensor(first + i, dtype=torch.int32))
        got.append(lg.numpy())
        jl, jcache = jdec(jcache, jnp.asarray(toks[i]),
                          jnp.int32(first + i))
        want.append(np.asarray(jl))
    return got, want, [first + i for i in range(STEPS)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("step", range(STEPS))
def test_long_500k_decode_matches_jax(arch, step):
    got, want, positions = _decodes(arch)
    assert positions[-1] == positions[0] + STEPS - 1
    assert positions[-1] + 1 - DEPTH in (0, 8)       # the meta tokens
    g, w = got[step], want[step]
    assert g.shape == w.shape and np.isfinite(g).all()
    rel = np.abs(g - w).max() / np.abs(w).max()
    assert rel <= REL, (arch, step, rel)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    return _family_cells().run_cells(tmp_path_factory.mktemp("pg"), ARCHS,
                                     ("long_500k",), {},
                                     decode_steps=STEPS)


@pytest.mark.parametrize("arch", ARCHS)
def test_long_500k_cell_as_dtensors_equals_plain_tensors(cells, arch):
    rec = cells[(arch, "long_500k")]
    assert rec["batch"] == 1, rec
    assert rec["first"] == {"xlstm-350m": 0, "hymba-1.5b": 8}[arch] \
        + DEPTH - STEPS, rec
    assert rec["finite"], rec
    assert rec["equal"], rec


def _dryrun(out_dir, *extra) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xlstm-350m", "--shape", "decode_32k", "--mesh", "local",
         "--global-batch", "1", "--out-dir", str(out_dir), *extra],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return json.loads((out_dir / "xlstm-350m@decode_32k@local.json")
                      .read_text())


def test_dryrun_layers_flag(tmp_path):
    """``--layers`` cuts the depth the dry run traces and records it; the
    default records the config's depth (24) and traces more work."""
    full = _dryrun(tmp_path / "full")
    cut = _dryrun(tmp_path / "cut", "--layers", "2")
    assert full["ok"] and cut["ok"]
    assert (full["n_layers"], cut["n_layers"]) == (24, 2)
    assert cut["cost"]["flops"] < full["cost"]["flops"]
    assert cut["memory"]["argument_bytes"] < full["memory"]["argument_bytes"]
