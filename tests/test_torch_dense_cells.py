"""The ``dense`` family's launch cells as DTensors, bit for bit against plain
tensors, and StarCoder2's windowed ring against the JAX model, on the CPU.

DeepSeek-Coder-33B (SwiGLU, 56 q / 8 KV heads at full width), Minitron-8B
(squared-ReLU MLP, a 256,000-entry vocab at full width) and StarCoder2-15B
(plain GELU MLP, a 4,096 window with no sink) at smoke size: each of
train_4k, prefill_32k and decode_32k through ``launch.cells.input_specs``
on ``make_local_mesh`` as DTensors over a one-rank gloo ``DeviceMesh``,
against the same steps on plain tensors from the same seed (the script of
``test_torch_family_cells.py``).  The cells' sequences are cut so that the
CPU runs them in seconds; StarCoder2's smoke window is 32, so its prefill
(77 tokens) and its decode cache (70 positions in a 32-slot ring) wrap.

StarCoder2's smoke model against the JAX model in f32 on the same weights:
a prefill of 2 x window + 7 tokens, then three decode steps that write
over the ring's oldest slots, each step's logits within ``rtol=1e-5`` and
the ring's slot positions equal.  DeepSeek's decode_32k again over an fp8
KV cache, DTensors against plain tensors.
"""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("deepseek-coder-33b", "minitron-8b", "starcoder2-15b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
TOL = dict(rtol=1e-5, atol=1e-5)


def _family_cells():
    # the cells' script is ``test_torch_family_cells.py``'s
    spec = importlib.util.spec_from_file_location(
        "family_cells", ROOT / "tests" / "test_torch_family_cells.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cells = _family_cells()
    return cells.run_cells(tmp_path_factory.mktemp("pg"), ARCHS, SHAPES,
                           cells.SEQ)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_dense_cell_as_dtensors_equals_plain_tensors(results, arch, shape):
    rec = results[(arch, shape)]
    assert rec["finite"], rec
    assert rec["equal"], rec
    if shape == "train_4k":
        assert rec["losses"][1] < rec["losses"][0], rec


def test_fp8_kv_decode_as_dtensors_equals_plain_tensors(tmp_path):
    """DeepSeek's decode_32k over an fp8 e4m3 KV cache (``kv_dtype="f8"``):
    the DTensor steps write and read the fp8 ring as the plain steps do."""
    cells = _family_cells()
    rec = cells.run_cells(tmp_path, ("deepseek-coder-33b",), ("decode_32k",),
                          cells.SEQ, kv_dtype="f8")[
        ("deepseek-coder-33b", "decode_32k")]
    assert rec["finite"], rec
    assert rec["equal"], rec


def test_starcoder2_window_ring_past_its_length_matches_jax():
    """Prefill 2 x window + 7 tokens into a ``window``-slot ring (no sink),
    then three decode steps, through the port and the JAX model (its kernel
    route, Pallas in interpret mode) on the same f32 weights."""
    from repro.configs import registry as jregistry
    from repro.models import transformer as jtf
    from repro_torch.configs import registry
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.models import transformer as tf
    arch, steps = "starcoder2-15b", 3
    cfg = dataclasses.replace(registry.smoke(arch), dtype="float32")
    jcfg = dataclasses.replace(jregistry.smoke(arch), dtype="float32",
                               use_kernel=True)
    w = cfg.sliding_window
    assert (w, cfg.meta_tokens) == (32, 0)
    s = 2 * w + 7
    jparams = jtf.init_params(jax.random.key(29), jcfg)
    params = lm_params_from_arrays(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    toks = np.random.default_rng(29).integers(0, cfg.vocab, (2, s + steps))
    t, jt = torch.from_numpy(toks), jnp.asarray(toks, jnp.int32)
    cache = tf.init_cache(cfg, 2, s + steps, device="cpu")
    jcache = jtf.init_cache(jcfg, 2, s + steps)
    assert cache[0]["attn"]["k"].shape[1] == w
    got, cache, _ = tf.forward(params, cfg, tokens=t[:, :s], cache=cache,
                               mode="prefill")
    want, jcache, _ = jtf.forward(jparams, jcfg, tokens=jt[:, :s],
                                  cache=jcache, mode="prefill")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i in range(s, s + steps):
        got, cache, _ = tf.forward(params, cfg, tokens=t[:, i:i + 1],
                                   cache=cache, pos0=i, mode="decode")
        want, jcache, _ = jtf.forward(jparams, jcfg, tokens=jt[:, i:i + 1],
                                      cache=jcache, pos0=i, mode="decode")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for li, c in enumerate(cache):
            np.testing.assert_array_equal(
                c["attn"]["kpos"].numpy(),
                np.asarray(jcache["attn"]["kpos"][li]))
            for k in ("k", "v"):
                np.testing.assert_allclose(
                    c["attn"][k].numpy(),
                    np.asarray(jcache["attn"][k][li]), **TOL)
    # the ring holds the last ``w`` positions, the oldest overwritten
    assert sorted(cache[0]["attn"]["kpos"].tolist()) == list(
        range(s + steps - w, s + steps))
