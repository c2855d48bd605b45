"""The port's LM (dense-block, MoE, xLSTM and Hymba families) against the
JAX package's, on the CPU, in f32.

Both packages run the same weights: the JAX model's ``init_params`` pytree,
handed to the port through ``convert.lm_params_from_arrays``.  The JAX side
takes its kernel route (``use_kernel=True``: Pallas in interpret mode), the
port its plain attention and GLA versions.  Tolerance ``rtol=1e-5, atol=1e-5`` on
logits of magnitude ~1: the two differ only in the order of f32 sums.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig, SHAPES, shapes_for
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models import layers
from repro_torch.models import transformer as tf

DENSE = ["stablelm-1.6b", "minitron-8b", "starcoder2-15b",
         "deepseek-coder-33b", "llava-next-mistral-7b", "musicgen-large"]
RECURRENT = ["xlstm-350m", "hymba-1.5b"]
MOE = ["phi3.5-moe-42b-a6.6b", "grok-1-314b"]
PORTED = DENSE + MOE + RECURRENT
TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 17


def _f32(arch):
    return dataclasses.replace(registry.smoke(arch), dtype="float32")


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """Weights, inputs and the JAX logits of train, prefill and decode."""
    jcfg = dataclasses.replace(jregistry.smoke(arch), dtype="float32",
                               use_kernel=True)
    jparams = jtf.init_params(jax.random.key(11), jcfg)
    rng = np.random.default_rng(12)
    if jcfg.frontend == "none":
        inp = {"tokens": rng.integers(0, jcfg.vocab, (B, S + 1))}
        jin = {"tokens": jnp.asarray(inp["tokens"], jnp.int32)}
    else:
        inp = {"embeds": (rng.standard_normal((B, S + 1, jcfg.d_model))
                          * 0.02).astype(np.float32)}
        jin = {"embeds": jnp.asarray(inp["embeds"])}
    first = {k: v[:, :S] for k, v in jin.items()}
    last = {k: v[:, S:] for k, v in jin.items()}
    m = jcfg.meta_tokens        # decode counts them (forward's contract)
    train, _, aux = jtf.forward(jparams, jcfg, mode="train", **jin)
    cache = jtf.init_cache(jcfg, B, m + S + 1)
    pre, cache, _ = jtf.forward(jparams, jcfg, cache=cache, mode="prefill",
                                **first)
    dec, _, _ = jtf.forward(jparams, jcfg, cache=cache, pos0=m + S,
                            mode="decode", **last)
    tree = jax.tree.map(np.asarray, jparams)
    return tree, inp, {"train": np.asarray(train), "prefill": np.asarray(pre),
                       "decode": np.asarray(dec), "aux": float(aux)}


def _port_inputs(inp, sl):
    return {k: torch.from_numpy(np.ascontiguousarray(v[:, sl]))
            for k, v in inp.items()}


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_forward_matches_jax(arch, mode):
    tree, inp, want = _jax_run(arch)
    cfg = _f32(arch)
    m = cfg.meta_tokens
    params = lm_params_from_arrays(tree, cfg, device="cpu")
    if mode == "train":
        got, cache, aux = tf.forward(params, cfg, mode="train",
                                     **_port_inputs(inp, slice(None)))
        assert cache is None and aux.dtype == torch.float32
        np.testing.assert_allclose(float(aux), want["aux"], **TOL)
        assert (float(aux) > 0) == (cfg.family == "moe")
    else:
        cache = tf.init_cache(cfg, B, m + S + 1, device="cpu")
        got, cache, _ = tf.forward(params, cfg, cache=cache, mode="prefill",
                                   **_port_inputs(inp, slice(0, S)))
        if mode == "decode":
            got, _, _ = tf.forward(params, cfg, cache=cache, pos0=m + S,
                                   mode="decode",
                                   **_port_inputs(inp, slice(S, S + 1)))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want[mode].shape
    np.testing.assert_allclose(got.numpy(), want[mode], **TOL)


def _batch(cfg, rng, b, s):
    if cfg.frontend == "none":
        return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                        (b, s)))}
    return {"embeds": torch.from_numpy(
        (rng.standard_normal((b, s, cfg.d_model)) * 0.02).astype(np.float32))}


def _slice(batch, sl):
    return {k: v[:, sl] for k, v in batch.items()}


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_then_decode_matches_full_forward(arch):
    """Mirrors tests/test_models_smoke.py: decode of token s (at position
    meta + s) equals the full-sequence forward at s (here in f32, to
    1e-5)."""
    cfg = _f32(arch)
    params = tf.init_params(torch.Generator().manual_seed(3), cfg)
    b, s, m = 2, 16, cfg.meta_tokens
    batch = _batch(cfg, np.random.default_rng(4), b, s + 1)
    full, _, _ = tf.forward(params, cfg, mode="train", **batch)
    cache = tf.init_cache(cfg, b, m + s + 1, device="cpu")
    _, cache, _ = tf.forward(params, cfg, cache=cache, mode="prefill",
                             **_slice(batch, slice(0, s)))
    dec, _, _ = tf.forward(params, cfg, cache=cache, pos0=m + s,
                           mode="decode", **_slice(batch, slice(s, s + 1)))
    torch.testing.assert_close(dec[:, 0], full[:, s], **TOL)


def test_sliding_window_decode_ring_buffer():
    """Decode far past the window: the ring buffer keeps decode equal to a
    full forward restricted to the same window."""
    cfg = _f32("starcoder2-15b")
    assert cfg.sliding_window > 0
    total = cfg.sliding_window * 2 + 7
    params = tf.init_params(torch.Generator().manual_seed(5), cfg)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, total + 1)))
    full, _, _ = tf.forward(params, cfg, tokens=toks, mode="train")
    cache = tf.init_cache(cfg, 1, total + 1, device="cpu")
    assert cache[0]["attn"]["k"].shape[1] == cfg.sliding_window
    _, cache, _ = tf.forward(params, cfg, tokens=toks[:, :total],
                             cache=cache, mode="prefill")
    for t in range(total, total + 1):
        dec, cache, _ = tf.forward(params, cfg, tokens=toks[:, t:t + 1],
                                   cache=cache, pos0=t, mode="decode")
        torch.testing.assert_close(dec[:, 0], full[:, t], **TOL)


def test_hymba_ring_buffer_decode_past_window():
    """tests/test_models_smoke.py's ring-buffer case for Hymba: prefill
    past the sink + window ring, then decode steps that wrap it, each
    equal to the full forward (f32, to 1e-5)."""
    cfg = _f32("hymba-1.5b")
    m, w = cfg.meta_tokens, cfg.sliding_window
    s_text = cfg.sliding_window * 2 + 7
    steps = 3
    params = tf.init_params(torch.Generator().manual_seed(5), cfg)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, s_text + steps)))
    full, _, _ = tf.forward(params, cfg, tokens=toks, mode="train")
    cache = tf.init_cache(cfg, 1, m + s_text + steps, device="cpu")
    assert cache[0]["attn"]["k"].shape[1] == m + w
    _, cache, _ = tf.forward(params, cfg, tokens=toks[:, :s_text],
                             cache=cache, mode="prefill")
    for t in range(s_text, s_text + steps):
        dec, cache, _ = tf.forward(params, cfg, tokens=toks[:, t:t + 1],
                                   cache=cache, pos0=m + t, mode="decode")
        torch.testing.assert_close(dec[:, 0], full[:, t], **TOL)


def test_fp8_kv_cache_decode_close_to_bf16_and_to_jax():
    """fp8 e4m3 cache: decode logits stay close to the bf16-cache ones
    (the JAX test's bounds), and equal the JAX package's fp8 decode up to
    bf16 rounding."""
    cfg = registry.smoke("deepseek-coder-33b")
    jcfg = dataclasses.replace(jregistry.smoke("deepseek-coder-33b"),
                               use_kernel=True)
    jparams = jtf.init_params(jax.random.key(7), jcfg)
    params = lm_params_from_arrays(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    b, s = 1, 24
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (b, s + 1))
    outs, jouts = {}, {}
    for kvd in ("bf16", "f8"):
        c = dataclasses.replace(cfg, kv_dtype=kvd)
        cache = tf.init_cache(c, b, s + 1, device="cpu")
        assert cache[0]["attn"]["k"].dtype == c.kv_torch_dtype
        t = torch.from_numpy(toks)
        _, cache, _ = tf.forward(params, c, tokens=t[:, :s], cache=cache,
                                 mode="prefill")
        dec, _, _ = tf.forward(params, c, tokens=t[:, s:], cache=cache,
                               pos0=s, mode="decode")
        outs[kvd] = dec[:, 0].float().numpy()
        jc = dataclasses.replace(jcfg, kv_dtype=kvd)
        jcache = jtf.init_cache(jc, b, s + 1)
        jt = jnp.asarray(toks, jnp.int32)
        _, jcache, _ = jtf.forward(jparams, jc, tokens=jt[:, :s],
                                   cache=jcache, mode="prefill")
        jdec, _, _ = jtf.forward(jparams, jc, tokens=jt[:, s:], cache=jcache,
                                 pos0=s, mode="decode")
        jouts[kvd] = np.asarray(jdec[:, 0].astype(jnp.float32))
        np.testing.assert_allclose(outs[kvd], jouts[kvd], atol=5e-2)
    np.testing.assert_allclose(outs["f8"], outs["bf16"], atol=0.35, rtol=0.3)
    assert (np.argmax(outs["f8"], -1) == np.argmax(outs["bf16"], -1)).mean() \
        >= 0.99


@pytest.mark.parametrize("arch", PORTED)
def test_param_count_formula_matches_init(arch):
    cfg = registry.smoke(arch)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    assert tf.n_params(params) == cfg.n_params()


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_configs_equal_jax_configs(arch):
    """Same fields and values, full and smoke (dtype properties aside),
    but ``use_kernel``: the port has only the kernel route (and its plain
    oracle), so its default is True where the JAX default False picks the
    XLA route."""
    for mine, theirs in ((registry.get(arch), jregistry.get(arch)),
                         (registry.smoke(arch), jregistry.smoke(arch))):
        assert mine.use_kernel is True and theirs.use_kernel is False
        assert dataclasses.asdict(dataclasses.replace(
            mine, use_kernel=False)) == dataclasses.asdict(theirs)
        assert mine.n_params() == theirs.n_params()
        assert mine.n_active_params() == theirs.n_active_params()
    assert isinstance(registry.get(arch), ModelConfig)
    assert list(shapes_for(registry.get(arch))) == [
        s for s in SHAPES if s in shapes_for(registry.get(arch))]


def test_dtypes():
    cfg = registry.get("stablelm-1.6b")
    assert cfg.torch_dtype == torch.bfloat16
    assert cfg.kv_torch_dtype == torch.bfloat16
    assert dataclasses.replace(cfg, kv_dtype="f8").kv_torch_dtype == \
        torch.float8_e4m3fn
    assert _f32("stablelm-1.6b").torch_dtype == torch.float32


def test_unknown_family_raises():
    cfg = dataclasses.replace(registry.smoke("stablelm-1.6b"), family="rnn")
    with pytest.raises(ValueError, match="unknown family"):
        tf.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="unknown family"):
        tf.init_cache(cfg, 1, 8, device="cpu")


def _dtypes(tree):
    if isinstance(tree, dict):
        return {k: _dtypes(v) for k, v in tree.items()}
    return str(tree.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", RECURRENT + MOE + ["stablelm-1.6b"])
def test_bf16_leaf_dtypes_match_jax(arch):
    """In a bf16 model the leaves the JAX package keeps in f32 (mLSTM gate
    projection, Mamba step size, decay and skip, the hybrid mixing
    scalars, the MoE router) stay f32, both from the port's init and
    through the converter; every other leaf is bf16."""
    jcfg = jregistry.smoke(arch)
    jparams = jtf.init_params(jax.random.key(1), jcfg)
    want = {k: _dtypes(v) for k, v in jparams.items() if k != "layers"}
    want["layers"] = _dtypes(jparams["layers"])
    cfg = registry.smoke(arch)
    for params in (lm_params_from_arrays(jax.tree.map(np.asarray, jparams),
                                         cfg, device="cpu"),
                   tf.init_params(torch.Generator().manual_seed(1), cfg)):
        got = {k: _dtypes(v) for k, v in params.items() if k != "layers"}
        assert got == {k: v for k, v in want.items() if k != "layers"}
        for layer in params["layers"]:
            assert _dtypes(layer) == want["layers"]
    if cfg.family != "dense":
        assert "float32" in str(want["layers"])


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))
    got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32)
    pos = np.arange(100, 109, dtype=np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_matches_jax(act):
    rng = np.random.default_rng(2)
    d, f = 32, 48
    p = {k: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
         for k, s in (("w_up", (d, f)), ("w_down", (f, d)),
                      ("w_gate", (d, f)))}
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    want = jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), act)
    got = layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="unknown mlp act"):
        layers.mlp_apply(p, x, "tanh")
