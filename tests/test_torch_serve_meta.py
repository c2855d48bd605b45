"""Hymba through the port's ``serve()`` against the JAX model, on the CPU.

``serve()`` runs a hybrid model behind the batcher with its position
offset set to the meta tokens: caches of ``meta + prompt + max_new + 1``
positions, decode at ``pos0 = meta + S + i``.  The JAX batcher has no
offset (its serve script decodes Hymba at the wrong positions), so the
reference is the JAX *model* on the same weights (smoke Hymba in f32,
converted with ``lm_params_from_arrays``): its ``forward`` recomputed on
the growing sequence for the greedy tokens, and its serve steps
(``make_serve_steps``, kernel route in interpret mode) at
``pos0 = meta + S + i``, fed the port's tokens, for the logits (within
1e-3 of max |logit|).  The prompts run past the smoke config's 32-slot
window, so ``meta + prompt`` wraps the ring in the prefill and the
decodes wrap it again.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import transformer as jtf
from repro.training.train_loop import make_serve_steps as jmake_serve_steps
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch import serve as serve_cli
from repro_torch.serving.scheduler import (ContinuousBatcher, Request,
                                           SchedulerConfig)

ARCH = "hymba-1.5b"
MAX_NEW = 6
LENGTHS = (5, 30, 41, 70)       # the smoke window is 32 (meta 8)
REL = 1e-3                      # of max |logit|


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = dataclasses.replace(jregistry.smoke(ARCH), dtype="float32",
                               use_kernel=True)
    jparams = jtf.init_params(jax.random.key(27), jcfg)
    cfg = dataclasses.replace(registry.smoke(ARCH), dtype="float32")
    params = lm_params_from_arrays(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    rng = np.random.default_rng(27)
    prompts = [rng.integers(0, cfg.vocab, n) for n in LENGTHS]
    return jcfg, jparams, cfg, params, prompts


@functools.lru_cache(maxsize=None)
def _port_serve():
    """The port's ``serve()`` on the smoke prompts, with every step's
    ``pos0``, fed token and logits recorded by prompt (the prefill first,
    with its cache's slot count)."""
    jcfg, jparams, cfg, params, prompts = _models()
    record, owner = {}, {}
    real = serve_cli.make_serve_steps

    def recording(c):
        prefill, decode = real(c)

        def pre(p, cache, batch):
            key = tuple(batch["tokens"][0].tolist())
            # a request's KV tensors are updated in place: they name it
            owner[id(cache[0]["attn"]["k"])] = key
            logits, cache = prefill(p, cache, batch)
            record[key] = [(None, cache[0]["attn"]["k"].shape[1],
                            logits[0, -1].clone())]
            return logits, cache

        def dec(p, cache, tokens, pos0):
            key = owner[id(cache[0]["attn"]["k"])]
            logits, cache = decode(p, cache, tokens=tokens, pos0=pos0)
            record[key].append((int(pos0), int(tokens[0, 0]),
                                logits[0, -1].clone()))
            return logits, cache
        return pre, dec

    mp = pytest.MonkeyPatch()
    mp.setattr(serve_cli, "make_serve_steps", recording)
    try:
        out = serve_cli.serve(cfg, params, prompts, MAX_NEW, device="cpu")
    finally:
        mp.undo()
    return out, record


def _jax_greedy(jcfg, jparams, prompt, n):
    """n greedy tokens of JAX's full ``forward`` recomputed on the growing
    sequence (train mode: logits at every text position)."""
    toks = list(int(t) for t in prompt)
    fwd = jax.jit(lambda t: jtf.forward(jparams, jcfg, tokens=t,
                                        mode="train")[0])
    out = []
    for _ in range(n):
        logits = fwd(jnp.asarray([toks], jnp.int32))
        out.append(int(jnp.argmax(logits[0, -1])))
        toks.append(out[-1])
    return out


def test_serve_hymba_greedy_tokens_equal_jax_forward():
    jcfg, jparams, cfg, params, prompts = _models()
    out, _ = _port_serve()
    assert out["done"] == len(prompts)
    for prompt, req in zip(prompts, out["requests"]):
        assert req.done and len(req.out) == MAX_NEW
        assert req.out == _jax_greedy(jcfg, jparams, prompt, MAX_NEW), \
            len(prompt)


@pytest.mark.parametrize("length", LENGTHS)
def test_serve_hymba_logits_match_jax_serve_steps(length):
    """Prefill and every decode of the port's ``serve()`` within 1e-3 of
    max |logit| of JAX's serve steps at ``pos0 = meta + S + i``, fed the
    same tokens; the port's caches hold meta + S + max_new + 1 positions
    (cut to meta + window)."""
    jcfg, jparams, cfg, params, prompts = _models()
    _, record = _port_serve()
    prompt = prompts[LENGTHS.index(length)]
    steps = record[tuple(prompt.tolist())]
    m, s = cfg.meta_tokens, len(prompt)
    assert len(steps) == MAX_NEW        # the prefill and MAX_NEW - 1 decodes
    assert steps[0][1] == min(m + s + MAX_NEW + 1, m + cfg.sliding_window)
    assert [p for p, _, _ in steps[1:]] == [m + s + i
                                            for i in range(MAX_NEW - 1)]
    prefill, decode = jmake_serve_steps(jcfg)
    jpre = jax.jit(functools.partial(prefill, jparams))
    jdec = jax.jit(lambda c, t, p: decode(jparams, c, tokens=t, pos0=p))
    cache = jtf.init_cache(jcfg, 1, m + s + MAX_NEW + 1)
    want, cache = jpre(cache, {"tokens": jnp.asarray(prompt[None],
                                                     jnp.int32)})
    rows = [(np.asarray(want[0, -1]), steps[0][2])]
    for pos0, tok, got in steps[1:]:
        want, cache = jdec(cache, jnp.asarray([[tok]], jnp.int32),
                           jnp.int32(pos0))
        rows.append((np.asarray(want[0, -1]), got))
    for i, (want, got) in enumerate(rows):
        rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert np.isfinite(got.numpy()).all()
        assert rel <= REL, (length, i, rel)


def test_serve_hymba_cli_on_cpu(capsys):
    r = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "3", "--max-new", "3"])
    assert r["done"] == 3 and r["decode_tokens"] == 6
    assert "[serve] hymba-1.5b-smoke on cpu: 3 requests" in \
        capsys.readouterr().out


@pytest.mark.parametrize("offset", [0, 8])
def test_batcher_position_offset(offset):
    """The cache capacity and every decode's ``pos0`` count the offset; at
    0 they are the JAX batcher's (prompt + max_new + 1, the prompt's
    length)."""
    caps, seen = [], []

    def prefill(cache, batch):
        out = torch.zeros((1, 1, 8))
        out[0, 0, 1] = 1.0
        return out, cache

    def decode(cache, tokens, pos0):
        seen.append(pos0)
        return prefill(cache, None)

    b = ContinuousBatcher(SchedulerConfig(max_batch=2), prefill_step=prefill,
                          decode_step=decode,
                          init_cache=lambda n, cap: caps.append(cap),
                          device="cpu", pos_offset=offset)
    b.submit(Request(rid=0, tokens=np.arange(5), max_new=4))
    assert b.drain() == 1
    assert caps == [offset + 5 + 4 + 1]
    assert seen == [offset + 5 + i for i in range(3)]
