"""The port's continuous batcher against the JAX package's, on the CPU.

Smoke StableLM in f32 with the same weights in both packages (the JAX side
on its kernel route, Pallas in interpret mode): the greedy tokens of every
request are equal.  The queue-full and eos cases mirror
tests/test_serving.py with stub steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import transformer as jtf
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig
from repro.training.train_loop import make_serve_steps as jmake_serve_steps
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as tf
from repro_torch.serving.scheduler import (ContinuousBatcher, Request,
                                           SchedulerConfig)
from repro_torch.training.train_loop import make_serve_steps

PROMPTS = [np.array([1, 2, 3, 4]), np.array([5, 6, 7]),
           np.array([9, 10, 11, 12, 13]), np.array([200, 3, 77, 8, 1, 9])]


def _jax_outputs(jcfg, jparams, max_new, max_batch):
    prefill, decode = jmake_serve_steps(jcfg)
    batcher = JBatcher(
        JSchedulerConfig(max_batch=max_batch),
        prefill_step=jax.jit(lambda c, b: prefill(jparams, c, b)),
        decode_step=jax.jit(lambda c, t, p: decode(jparams, c, tokens=t,
                                                   pos0=p)),
        init_cache=lambda b, cap: jtf.init_cache(jcfg, b, cap))
    reqs = [JRequest(rid=i, tokens=p, max_new=max_new)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        batcher.submit(r)
    assert batcher.drain() == len(PROMPTS)
    return [r.out for r in reqs]


def _port_batcher(cfg, params, max_batch):
    prefill, decode = make_serve_steps(cfg)
    return ContinuousBatcher(
        SchedulerConfig(max_batch=max_batch),
        prefill_step=lambda c, b: prefill(params, c, b),
        decode_step=lambda c, t, p: decode(params, c, tokens=t, pos0=p),
        init_cache=lambda b, cap: tf.init_cache(cfg, b, cap, "cpu"),
        device="cpu")


@pytest.mark.parametrize("max_batch", [1, 3])
def test_greedy_tokens_equal_jax(max_batch):
    _check_greedy_tokens_equal_jax("stablelm-1.6b", max_batch)


@pytest.mark.parametrize("max_batch", [1, 3])
def test_xlstm_greedy_tokens_equal_jax(max_batch):
    """xLSTM behind both batchers: the recurrent state and conv tail carry
    through decode (no attention, no meta tokens)."""
    _check_greedy_tokens_equal_jax("xlstm-350m", max_batch)


def _check_greedy_tokens_equal_jax(arch, max_batch):
    jcfg = dataclasses.replace(jregistry.smoke(arch), dtype="float32",
                               use_kernel=True)
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    want = _jax_outputs(jcfg, jparams, 5, max_batch)
    cfg = dataclasses.replace(registry.smoke(arch), dtype="float32")
    params = lm_params_from_arrays(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    batcher = _port_batcher(cfg, params, max_batch)
    reqs = [Request(rid=i, tokens=p, max_new=5)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        batcher.submit(r)
    assert batcher.drain() == len(PROMPTS)
    assert [r.out for r in reqs] == want
    assert all(r.done and len(r.out) == 5 for r in reqs)


def test_batcher_matches_single_forward():
    """The batcher's greedy tokens equal a greedy loop over full
    forwards (mirrors tests/test_serving.py)."""
    cfg = dataclasses.replace(registry.smoke("stablelm-1.6b"),
                              dtype="float32")
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    toks = list(PROMPTS[0])
    for _ in range(4):
        logits, _, _ = tf.forward(params, cfg, mode="train",
                                  tokens=torch.tensor([toks]))
        toks.append(int(torch.argmax(logits[0, -1])))
    batcher = _port_batcher(cfg, params, 4)
    reqs = [Request(rid=i, tokens=p, max_new=4)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        batcher.submit(r)
    assert batcher.drain() == len(PROMPTS)
    assert reqs[0].out == toks[len(PROMPTS[0]):]


def _stub_steps(next_token):
    """(prefill, decode) stubs emitting argmax == next_token(pos)."""
    def logits_for(tok):
        out = torch.zeros((1, 1, 8))
        out[0, 0, tok] = 1.0
        return out

    def prefill(cache, batch):
        return logits_for(next_token(0)), cache

    def decode(cache, tokens, pos0):
        return logits_for(next_token(pos0)), cache

    return prefill, decode


def test_continuous_batcher_queue_full_rejects():
    prefill, decode = _stub_steps(lambda pos: 1)
    b = ContinuousBatcher(SchedulerConfig(max_queue=2), prefill_step=prefill,
                          decode_step=decode, init_cache=lambda b_, cap: None,
                          device="cpu")
    b.submit(Request(rid=0, tokens=np.array([1]), max_new=2))
    b.submit(Request(rid=1, tokens=np.array([1]), max_new=2))
    with pytest.raises(RuntimeError, match="queue full"):
        b.submit(Request(rid=2, tokens=np.array([1]), max_new=2))


def test_continuous_batcher_eos_stops_decode_early():
    eos = 7
    prefill, decode = _stub_steps(lambda pos: eos if pos >= 2 else 3)
    b = ContinuousBatcher(SchedulerConfig(max_batch=2), prefill_step=prefill,
                          decode_step=decode, init_cache=lambda b_, cap: None,
                          eos_id=eos, device="cpu")
    r = Request(rid=0, tokens=np.array([1, 2]), max_new=10)
    b.submit(r)
    assert b.drain() == 1
    assert r.done
    assert r.out[-1] == eos
    assert len(r.out) < 10              # stopped well before max_new


def test_batcher_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs there")
    prefill, decode = _stub_steps(lambda pos: 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatcher(SchedulerConfig(), prefill_step=prefill,
                          decode_step=decode, init_cache=lambda b_, c: None)


def test_serve_cli_on_cpu(capsys):
    r = serve_cli.main(["--arch", "stablelm-1.6b", "--smoke", "--device",
                        "cpu", "--requests", "3", "--max-new", "3"])
    assert r["done"] == 3 and r["decode_tokens"] == 6
    assert all(len(q.out) == 3 for q in r["requests"])
    assert "[serve] stablelm-1.6b-smoke on cpu: 3 requests" in \
        capsys.readouterr().out


def test_serve_cli_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--arch", "stablelm-1.6b", "--smoke"])


def test_serve_cli_xlstm_on_cpu(capsys):
    r = serve_cli.main(["--arch", "xlstm-350m", "--smoke", "--device",
                        "cpu", "--requests", "3", "--max-new", "3"])
    assert r["done"] == 3 and r["decode_tokens"] == 6
    assert "[serve] xlstm-350m-smoke on cpu: 3 requests" in \
        capsys.readouterr().out


def test_serve_rejects_multi_head_outputs():
    cfg, params = serve_cli.build("musicgen-large", smoke=True, device="cpu")
    with pytest.raises(ValueError, match="codebook heads"):
        serve_cli.serve(cfg, params, [np.array([1, 2])], 2, device="cpu")
