"""The port's example modules (``repro_torch.examples``) against the JAX
package's example scripts (``examples/*.py``), on the CPU at small cuts.

Each case hands both packages the same inputs and runs the calls the
script makes:

* quickstart: JAX's synthetic trace (1,500 requests) through the three
  policies and the Erlang-ranked row, counters exactly and latency to
  rtol 1e-5; the analytic moments and the latency-law table to rtol 1e-5;
  the Monte-Carlo moments within 4 standard errors of Theorem 2 at
  n = 20,000;
* trace_sim: the port's wiki2018 surrogate (1,500 requests) through JAX's
  ``simulate`` for each of the 7 policies, counters exactly, latency to
  rtol 1e-5 and the improvement over LRU equal;
* hierarchy_sim: JAX's hierarchy trace (1,200 requests) through the three
  ``simulate_hier`` runs and the 2 x 4 L2 grid, same contract;
* serve_engine: the smoke model on JAX's weights gives every request
  JAX's greedy tokens; the A/B (2,000 requests) gives every
  ``EngineStats`` field equal to JAX's;
* train_small: lm-100m cut to 2 layers of d 64 over a 256-token vocab,
  4 steps of seq 16 and batch 4 on JAX's weights and batches: the loss
  history within ``tests/test_torch_training.py``'s forward tolerance of
  JAX's ``Trainer``, and a run preempted at step 2 resumes to the same
  history bit for bit;
* flags: each module takes its script's flags with the same defaults,
  plus ``--device``; without it and with no card each module raises.
"""
import argparse
import dataclasses
import functools
import importlib.util
import os
import pathlib
import signal

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import Erlang as JErlang
from repro.core import Exponential as JExponential
from repro.core import Hyperexponential as JHyperexponential
from repro.core import PolicyParams as JPolicyParams
from repro.core import make_hier_trace as jmake_hier_trace
from repro.core import simulate as jsimulate
from repro.core import simulate_hier as jsimulate_hier
from repro.core import stoch_mean as jstoch_mean
from repro.core import stoch_var as jstoch_var
from repro.core import sweep_hier_grid as jsweep_hier_grid
from repro.core.trace import Trace as JTrace
from repro.configs import registry as jregistry
from repro.data.tokens import DataConfig as JDataConfig
from repro.data.tokens import batch_at as jbatch_at
from repro.data.traces import SyntheticSpec
from repro.data.traces import synthetic_trace as jsynthetic_trace
from repro.models import transformer as jtf
from repro.serving import engine as je
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig
from repro.training.optimizer import OptConfig as JOptConfig
from repro.training.train_loop import TrainConfig as JTrainConfig
from repro.training.train_loop import make_serve_steps as jmake_serve_steps
from repro.training.train_loop import make_train_step as jmake_train_step
from repro.training.trainer import RunConfig as JRunConfig
from repro.training.trainer import Trainer as JTrainer
from repro_torch.configs import registry
from repro_torch.convert import (hier_trace_from_arrays,
                                 lm_params_from_arrays, trace_from_arrays)
from repro_torch.data.traces import surrogate_trace
from repro_torch.examples import (hierarchy_sim, quickstart, serve_engine,
                                  trace_sim, train_small)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-5
FWD = dict(rtol=1e-5, atol=1e-5)     # tests/test_torch_training.py's
COUNTERS = ("n_hits", "n_delayed", "n_misses", "n_evictions")
MODULES = {"quickstart": quickstart, "trace_sim": trace_sim,
           "hierarchy_sim": hierarchy_sim, "serve_engine": serve_engine,
           "train_small": train_small}


def _assert_sim(got: dict, want, msg=""):
    """A port result row against a JAX ``SimResult``."""
    for f in COUNTERS:
        assert got[f] == int(getattr(want, f)), (msg, f)
    np.testing.assert_allclose(got["total_latency"],
                               float(want.total_latency), rtol=RTOL,
                               err_msg=msg)


# --- quickstart --------------------------------------------------------------
QS_SPEC = SyntheticSpec(n_objects=100, n_requests=1500, rate=2000.0,
                        latency_base=0.005, latency_per_mb=2e-4,
                        stochastic=True)
N_MC = 20_000


@functools.lru_cache(maxsize=None)
def _qs_jtrace():
    return jsynthetic_trace(jax.random.key(1), QS_SPEC)


@functools.lru_cache(maxsize=None)
def _qs_port():
    pt = trace_from_arrays(*(np.asarray(x) for x in _qs_jtrace()),
                           device="cpu")
    return quickstart.run(device="cpu", n_mc=N_MC, trace=pt)


@pytest.mark.parametrize("policy", quickstart.POLICIES)
def test_quickstart_simulator_matches_jax(policy):
    want = jsimulate(_qs_jtrace(), quickstart.CAPACITY, policy,
                     JPolicyParams(omega=1.0))
    _assert_sim(_qs_port()["sim"][policy], want, policy)
    assert _qs_port()["sim"][policy]["route"] == (
        "plain ranking" if policy == "stoch_vacdh" else "epilogue")


def test_quickstart_erlang_row_matches_jax_through_the_epilogue():
    want = jsimulate(_qs_jtrace(), quickstart.CAPACITY, "stoch_vacdh",
                     JPolicyParams(omega=1.0, dist=JErlang(k=3.0)))
    got = _qs_port()["erlang"]
    _assert_sim(got, want, "erlang")
    assert got["route"] == "epilogue"


def test_quickstart_moments_and_law_table_match_jax():
    lam, z = quickstart.LAM, quickstart.Z
    t2 = _qs_port()["theorem2"]
    np.testing.assert_allclose(t2["mean"], float(jstoch_mean(lam, z)),
                               rtol=RTOL)
    np.testing.assert_allclose(t2["var"], float(jstoch_var(lam, z)),
                               rtol=RTOL)
    laws = (JExponential(), JErlang(k=3.0),
            JHyperexponential(p=0.9, mu_fast=0.3))
    got = _qs_port()["laws"]
    assert [d["name"] for d in got] == [d.name for d in laws]
    for g, d in zip(got, laws):
        np.testing.assert_allclose(g["agg_mean"], float(d.agg_mean(lam, z)),
                                   rtol=RTOL, err_msg=d.name)
        np.testing.assert_allclose(g["agg_var"], float(d.agg_var(lam, z)),
                                   rtol=RTOL, err_msg=d.name)


def test_quickstart_monte_carlo_within_four_standard_errors():
    """The draws cannot repeat ``jax.random``'s, so the Monte-Carlo
    moments are held statistically: each within 4 standard errors of
    Theorem 2, the errors estimated from the run's own draws."""
    from repro_torch.core.delay_stats import mc_aggregate_delay
    t2 = _qs_port()["theorem2"]
    d = mc_aggregate_delay(torch.Generator().manual_seed(0), quickstart.LAM,
                           quickstart.Z, N_MC).numpy()
    assert d.mean() == pytest.approx(t2["mean_mc"], rel=1e-12)
    se_mean = np.sqrt(d.var() / N_MC)
    mu4 = np.mean((d - d.mean()) ** 4)
    se_var = np.sqrt((mu4 - d.var() ** 2) / N_MC)
    assert abs(t2["mean_mc"] - t2["mean"]) <= 4 * se_mean
    assert abs(t2["var_mc"] - t2["var"]) <= 4 * se_var


# --- trace_sim ---------------------------------------------------------------
TS_REQUESTS = 1500
TS_POLICIES = trace_sim.DEFAULT_POLICIES.split(",")


@functools.lru_cache(maxsize=None)
def _ts_trace():
    return surrogate_trace("wiki2018", n_requests=TS_REQUESTS, device="cpu")


@functools.lru_cache(maxsize=None)
def _ts_port():
    return trace_sim.run(device="cpu", trace=_ts_trace())


@functools.lru_cache(maxsize=None)
def _ts_jax(policy):
    t = _ts_trace()
    jt = JTrace(*(jax.numpy.asarray(getattr(t, f).numpy()) for f in
                  ("times", "objs", "sizes", "z_mean", "z_draw")))
    cap = 0.1 * float(np.asarray(jt.sizes).sum())     # the script's
    return cap, jsimulate(jt, cap, policy,
                          JPolicyParams(omega=1.0, resid="recency"),
                          estimate_z=True)


@pytest.mark.parametrize("policy", TS_POLICIES)
def test_trace_sim_on_the_ports_surrogate_matches_jax(policy):
    out = _ts_port()
    cap, want = _ts_jax(policy)
    assert out["capacity"] == cap
    assert (out["n_requests"], out["n_objects"]) == (TS_REQUESTS, 2000)
    got = out["policies"][policy]
    _assert_sim(got, want, policy)
    lru = float(_ts_jax("lru")[1].total_latency)
    lat = float(want.total_latency)
    assert got["improvement"] == pytest.approx((lru - lat) / lru,
                                               abs=2 * RTOL)


# --- hierarchy_sim -----------------------------------------------------------
HS_SPEC = SyntheticSpec(n_objects=120, n_requests=1200, rate=2000.0,
                        latency_base=0.02, latency_per_mb=2e-4,
                        stochastic=True)


@functools.lru_cache(maxsize=None)
def _hs_jtrace():
    base = jsynthetic_trace(jax.random.key(0), HS_SPEC)
    return jmake_hier_trace(base, 4, hop_mean=0.01, hop_dist=JErlang(k=4.0),
                            route="random", key=jax.random.key(7))


@functools.lru_cache(maxsize=None)
def _hs_port():
    pt = hier_trace_from_arrays(*(np.asarray(x) for x in _hs_jtrace()),
                                device="cpu")
    return hierarchy_sim.run(device="cpu", trace=pt)


def _assert_hier(got, want, msg):
    for tier in ("per_shard", "l2"):
        g, w = getattr(got, tier), getattr(want, tier)
        for f in COUNTERS:
            np.testing.assert_array_equal(
                getattr(g, f).numpy().astype(np.int64),
                np.asarray(getattr(w, f)).astype(np.int64),
                err_msg=f"{msg} {tier} {f}")
        np.testing.assert_allclose(g.total_latency.numpy(),
                                   np.asarray(w.total_latency), rtol=RTOL,
                                   err_msg=f"{msg} {tier}")


@pytest.mark.parametrize("policy", hierarchy_sim.POLICIES)
def test_hierarchy_sim_single_runs_match_jax(policy):
    want = jsimulate_hier(_hs_jtrace(), 4, 400.0, 2000.0, policy,
                          l2_policy="lru")
    got = _hs_port()["single"][policy]
    _assert_hier(got["result"], want, policy)
    assert got["l2_hits"] == int(want.l2.n_hits)
    assert got["l2_delayed"] == int(want.l2.n_delayed)


def test_hierarchy_sim_l2_grid_matches_jax():
    g = jsweep_hier_grid(_hs_jtrace(), 4, 400.0,
                         list(hierarchy_sim.L2_GRID), ["lru", "stoch_vacdh"],
                         JPolicyParams(omega=1.0))
    port = _hs_port()["sweep"]
    assert port.result.total_latency.shape == \
        tuple(np.asarray(g.result.total_latency).shape) == (1, 2, 1, 1, 4, 1)
    _assert_hier(port.result, g.result, "grid")
    tot = np.asarray(g.result.total_latency)
    for c2i, row in enumerate(_hs_port()["grid"]):
        lru, ours = float(tot[0, 0, 0, 0, c2i, 0]), float(tot[0, 1, 0, 0,
                                                               c2i, 0])
        assert row["improvement"] == pytest.approx((lru - ours) / lru,
                                                   abs=2 * RTOL)


# --- serve_engine ------------------------------------------------------------
AB_REQUESTS = 2000


def test_serve_engine_real_model_tokens_equal_jax():
    """The JAX script's demo on f32 smoke weights (its XLA route, jitted
    steps) and the port's on the same weights: every request's greedy
    tokens."""
    jcfg = dataclasses.replace(jregistry.smoke(serve_engine.ARCH),
                               dtype="float32")
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    prefill, decode = jmake_serve_steps(jcfg)
    batcher = JBatcher(
        JSchedulerConfig(max_batch=4),
        prefill_step=jax.jit(lambda c, b: prefill(jparams, c, b)),
        decode_step=jax.jit(lambda c, t, p: decode(jparams, c, tokens=t,
                                                   pos0=p)),
        init_cache=lambda b, cap: jtf.init_cache(jcfg, b, cap))
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(8):
        toks = rng.integers(0, jcfg.vocab, rng.integers(4, 12))
        reqs.append(JRequest(rid=i, tokens=toks, max_new=8))
        batcher.submit(reqs[-1])
    assert batcher.drain() == 8

    cfg = dataclasses.replace(registry.smoke(serve_engine.ARCH),
                              dtype="float32")
    params = lm_params_from_arrays(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    got = serve_engine.real_model_demo(device="cpu", params=params,
                                       dtype="float32")
    assert got["done"] == 8 and got["tokens"] == 64
    for g, w in zip(got["prompts"], reqs):
        np.testing.assert_array_equal(g, w.tokens)
    assert got["outputs"] == [list(r.out) for r in reqs]


@functools.lru_cache(maxsize=None)
def _ab_port():
    return serve_engine.policy_ab_demo(device="cpu", n_requests=AB_REQUESTS)


@pytest.mark.parametrize("policy", serve_engine.AB_POLICIES)
def test_serve_engine_policy_ab_matches_jax(policy):
    times, keys, lens = serve_engine.ab_trace(AB_REQUESTS)
    eng = je.ServeEngine(capacity=60_000.0, policy=policy,
                         latency=je.LatencyModel(base_s=0.03,
                                                 per_token_s=2e-5),
                         state_size_fn=lambda n: float(n), seed=7)
    want = eng.run_trace(times, keys, lens).as_dict()
    assert _ab_port()[policy] == want


# --- train_small -------------------------------------------------------------
TRAIN_MODEL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=128, vocab=256, dtype="float32")
TRAIN = dict(steps=4, seq=16, batch=4)


def _jax_train(ckpt_dir):
    """JAX's ``Trainer`` as the script builds it, at the cut; returns its
    initial weights (numpy) and its loss history."""
    jcfg = JModelConfig(name="lm-100m", family="dense", mlp_act="swiglu",
                        remat="none", **TRAIN_MODEL)
    tcfg = JTrainConfig(microbatches=2, opt=JOptConfig(
        lr=3e-4, warmup_steps=20, total_steps=TRAIN["steps"]))
    dcfg = JDataConfig(vocab=jcfg.vocab, seq_len=TRAIN["seq"],
                       global_batch=TRAIN["batch"])
    rcfg = JRunConfig(steps=TRAIN["steps"], ckpt_every=2, log_every=1,
                      ckpt_dir=str(ckpt_dir))
    t = JTrainer(jcfg, tcfg, dcfg, rcfg, log_fn=lambda s: None)
    # in f32 ``init_opt``'s master copy is the params' own buffer, which
    # the Trainer's step would donate twice: run its step undonated
    t.step_fn = jax.jit(jmake_train_step(jcfg, tcfg))
    p0 = jax.tree.map(np.array, t.params)
    out = t.run()
    return p0, dcfg, [h["loss"] for h in out["history"]]


def _port_train(ckpt_dir, p0, dcfg, log_fn=lambda s: None):
    cfg = train_small.model_config(**TRAIN_MODEL)

    def batch_fn(step):
        b = jbatch_at(dcfg, step)
        return {k: torch.from_numpy(np.asarray(
            v, np.int64 if np.asarray(v).dtype.kind == "i" else None))
            for k, v in b.items()}

    return train_small.run(
        device="cpu", ckpt_dir=str(ckpt_dir), ckpt_every=2, log_every=1,
        params=lm_params_from_arrays(p0, cfg, device="cpu"),
        batch_fn=batch_fn, log_fn=log_fn, **TRAIN, **TRAIN_MODEL)


def test_train_small_loss_history_matches_jax_and_resumes(tmp_path):
    p0, dcfg, want = _jax_train(tmp_path / "jax")
    full = _port_train(tmp_path / "port", p0, dcfg)
    got = [h["loss"] for h in full["history"]]
    assert full["final_step"] == 4 and len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, **FWD)

    def preempt(msg):
        if msg.startswith("[trainer] step 2:"):
            os.kill(os.getpid(), signal.SIGTERM)

    old = signal.getsignal(signal.SIGTERM)
    try:
        first = _port_train(tmp_path / "resumed", p0, dcfg, log_fn=preempt)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert first["preempted"] and first["final_step"] == 2
    rest = _port_train(tmp_path / "resumed", p0, dcfg)
    assert rest["start_step"] == 2 and rest["final_step"] == 4
    assert [h["loss"] for h in first["history"] + rest["history"]] == got


# --- flags -------------------------------------------------------------------
def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Parsed(Exception):
    pass


def _script_parser(mod, monkeypatch):
    """The parser the script's ``main`` builds (None if it takes no
    flags), caught at its ``parse_args``."""
    if not hasattr(mod, "argparse"):
        return None

    def catch(self, *a, **k):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed) as e:
        mod.main()
    monkeypatch.undo()
    return e.value.args[0]


def _flags(ap):
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     None if a.choices is None else list(a.choices))
            for a in ap._actions if a.dest != "help"}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_modules_take_the_scripts_flags_plus_device(name, monkeypatch):
    script = _script_parser(_script(name), monkeypatch)
    want = {} if script is None else _flags(script)
    got = _flags(MODULES[name].parser())
    assert got.pop("device") == (("--device",), None, None, None)
    if name == "train_small":
        # the port's own directory: it never resumes the JAX script's run
        assert want.pop("ckpt_dir")[1] == "/tmp/repro_train_small"
        assert got.pop("ckpt_dir")[1] == train_small.CKPT_DIR
    assert got == want


@pytest.mark.parametrize("name", sorted(MODULES))
def test_modules_need_a_card_by_default(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: no --device runs there")
    argv = ["--ckpt-dir", str(tmp_path)] if name == "train_small" else []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MODULES[name].main(argv)
