"""The port's sweep_grid against the JAX package's on the same traces, and
against its own single-lane simulate.

Every point must match the JAX grid's counters exactly and its latency to
rtol=1e-5, and equal the port's single-lane ``simulate`` at the same
trace, policy, params, capacity and key bit for bit.  The JAX grid scores
multi-policy lanes by the policy's epilogue, so those grids run the port
with ``use_kernel=False`` against JAX, and with the default (the plain
eq.-16 versions on the CPU) against the port's own ``simulate``."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import Erlang as JErlang
from repro.core import PolicyParams as JPP
from repro.core import sweep_grid as jsweep_grid
from repro.data.traces import SyntheticSpec as JSpec
from repro.data.traces import synthetic_trace as jsynthetic_trace
from repro_torch.convert import trace_from_arrays
from repro_torch.core import (Erlang, Hyperexponential, PolicyParams,
                              simulate, sweep_grid)
from repro_torch.core.prng import key_data
from repro_torch.core.simulator import _Engine
from repro_torch.kernels.point_update import PointUpdate

RTOL = 1e-5
COUNTERS = ("n_hits", "n_delayed", "n_misses", "n_evictions")
SPEC = JSpec(n_objects=40, n_requests=1500, rate=600.0, size_min=1.0,
             size_max=20.0, latency_base=0.01, latency_per_mb=1e-3)


@functools.lru_cache(maxsize=None)
def _traces(seed=0, **kw):
    spec = dataclasses.replace(SPEC, **dict(kw)) if kw else SPEC
    jt = jsynthetic_trace(jax.random.key(seed), spec)
    return jt, trace_from_arrays(*(np.asarray(x) for x in jt), device="cpu")


def _assert_vs_jax(got, want, tag):
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{tag} {f}")
    np.testing.assert_allclose(got.total_latency.numpy(),
                               np.asarray(want.total_latency), rtol=RTOL,
                               err_msg=tag)


def _assert_vs_simulate(g, traces, names, params, caps, seeds, estimate_z,
                        use_kernel=None):
    for ti, tr in enumerate(traces):
        for li, pol in enumerate(names):
            for pi, p in enumerate(params):
                for ci, c in enumerate(caps):
                    for si, s in enumerate(seeds):
                        ref = simulate(tr, c, pol, p, key=key_data(s),
                                       estimate_z=estimate_z,
                                       use_kernel=use_kernel, device="cpu")
                        got = g.point(ti, li, pi, ci, si)
                        tag = (ti, pol, pi, ci, s)
                        assert float(got.total_latency) == \
                            float(ref.total_latency), tag
                        for f in COUNTERS:
                            assert float(getattr(got, f)) == \
                                float(getattr(ref, f)), (tag, f)


def test_single_policy_grid_matches_jax_and_simulate():
    jt, tr = _traces()
    omegas, caps = (0.0, 1.0, 2.0), [60.0, 150.0]
    jg = jsweep_grid(jt, caps, "stoch_vacdh", [JPP(omega=o) for o in omegas],
                     seeds=(0,), estimate_z=True)
    params = [PolicyParams(omega=o) for o in omegas]
    g = sweep_grid(tr, caps, "stoch_vacdh", params, seeds=(0,),
                   estimate_z=True, use_kernel=False, device="cpu")
    assert g.result.total_latency.shape == (1, 1, 3, 2, 1)
    _assert_vs_jax(g.result, jg.result, "omega x capacity")
    _assert_vs_simulate(g, [tr], ["stoch_vacdh"], params, caps, [0], True,
                        use_kernel=False)
    g = sweep_grid(tr, caps, "stoch_vacdh", params, estimate_z=True,
                   device="cpu")
    _assert_vs_simulate(g, [tr], ["stoch_vacdh"], params, caps, [0], True)


ROSTER = ["lru", "lfu", "lac", "vacdh", "stoch_vacdh", "lru_mad",
          "adaptsize"]


def test_multi_policy_grid_matches_jax_and_simulate():
    jt, tr = _traces()
    jg = jsweep_grid(jt, 100.0, ROSTER, [JPP(omega=1.0)], seeds=(0,))
    params = [PolicyParams(omega=1.0)]
    g = sweep_grid(tr, 100.0, ROSTER, params, use_kernel=False,
                   device="cpu")
    assert g.result.total_latency.shape == (1, len(ROSTER), 1, 1, 1)
    _assert_vs_jax(g.result, jg.result, "roster")
    _assert_vs_simulate(g, [tr], ROSTER, params, [100.0], [0], False,
                        use_kernel=False)
    # the default scores the eq.-16 lane by the kernels' plain versions
    g = sweep_grid(tr, 100.0, ROSTER, params, device="cpu")
    _assert_vs_jax(g.result, jg.result, "roster, default scoring")
    _assert_vs_simulate(g, [tr], ROSTER, params, [100.0], [0], False)


def test_stacked_traces_and_seeds_match():
    pairs = [_traces(seed=s) for s in (0, 1, 2)]
    seeds = (0, 7)
    jg = jsweep_grid([j for j, _ in pairs], 80.0, "vacdh", [JPP(omega=1.0)],
                     seeds=seeds)
    params = [PolicyParams(omega=1.0)]
    traces = [t for _, t in pairs]
    g = sweep_grid(traces, 80.0, "vacdh", params, seeds=seeds,
                   device="cpu")
    assert g.result.total_latency.shape == (3, 1, 1, 1, 2)
    _assert_vs_jax(g.result, jg.result, "traces x seeds")
    _assert_vs_simulate(g, traces, ["vacdh"], params, [80.0], list(seeds),
                        False)


def test_adaptsize_seeds_take_their_own_coins():
    """Seeds key the AdaptSize coin as jax.random.key(seed) does."""
    jt, tr = _traces(seed=3)
    seeds = (0, 7, 123_457)
    jg = jsweep_grid(jt, 60.0, ["lru", "adaptsize"], [JPP()], seeds=seeds)
    g = sweep_grid(tr, 60.0, ["lru", "adaptsize"], [PolicyParams()],
                   seeds=seeds, use_kernel=False, device="cpu")
    _assert_vs_jax(g.result, jg.result, "adaptsize seeds")
    lat = g.result.total_latency[0, 1, 0, 0]
    assert len(set(lat.tolist())) > 1


def test_resid_axis_sweeps_in_one_grid():
    jt, tr = _traces()
    jg = jsweep_grid(jt, 100.0, "stoch_vacdh",
                     [JPP(omega=1.0, resid=m) for m in ("rate", "recency")])
    params = [PolicyParams(omega=1.0, resid=m) for m in ("rate", "recency")]
    g = sweep_grid(tr, 100.0, "stoch_vacdh", params, use_kernel=False,
                   device="cpu")
    _assert_vs_jax(g.result, jg.result, "resid")
    _assert_vs_simulate(g, [tr], ["stoch_vacdh"], params, [100.0], [0],
                        False, use_kernel=False)
    assert float(g.result.total_latency[0, 0, 0, 0, 0]) != \
        float(g.result.total_latency[0, 0, 1, 0, 0])


def test_distribution_parameter_axis():
    jt, tr = _traces()
    ks = (1.0, 2.0, 8.0)
    jg = jsweep_grid(jt, 100.0, "stoch_vacdh",
                     [JPP(omega=1.0, dist=JErlang(k=k)) for k in ks],
                     estimate_z=True)
    params = [PolicyParams(omega=1.0, dist=Erlang(k=k)) for k in ks]
    g = sweep_grid(tr, 100.0, "stoch_vacdh", params, estimate_z=True,
                   device="cpu")
    _assert_vs_jax(g.result, jg.result, "erlang k")
    _assert_vs_simulate(g, [tr], ["stoch_vacdh"], params, [100.0], [0],
                        True)


def test_kernel_path_matches_jax_ref_grid():
    """use_kernel='ref' (the plain eq.-16 versions) against the JAX grid's
    'ref' backend."""
    jt, tr = _traces()
    omegas = (0.0, 1.0)
    jg = jsweep_grid(jt, 100.0, "stoch_vacdh", [JPP(omega=o) for o in omegas],
                     use_kernel="ref")
    params = [PolicyParams(omega=o) for o in omegas]
    g = sweep_grid(tr, 100.0, "stoch_vacdh", params, use_kernel="ref",
                   device="cpu")
    _assert_vs_jax(g.result, jg.result, "ref")
    _assert_vs_simulate(g, [tr], ["stoch_vacdh"], params, [100.0], [0],
                        False, use_kernel="ref")


def test_mixed_param_structure_rejected():
    _, tr = _traces()
    with pytest.raises(ValueError, match="static structure"):
        sweep_grid(tr, 100.0, "stoch_vacdh",
                   [PolicyParams(dist=Erlang(k=2.0)),
                    PolicyParams(dist=Hyperexponential())], device="cpu")


def test_unknown_policy_rejected():
    _, tr = _traces()
    with pytest.raises(ValueError, match="unknown policies"):
        sweep_grid(tr, 100.0, ["lru", "belady"], [PolicyParams()],
                   device="cpu")


def test_unported_options_raise():
    _, tr = _traces()
    with pytest.raises(ValueError, match="slots"):
        sweep_grid(tr, 100.0, "lru", state_mode="slots", device="cpu")
    # devices= / mesh= route through the fabric, which replays whole
    # traces: chunked grids refuse it before starting a worker
    with pytest.raises(ValueError, match="chunk_size is not supported"):
        sweep_grid(tr, 100.0, "lru", devices=2, chunk_size=64,
                   device="cpu")
    with pytest.raises(ValueError, match="chunk_size"):
        sweep_grid(tr, 100.0, "lru", chunk_size=0, device="cpu")


def test_lanes_committing_different_objects_in_one_step():
    """Capacities that differ per lane make the lanes' fetch completions
    diverge, so commits gather a different object per lane; each lane must
    still equal its single-lane run."""
    _, tr = _traces(seed=4)
    caps = [20.0, 45.0, 90.0, 400.0]
    names = ["lru", "stoch_vacdh", "lhd_mad"]
    params = [PolicyParams(omega=1.0)]
    counters, seen = {}, []
    commit = PointUpdate.commit

    def spy(self, idx, due, size, gd_clock):
        if len(set(np.asarray(idx)[due].tolist())) > 1:
            seen.append(1)
        return commit(self, idx, due, size, gd_clock)

    PointUpdate.commit = spy
    try:
        g = sweep_grid(tr, caps, names, params, estimate_z=True,
                       device="cpu", counters=counters)
    finally:
        PointUpdate.commit = commit
    assert seen, "no commit updated different objects across lanes"
    assert counters["lane_requests"] == len(caps) * len(names) * \
        SPEC.n_requests
    _assert_vs_simulate(g, [tr], names, params, caps, [0], True)


def test_gather_of_different_objects_equals_stacked_reads():
    """A commit at a different object in each lane updates each lane's
    point exactly as a one-lane commit there would."""
    _, tr = _traces()
    L = 5
    names = ("lru", "lru_mad", "lhd_mad", "stoch_vacdh", "lru")
    eng = _Engine(tr.sizes, tr.z_mean, [50.0] * L, names,
                  (PolicyParams(),) * L, ((0, 0),) * L, True, "ref", None)
    g = torch.Generator().manual_seed(0)
    eng.st.values.copy_(torch.rand(eng.st.values.shape, generator=g))
    eng.st.flags.copy_(torch.rand(eng.st.flags.shape, generator=g) > 0.5)
    before = eng.st.values.clone(), eng.st.flags.clone()
    idx = np.array([3, 0, 39, 3, 17], np.int64)
    due = np.array([True, True, True, False, True])
    clock = np.linspace(0.0, 1.0, L, dtype=np.float32)
    eng._point.commit(idx, due, eng.sizes_np[idx], clock)
    eng._point.flush()
    for lane in range(L):
        one = _Engine(tr.sizes, tr.z_mean, [50.0], (names[lane],),
                      (PolicyParams(),), ((0, 0),), True, "ref", None)
        one.st.values.copy_(before[0][:, lane:lane + 1])
        one.st.flags.copy_(before[1][:, lane:lane + 1])
        j = idx[lane:lane + 1]
        one._point.commit(j, due[lane:lane + 1], one.sizes_np[j],
                          clock[lane:lane + 1])
        one._point.flush()
        moved = not torch.equal(eng.st.values[:, lane, idx[lane]],
                                before[0][:, lane, idx[lane]])
        assert moved == due[lane], lane
        np.testing.assert_array_equal(
            eng.st.values[:, lane].numpy().view(np.int32),
            one.st.values[:, 0].numpy().view(np.int32))
        np.testing.assert_array_equal(eng.st.flags[:, lane].numpy(),
                                      one.st.flags[:, 0].numpy())
