"""The port's sweep fabric (``devices=`` / ``mesh=`` on ``sweep_grid`` and
``sweep_hier_grid``) on the CPU, with CPU worker processes.

* Every fabric grid (a one-device mesh, ``devices=2`` and ``devices=3``)
  equals the in-process grid bit for bit in every field: single- and
  multi-policy grids, a kernel-scored ``stoch_vacdh`` grid, lane counts
  that the device count does not divide, and a hierarchy grid whose
  traces differ only in their hop laws.
* The same grids hold against the single-device JAX ``sweep_grid`` and
  ``sweep_hier_grid`` (counters exactly, latency to rtol=1e-5), not
  against the JAX fabric.
* ``resolve_fabric``'s knobs and errors, the ``chunk_size`` guard, a
  worker's exception, the counters' sums, and that ``devices`` None or 1
  starts no worker."""
import dataclasses
import functools
import multiprocessing

import jax
import numpy as np
import pytest
import torch

from repro.core import PolicyParams as JPP
from repro.core import sweep_grid as jsweep_grid
from repro.core import sweep_hier_grid as jsweep_hier_grid
from repro.core.distributions import Erlang as JErlang
from repro.core.hierarchy import make_hier_trace as jmake_hier_trace
from repro.data.traces import SyntheticSpec, synthetic_trace
from repro_torch.convert import hier_trace_from_arrays, trace_from_arrays
from repro_torch.core import PolicyParams, sweep_grid, sweep_hier_grid
from repro_torch.core import sweep
from repro_torch.launch.fabric import (FabricWorkerError, lane_blocks,
                                       resolve_fabric, run_shards)
from repro_torch.launch.mesh import Mesh, make_data_mesh

RTOL = 1e-5
FIELDS = ("total_latency", "n_hits", "n_delayed", "n_misses", "n_evictions")
SPEC = SyntheticSpec(n_objects=16, n_requests=250, rate=600.0,
                     latency_base=0.01, latency_per_mb=1e-3)
ROUTES = {"mesh1": dict(mesh=make_data_mesh(1, ["cpu"])),
          "d2": dict(devices=2), "d3": dict(devices=3)}
OMEGAS = (0.0, 1.0, 2.0)
MULTI = ["lru", "lfu", "adaptsize", "vacdh", "stoch_vacdh"]


@functools.lru_cache(maxsize=None)
def _traces(seed=0):
    jt = synthetic_trace(jax.random.key(seed), SPEC)
    return jt, trace_from_arrays(*(np.asarray(x) for x in jt), device="cpu")


@functools.lru_cache(maxsize=None)
def _hier():
    """Two hierarchy traces of one base trace under two hop laws (hash
    routing, so they differ only in their hops): (JAX, port) lists."""
    jt, _ = _traces()
    jh = [jmake_hier_trace(jt, 2, key=jax.random.key(3), hop_mean=0.004,
                           hop_dist=d, route="hash")
          for d in (JPP().dist, JErlang(k=4))]
    return jh, [hier_trace_from_arrays(*(np.asarray(x) for x in h),
                                       device="cpu") for h in jh]


# (port arguments, JAX arguments) of each grid; the kernel-scored grid
# runs the plain eq.-16 versions on the CPU (use_kernel None) against
# JAX's use_kernel='ref', the multi-policy grid the epilogues on both
def _grid_args(kind):
    if kind == "single":          # 6 lanes: d = 1, 2, 3 divide them
        return ((30.0, 60.0), "stoch_vacdh",
                [PolicyParams(omega=o) for o in OMEGAS], (0,),
                dict(estimate_z=True), dict(estimate_z=True,
                                            use_kernel="ref"))
    return ((40.0,), MULTI, [PolicyParams(omega=1.0)], (0,),   # 5 lanes
            dict(use_kernel=False), {})


@functools.lru_cache(maxsize=None)
def _grid(kind, route=None):
    """The port's grid over two traces, in process (``route`` None) or
    through the fabric; returns (grid, counters)."""
    caps, pols, params, seeds, kw, _ = _grid_args(kind)
    counters = {}
    g = sweep_grid([_traces(0)[1], _traces(1)[1]], caps, pols, params,
                   seeds, device="cpu", counters=counters, **kw,
                   **(ROUTES[route] if route else {}))
    return g, counters


@functools.lru_cache(maxsize=None)
def _hier_grid(route=None):
    counters = {}
    g = sweep_hier_grid(_hier()[1], 2, [10.0, 20.0], 40.0,
                        ["lru", "stoch_vacdh"],
                        [PolicyParams(omega=o) for o in (0.0, 2.0)],
                        device="cpu", counters=counters,
                        **(ROUTES[route] if route else {}))
    return g, counters


def _n_devices(route):
    kw = ROUTES[route]
    return kw["mesh"].size if "mesh" in kw else kw["devices"]


def _bitwise(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("kind", ["single", "multi"])
def test_fabric_grid_is_in_process_grid_bitwise(kind, route):
    base, _ = _grid(kind)
    got, counters = _grid(kind, route)
    assert got.result.total_latency.shape == base.result.total_latency.shape
    for f in FIELDS:
        assert _bitwise(getattr(got.result, f), getattr(base.result, f)), f
    assert (got.policies, got.params, got.seeds) == \
        (base.policies, base.params, base.seeds)
    assert torch.equal(got.capacities, base.capacities)
    n_lanes = got.result.total_latency[0].numel()
    assert counters["workers"] == min(n_lanes, _n_devices(route))


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_fabric_grid_holds_against_jax(kind):
    caps, pols, params, seeds, _, jkw = _grid_args(kind)
    got, _ = _grid(kind, "d3")
    jg = jsweep_grid([_traces(0)[0], _traces(1)[0]], list(caps), pols,
                     [JPP(omega=p.omega) for p in params], seeds=seeds,
                     **jkw)
    for f in FIELDS[1:]:
        np.testing.assert_array_equal(getattr(got.result, f).numpy(),
                                      np.asarray(getattr(jg.result, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.result.total_latency.numpy(),
                               np.asarray(jg.result.total_latency),
                               rtol=RTOL)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_fabric_hier_grid_is_in_process_grid_bitwise(route):
    base, _ = _hier_grid()
    got, counters = _hier_grid(route)
    for tier in ("per_shard", "l2"):
        for f in FIELDS:
            assert _bitwise(getattr(getattr(got.result, tier), f),
                            getattr(getattr(base.result, tier), f)), \
                (tier, f)
    # 4 points, each with both hop-law traces in one worker
    assert counters["workers"] == min(4, _n_devices(route))
    assert counters["lane_requests"] == _hier_grid()[1]["lane_requests"]


def test_fabric_hier_grid_holds_against_jax():
    got, _ = _hier_grid("d3")
    jg = jsweep_hier_grid(_hier()[0], 2, [10.0, 20.0], 40.0,
                          ["lru", "stoch_vacdh"],
                          [JPP(omega=o) for o in (0.0, 2.0)])
    for tier in ("per_shard", "l2"):
        g, w = getattr(got.result, tier), getattr(jg.result, tier)
        for f in FIELDS[1:]:
            np.testing.assert_array_equal(
                getattr(g, f).numpy(), np.asarray(getattr(w, f)),
                err_msg=f"{tier} {f}")
        np.testing.assert_allclose(g.total_latency.numpy(),
                                   np.asarray(w.total_latency), rtol=RTOL,
                                   err_msg=tier)


def test_counters_sum_as_documented():
    """A one-device mesh counts what the in-process grid counts; over
    several workers ``requests`` counts once and ``lane_requests`` stays,
    while syncs, commits and scoring commits are each block's engine's,
    summed: here one lane a worker, so each policy's own grid."""
    _, inproc = _grid("multi")
    _, one = _grid("multi", "mesh1")
    assert {k: v for k, v in one.items()
            if k not in ("launches", "workers", "worker_start_s")} == inproc
    assert one["launches"] == {k: 0 for k in one["launches"]}
    assert one["worker_start_s"] > 0
    tr = _traces()[1]
    counters, want = {}, {}
    sweep_grid(tr, 40.0, ["lru", "stoch_vacdh"], [PolicyParams()],
               devices=2, device="cpu", counters=counters)
    for pol in ("lru", "stoch_vacdh"):
        c = {}
        sweep_grid(tr, 40.0, pol, [PolicyParams()], device="cpu",
                   counters=c)
        for k, v in c.items():
            want[k] = want.get(k, 0) + v
    want["requests"] = tr.n_requests
    assert counters["workers"] == 2
    assert {k: counters[k] for k in want} == want
    assert not multiprocessing.active_children()


def test_devices_none_or_one_starts_no_worker(monkeypatch):
    base, inproc = _grid("multi")
    caps, pols, params, seeds, kw, _ = _grid_args("multi")

    def no_workers(*a, **k):
        raise AssertionError("a worker was started")

    monkeypatch.setattr("repro_torch.core.sweep.run_shards", no_workers)
    for devices in (None, 1):
        c = {}
        g = sweep_grid([_traces(0)[1], _traces(1)[1]], caps, pols, params,
                       seeds, devices=devices, device="cpu", counters=c,
                       **kw)
        for f in FIELDS:
            assert _bitwise(getattr(g.result, f), getattr(base.result, f))
        assert c == inproc
    hb, _ = _hier_grid()
    h = sweep_hier_grid(_hier()[1], 2, [10.0, 20.0], 40.0,
                        ["lru", "stoch_vacdh"],
                        [PolicyParams(omega=o) for o in (0.0, 2.0)],
                        devices=1, device="cpu")
    assert _bitwise(h.result.l2.total_latency, hb.result.l2.total_latency)


def test_resolve_fabric_knobs():
    assert resolve_fabric() is None
    assert resolve_fabric(devices=1) is None
    assert resolve_fabric(devices=1, device="cpu") is None
    m = make_data_mesh(1, ["cpu"])
    assert resolve_fabric(mesh=m) is m
    assert resolve_fabric(mesh=m, device="cpu") is m
    m3 = resolve_fabric(devices=3, device="cpu")
    assert m3.shape == {"data": 3} and m3.axis_names == ("data",)
    assert all(d == torch.device("cpu") for d in m3.devices)


def test_resolve_fabric_errors(monkeypatch):
    with pytest.raises(ValueError, match="must be >= 1"):
        resolve_fabric(devices=0)
    with pytest.raises(ValueError, match="not both"):
        resolve_fabric(devices=2, mesh=make_data_mesh(1, ["cpu"]))
    with pytest.raises(ValueError, match="'data' axis"):
        resolve_fabric(mesh=Mesh(("cpu",), ("model",), (1,)))
    with pytest.raises(ValueError, match="mesh holds cpu"):
        resolve_fabric(mesh=make_data_mesh(1, ["cpu"]), device="cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_fabric(devices=2)
    # a one-card machine: more CUDA devices than visible raise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 CUDA device"):
        resolve_fabric(devices=2)
    with pytest.raises(ValueError, match="only 1 CUDA device"):
        resolve_fabric(mesh=make_data_mesh(devices=["cuda:1"]))
    with pytest.raises(ValueError, match="only 1 CUDA device"):
        sweep_grid(_traces()[1], 40.0, "lru", devices=2)


def test_lane_blocks_are_contiguous_and_in_order():
    assert lane_blocks(6, 3) == [slice(0, 2), slice(2, 4), slice(4, 6)]
    assert lane_blocks(5, 3) == [slice(0, 2), slice(2, 4), slice(4, 5)]
    assert lane_blocks(2, 3) == [slice(0, 1), slice(1, 2), slice(2, 2)]
    assert lane_blocks(7, 1) == [slice(0, 7)]


def test_chunk_size_with_the_fabric_raises():
    tr = _traces()[1]
    for kw in (dict(devices=2), dict(mesh=make_data_mesh(1, ["cpu"]))):
        with pytest.raises(ValueError, match="chunk_size is not supported"):
            sweep_grid(tr, 40.0, "lru", [PolicyParams()], chunk_size=64,
                       device="cpu", **kw)
    # devices=1 is the in-process path, where chunks are allowed
    g = sweep_grid(tr, 40.0, "lru", [PolicyParams()], chunk_size=64,
                   devices=1, device="cpu")
    assert g.result.total_latency.shape == (1, 1, 1, 1, 1)


def test_worker_exception_reaches_the_caller():
    tr = _traces()[1]
    host = [(tr.sizes.numpy(), tr.z_mean.numpy(), tr.times.numpy(),
             tr.objs.numpy(), tr.z_draw.numpy())]
    lanes = dict(policies=("no_such_policy",), params=(PolicyParams(),),
                 capacities=np.float32([40.0]), keys=((0, 0),))
    with pytest.raises(FabricWorkerError, match="KeyError"):
        run_shards(make_data_mesh(2, ["cpu"] * 2), sweep._grid_shard,
                   [(host, lanes, False, "rank"), None])
    assert not multiprocessing.active_children()


def test_fabric_result_fields_are_dataclass_fields():
    """A worker's task sends the fields of SimResult in its own order: its
    host rows equal the in-process engine loop's lanes, field by field."""
    from repro_torch.core import SimResult
    assert sweep._FIELDS == tuple(
        f.name for f in dataclasses.fields(SimResult)) == FIELDS
    tr = _traces()[1]
    cols = (tr.sizes.numpy(), tr.z_mean.numpy(), tr.times.numpy(),
            tr.objs.numpy(), tr.z_draw.numpy())
    lanes = dict(policies=("lru", "vacdh"), params=(PolicyParams(),) * 2,
                 capacities=np.float32([40.0, 60.0]),
                 keys=((0, 0), (0, 1)))
    dev = torch.device("cpu")
    (arr,), stats = sweep._grid_shard(dev, [cols], lanes, False, "rank")
    (res,) = sweep._grid_lanes(dev, [cols], lanes, False, "rank", None)
    assert arr.shape == (len(FIELDS), 2) and arr.dtype == np.float32
    for fi, f in enumerate(FIELDS):
        for li, r in enumerate(res):
            assert arr[fi, li] == getattr(r, f).item(), (f, li)
    assert stats["lane_requests"] == 2 * tr.times.shape[0]
