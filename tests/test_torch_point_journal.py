"""The point-update journal (``kernels/point_update.py``) on the CPU.

* The plain flush of a journal equals the same ops applied one by one
  through ``point_serve_ref``, ``point_commit_ref`` and an indexed set, bit
  for bit: chains of 1-8 ops at one point, serve -> commit -> set -> serve
  interleavings, masked lanes and lanes not due, GreedyDual lanes, slot
  first touches, L = 1, 5 and 72, and journals over one launch's
  parameter block and over one journal's lanes.
* The engines flush before every read of the state: the journal is empty
  whenever ``make_substrate``, ``eviction_pick`` or ``shift_times`` runs on
  an engine's state and when its ``result`` returns (dense, slot,
  hierarchy, rebased stream and grid engines)."""
import numpy as np
import pytest
import torch

from repro_torch.core import (PolicyParams, make_hier_trace, simulate,
                              simulate_hier, simulate_stream,
                              stream_of_trace, sweep_grid)
from repro_torch.core import simulator
from repro_torch.core.ranking import EPS
from repro_torch.data.traces import SyntheticSpec, synthetic_trace
from repro_torch.figures.bench_kernels import (journal_ops, point_lanes,
                                               point_state, push_ops)
from repro_torch.kernels import point_update as pu
from repro_torch.kernels.ref import point_commit_ref, point_serve_ref


def _lane_tensors(lane):
    gd, gd_rate, cold, alpha = lane
    return (torch.as_tensor(np.asarray(gd)),
            torch.as_tensor(np.asarray(gd_rate)),
            torch.as_tensor(np.asarray(cold, np.float32)),
            torch.as_tensor(np.asarray(alpha, np.float32)),
            float(np.float32(EPS)))


def _one_by_one(values, flags, table, lane, estimate_z, ops):
    """The oracle: each op through its plain version, in order."""
    L = values.shape[1]
    lane = _lane_tensors(lane)
    b = lambda x, dt: torch.as_tensor(
        np.array(np.broadcast_to(np.asarray(x), (L,))), dtype=dt)
    for kind, a in ops:
        if kind == "serve":
            idx, t, z, size, clock, active, fresh = a
            fr = None if fresh is None else (
                *table, int(fresh[0]), torch.tensor(np.float32(fresh[1])))
            point_serve_ref(values, flags, b(idx, torch.int64),
                            torch.tensor(np.float32(t[0])),
                            b(z, torch.float32), b(size, torch.float32),
                            b(clock, torch.float32), lane,
                            None if active is None
                            else b(active, torch.bool), fr)
        elif kind == "commit":
            idx, due, size, clock = a
            point_commit_ref(values, flags, b(idx, torch.int64),
                             b(due, torch.bool), b(size, torch.float32),
                             b(clock, torch.float32), lane, estimate_z)
        else:
            idx, mask, value = a
            rows = torch.arange(L)[torch.as_tensor(mask)]
            flags[0, rows, torch.as_tensor(idx)[torch.as_tensor(mask)]] = \
                value


def _state(lanes, n, seed, slot):
    values, flags = point_state(lanes, n, seed, "cpu")
    table = ((torch.full((n,), -1, dtype=torch.int32), torch.zeros(n))
             if slot else None)
    return [values, flags] + list(table or ())


def _check(ops, lanes, n, seed=0, slot=False, estimate_z=True,
           flushes=1):
    """Journal ``ops`` and flush (``flushes`` times, at even cuts),
    against the oracle; returns the ``PointUpdate``."""
    lane = point_lanes(lanes, seed)
    got, want = _state(lanes, n, seed, slot), _state(lanes, n, seed, slot)
    p = pu.PointUpdate(got[0], got[1], *lane, EPS, estimate_z,
                       table=tuple(got[2:]) or None)
    cuts = np.linspace(0, len(ops), flushes + 1).astype(int)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        push_ops(p, ops[lo:hi])
        if hi > lo:
            assert p.pending > 0
        p.flush()
        assert p.pending == 0
    _one_by_one(want[0], want[1], tuple(want[2:]) or None, lane,
                estimate_z, ops)
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)
    return p


@pytest.mark.parametrize("lanes", [1, 5])
@pytest.mark.parametrize("chain", range(1, 9))
def test_chain_at_one_point(chain, lanes):
    rng = np.random.default_rng(100 + chain)
    ops = journal_ops(rng, lanes, 50, chain, hot=1, p_hot=1.0)
    assert _check(ops, lanes, 50, seed=chain).n_blocks == 1


@pytest.mark.parametrize("lanes", [1, 5])
@pytest.mark.parametrize("estimate_z", [False, True])
def test_serve_commit_set_serve(lanes, estimate_z):
    """A miss, its commit, an admission and a hit at one object a lane,
    then an eviction and a miss again, with lanes out of each."""
    rng = np.random.default_rng(7)
    idx = rng.integers(0, 30, lanes)
    clock = rng.uniform(0.0, 3.0, lanes).astype(np.float32)
    size = rng.uniform(1.0, 50.0, lanes).astype(np.float32)
    some = np.arange(lanes) % 2 == 0
    t = lambda x: np.float32([x])
    z = np.float32([0.02])
    ops = [("serve", (idx, t(10.0), z, size, clock, None, None)),
           ("serve", (idx, t(10.005), z, size, clock, None, None)),
           ("commit", (idx, np.ones(lanes, bool), size, clock)),
           ("set", (idx, np.ones(lanes, bool), True)),
           ("serve", (idx, t(11.0), z, size, clock + 1, some, None)),
           ("set", (idx, some, False)),
           ("serve", (idx, t(12.0), z, size, clock, None, None)),
           ("commit", (idx, ~some, size, clock))]
    _check(ops, lanes, 30, seed=3, estimate_z=estimate_z)


@pytest.mark.parametrize("lanes", [1, 5, 72])
@pytest.mark.parametrize("n", [6, 100])
@pytest.mark.parametrize("seed", range(3))
def test_random_journal(lanes, n, seed):
    """Random interleavings, masked lanes, lanes not due, GreedyDual lanes
    (half of them), at few objects (long chains) and many; L = 72 spans
    several parameter blocks."""
    rng = np.random.default_rng(seed)
    ops = journal_ops(rng, lanes, n, 180 if lanes == 72 else 60,
                      p_hot=0.5)
    p = _check(ops, lanes, n, seed=seed, flushes=1 + seed)
    assert p.n_ops == len(ops)
    if lanes == 72:
        assert p.n_blocks > 1 + seed


@pytest.mark.parametrize("seed", range(3))
def test_slot_first_touches(seed):
    rng = np.random.default_rng(50 + seed)
    ops = journal_ops(rng, 1, 64, 80, slot=True, hot=4)
    assert any(k == "serve" and a[6] is not None for k, a in ops)
    _check(ops, 1, 64, seed=seed, slot=True, flushes=2)


def test_journal_over_one_launch():
    """More ops than one parameter block holds: one block after another,
    in order."""
    rng = np.random.default_rng(9)
    ops = journal_ops(rng, 1, 40, pu.MAX_OPS + 200, hot=5)
    assert _check(ops, 1, 40).n_blocks >= 2


def test_lanes_over_one_journal():
    """More lanes than one journal holds: the lanes go in journals of
    ``MAX_LANES``, each its own blocks."""
    rng = np.random.default_rng(4)
    lanes = pu.MAX_LANES + 3
    ops = journal_ops(rng, lanes, 8, 6)
    assert _check(ops, lanes, 8).n_blocks >= 2


def test_slot_table_takes_one_lane():
    values, flags = point_state(2, 8, 0, "cpu")
    table = (torch.full((8,), -1, dtype=torch.int32), torch.zeros(8))
    with pytest.raises(ValueError, match="one-lane"):
        pu.PointUpdate(values, flags, *point_lanes(2, 0), EPS, True,
                       table=table)


# --- the flush points --------------------------------------------------------
SPEC = SyntheticSpec(n_objects=40, n_requests=500, zipf_alpha=0.9,
                     rate=2000.0, latency_base=0.005, latency_per_mb=2e-4,
                     stochastic=True)


def _trace(seed):
    return synthetic_trace(torch.Generator().manual_seed(seed), SPEC,
                           device="cpu")


@pytest.fixture
def reads(monkeypatch):
    """Count each read of an engine's state, asserting its journal is
    empty at that moment."""
    engines, seen = [], {}
    init, result = simulator._Engine.__init__, simulator._Engine.result

    def tracking(self, *a, **k):
        init(self, *a, **k)
        engines.append(self)

    def owner(t):
        ptr = t.untyped_storage().data_ptr()
        hits = [e for e in engines if ptr in (
            e.st.values.untyped_storage().data_ptr(),
            e.st.flags.untyped_storage().data_ptr())]
        assert len(hits) == 1
        return hits[0]

    def seen_by(name, eng):
        assert eng._point.pending == 0, f"{name} read a pending journal"
        seen[name] = seen.get(name, 0) + 1

    def wrap(name, fn, first):
        def wrapped(*a, **k):
            seen_by(name, first(*a))
            return fn(*a, **k)
        monkeypatch.setattr(simulator, name, wrapped)

    wrap("make_substrate", simulator.make_substrate,
         lambda o, *_: owner(o.cached))
    wrap("eviction_pick", simulator.eviction_pick,
         lambda cached, *_: owner(cached))
    wrap("shift_times", simulator.shift_times,
         lambda st, *_: next(e for e in engines if e.st is st))

    def results(self):
        out = result(self)
        seen_by("result", self)
        return out

    monkeypatch.setattr(simulator._Engine, "__init__", tracking)
    monkeypatch.setattr(simulator._Engine, "result", results)
    return seen


def _dense():
    simulate(_trace(0), 250.0, "stoch_vacdh", PolicyParams(omega=1.0),
             estimate_z=True, evict_top=1, device="cpu")


def _slots():
    simulate(_trace(1), 250.0, "lru_mad", estimate_z=True,
             state_mode="slots", n_slots=32, device="cpu")


def _hier():
    ht = make_hier_trace(_trace(2), 3, generator=torch.Generator()
                         .manual_seed(2), hop_mean=0.003, route="hash")
    simulate_hier(ht, 3, 60.0, 200.0, "stoch_vacdh", "lru",
                  PolicyParams(omega=1.0), device="cpu")


def _stream():
    st = stream_of_trace(_trace(3))
    st = st._replace(times=np.asarray(st.times, np.float64) + 1.7e9)
    simulate_stream(st, 250.0, "lhd_mad", PolicyParams(omega=1.0),
                    estimate_z=True, chunk_size=61, rebase=True,
                    evict_top=1, device="cpu")


def _grid():
    sweep_grid(_trace(4), [120.0, 300.0], ["lru", "lru_mad", "stoch_vacdh"],
               PolicyParams(omega=1.0), estimate_z=True, device="cpu")


ENGINES = {"dense": (_dense, {"make_substrate", "eviction_pick", "result"}),
           "slots": (_slots, {"make_substrate", "eviction_pick", "result"}),
           "hier": (_hier, {"make_substrate", "result"}),
           "stream": (_stream, {"make_substrate", "eviction_pick",
                                "shift_times", "result"}),
           "grid": (_grid, {"make_substrate", "result"})}


@pytest.mark.parametrize("case", sorted(ENGINES))
def test_engines_flush_before_every_read(case, reads):
    run, want = ENGINES[case]
    run()
    assert want <= set(reads), reads
