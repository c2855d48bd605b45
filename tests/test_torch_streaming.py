"""The port's streaming replay and ingestion against the JAX package's.

* ``simulate_chunked`` and the unrebased ``simulate_stream`` are bitwise
  equal to ``simulate``; the chunked grid to the unchunked grid;
* the rebased stream is shift-invariant bit for bit, matches the JAX
  package's rebased stream (counters exactly, latency to rtol=1e-5), and
  survives an epoch-scale base that corrupts the f32 ``simulate``;
* ingestion (CSV, the DHCT binary format, key hashing, compaction,
  ``realworld_raw``) gives the JAX package's columns bit for bit, except
  the latency draw ``z_draw``, which is checked in distribution."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import simulate_stream as jsimulate_stream
from repro.data import traces as jtr
from repro_torch.convert import trace_from_arrays
from repro_torch.core import (PolicyParams, RequestStream, auto_chunk_size,
                              resolve_chunk_size, simulate, simulate_chunked,
                              simulate_stream, stream_of_trace, sweep_grid,
                              trace_of_stream)
from repro_torch.data import traces as ptr

RTOL = 1e-5
FIELDS = ("total_latency", "n_hits", "n_delayed", "n_misses", "n_evictions")
COUNTERS = FIELDS[1:]


@functools.lru_cache(maxsize=None)
def _trace(seed=0, n_requests=1500, n_objects=40):
    spec = jtr.SyntheticSpec(n_objects=n_objects, n_requests=n_requests,
                             rate=300.0, size_min=1.0, size_max=20.0,
                             latency_base=0.01, latency_per_mb=1e-3)
    jt = jtr.synthetic_trace(jax.random.key(seed), spec)
    return trace_from_arrays(*(np.asarray(x) for x in jt), device="cpu")


def _assert_same(a, b):
    for f in FIELDS:
        assert float(getattr(a, f)) == float(getattr(b, f)), f


def _assert_vs_jax(got, want):
    for f in COUNTERS:
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    np.testing.assert_allclose(float(got.total_latency),
                               float(want.total_latency), rtol=RTOL)


# --- chunked == whole, bitwise ----------------------------------------------
@pytest.mark.parametrize("chunk_size", [1, 7, 1500])
def test_chunked_simulate_bitwise_matches_simulate(chunk_size):
    trace = _trace()
    base = simulate(trace, 100.0, "stoch_vacdh", estimate_z=True,
                    device="cpu")
    got = simulate_chunked(trace, 100.0, "stoch_vacdh", estimate_z=True,
                           chunk_size=chunk_size, device="cpu")
    _assert_same(base, got)


def test_chunked_simulate_matches_across_policies():
    trace = _trace(seed=3)
    for policy in ("lru", "lru_mad", "adaptsize", "vacdh"):
        base = simulate(trace, 80.0, policy, device="cpu")
        got = simulate_chunked(trace, 80.0, policy, chunk_size=256,
                               device="cpu")
        _assert_same(base, got)


def test_chunked_sweep_bitwise_matches_unchunked():
    traces = [_trace(seed=s, n_requests=1200) for s in (0, 1)]
    kw = dict(params=[PolicyParams(omega=o) for o in (0.0, 1.0)],
              seeds=(0,), estimate_z=True, device="cpu")
    g0 = sweep_grid(traces, [60.0, 150.0], "stoch_vacdh", **kw)
    g1 = sweep_grid(traces, [60.0, 150.0], "stoch_vacdh", chunk_size=700,
                    **kw)
    for f in FIELDS:
        assert torch.equal(getattr(g0.result, f), getattr(g1.result, f)), f


def test_chunked_sweep_multi_policy_bitwise_matches_unchunked():
    trace = _trace(seed=2, n_requests=1200)
    names = ["lru", "stoch_vacdh", "lru_mad", "adaptsize"]
    g0 = sweep_grid(trace, 100.0, names, [PolicyParams()], seeds=(0, 2),
                    device="cpu")
    g1 = sweep_grid(trace, 100.0, names, [PolicyParams()], seeds=(0, 2),
                    chunk_size=333, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(g0.result, f), getattr(g1.result, f)), f


def test_stream_unrebased_bitwise_matches_simulate():
    trace = _trace()
    base = simulate(trace, 100.0, "stoch_vacdh", device="cpu")
    got = simulate_stream(stream_of_trace(trace), 100.0, "stoch_vacdh",
                          chunk_size=256, rebase=False, device="cpu")
    _assert_same(base, got)
    for cs in ("auto", None):
        got = simulate_stream(stream_of_trace(trace), 100.0, "stoch_vacdh",
                              chunk_size=cs, rebase=False, device="cpu")
        _assert_same(base, got)


# --- f64 time carries: rebasing ----------------------------------------------
def _gap_pattern_stream(base_time: float, seed=3, T=4000, N=50,
                        max_gap=2000):
    """A stream with exactly representable gaps placed at ``base_time``."""
    rng = np.random.default_rng(seed)
    gaps = rng.integers(1, max_gap, T) * 2.0 ** -10
    objs = rng.integers(0, N, T).astype(np.int32)
    sizes = rng.integers(1, 8, N).astype(np.float32)
    z_mean = np.full(N, 0.05, np.float32)
    z_draw = (z_mean[objs] * rng.exponential(1.0, T)).astype(np.float32)
    return RequestStream(base_time + np.cumsum(gaps), objs, sizes, z_mean,
                         z_draw)


def test_rebased_stream_is_shift_invariant_bit_for_bit():
    early = _gap_pattern_stream(0.0)
    late = _gap_pattern_stream(3 * 2.0 ** 25)
    for policy in ("stoch_vacdh", "lru_mad"):
        a = simulate_stream(early, 40.0, policy, chunk_size=512,
                            device="cpu")
        b = simulate_stream(late, 40.0, policy, chunk_size=512,
                            device="cpu")
        _assert_same(a, b)


def test_f32_simulate_corrupts_at_late_base_rebased_stream_does_not():
    early = _gap_pattern_stream(0.0)
    late = _gap_pattern_stream(3 * 2.0 ** 25)
    want = simulate_stream(early, 40.0, "stoch_vacdh", chunk_size=512,
                           device="cpu")
    f32 = simulate(trace_of_stream(late, device="cpu"), 40.0, "stoch_vacdh",
                   device="cpu")
    assert int(f32.n_hits) != int(want.n_hits)
    got = simulate_stream(late, 40.0, "stoch_vacdh", chunk_size=512,
                          device="cpu")
    assert int(got.n_hits) == int(want.n_hits)


@pytest.mark.parametrize("policy", ["stoch_vacdh", "lru", "lhd_mad"])
def test_rebased_stream_matches_jax(policy):
    """The carried completion times (state and host heap) shift as the JAX
    state's do, at chunk boundaries that cut through fetches in flight."""
    stream = _gap_pattern_stream(2.0 ** 26 + 0.1, T=2000, N=30, max_gap=64)
    want = jsimulate_stream(stream, 30.0, policy, chunk_size=256,
                            estimate_z=True)
    got = simulate_stream(stream, 30.0, policy, chunk_size=256,
                          estimate_z=True, use_kernel=False, device="cpu")
    _assert_vs_jax(got, want)


def test_epoch_time_compacted_stream_matches_jax():
    raw = ptr.realworld_raw(ptr.RealWorldSpec(n_requests=3000, n_keys=800,
                                              start_time=1.7e9))
    stream, _ = ptr.compact_requests(raw, top_k=200, n_recycle=16)
    cap = 0.1 * float(stream.sizes.sum())
    want = jsimulate_stream(stream, cap, "stoch_vacdh", chunk_size=512,
                            estimate_z=True)
    got = simulate_stream(stream, cap, "stoch_vacdh", chunk_size=512,
                          estimate_z=True, device="cpu")
    _assert_vs_jax(got, want)
    assert int(got.n_hits + got.n_delayed + got.n_misses) == 3000


def test_slot_mode_and_chunk_size_errors():
    s = stream_of_trace(_trace())
    with pytest.raises(ValueError, match="evict_top"):
        simulate_stream(s, 10.0, state_mode="slots", evict_top=8,
                        device="cpu")
    with pytest.raises(ValueError, match="n_slots"):
        simulate_chunked(_trace(), 10.0, n_slots=64, device="cpu")
    with pytest.raises(ValueError, match="state_mode"):
        simulate_stream(s, 10.0, state_mode="sparse", device="cpu")
    with pytest.raises(ValueError, match="chunk_size"):
        simulate_stream(s, 10.0, chunk_size=0, device="cpu")
    with pytest.raises(ValueError, match="auto"):
        resolve_chunk_size("big", 10)


def test_auto_chunk_size_minimizes_padding():
    from repro.core.trace import auto_chunk_size as jauto
    assert auto_chunk_size(1_000_000) == 125_000
    assert auto_chunk_size(100) == 100
    assert auto_chunk_size(131_073) == 65_537
    assert auto_chunk_size(1, target=131_072) == 1
    for n in (999_983, 123_457, 65_536, 70_000, 0, 7):
        assert auto_chunk_size(n) == jauto(n)
        c = auto_chunk_size(n)
        k = -(-max(n, 1) // c)
        assert k * c - max(n, 1) < k
    with pytest.raises(ValueError, match="target"):
        auto_chunk_size(10, target=0)


def test_stream_round_trip_keeps_trace_bits():
    trace = _trace()
    back = trace_of_stream(stream_of_trace(trace), device="cpu")
    for a, b in zip((trace.times, trace.objs, trace.sizes, trace.z_mean,
                     trace.z_draw),
                    (back.times, back.objs, back.sizes, back.z_mean,
                     back.z_draw)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# --- ingestion --------------------------------------------------------------
def _assert_raw_equal(a, b):
    for f in ("times", "keys", "sizes"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("seed", [0, 5])
def test_realworld_raw_matches_jax(seed):
    spec = dict(n_requests=5000, n_keys=2000, seed=seed)
    _assert_raw_equal(ptr.realworld_raw(ptr.RealWorldSpec(**spec)),
                      jtr.realworld_raw(jtr.RealWorldSpec(**spec)))


def test_bin_format_round_trip_and_jax_readable(tmp_path):
    raw = ptr.realworld_raw(ptr.RealWorldSpec(n_requests=5000, n_keys=2000))
    path = tmp_path / "trace.bin"
    ptr.save_trace_bin(path, raw)
    _assert_raw_equal(ptr.load_trace_bin(path), raw)
    _assert_raw_equal(jtr.load_trace_bin(path), raw)
    jpath = tmp_path / "jax.bin"
    jtr.save_trace_bin(jpath, jtr.realworld_raw(
        jtr.RealWorldSpec(n_requests=5000, n_keys=2000)))
    assert path.read_bytes() == jpath.read_bytes()


def test_bin_format_rejects_garbage(tmp_path):
    path = tmp_path / "bad.bin"
    path.write_bytes(b"not a trace at all")
    with pytest.raises(ValueError, match="magic"):
        ptr.load_trace_bin(path)
    raw = ptr.realworld_raw(ptr.RealWorldSpec(n_requests=50, n_keys=20))
    ptr.save_trace_bin(path, raw)
    path.write_bytes(path.read_bytes()[:-7])
    with pytest.raises(ValueError, match="truncated"):
        ptr.load_trace_bin(path)


def test_key_hashing_matches_jax_and_takes_unicode_digits():
    assert ptr.key_u64("123") == 123
    assert ptr.key_u64(" 42 ") == 42
    for k in ("²", "x²", "½", "/wiki/Main_Page", "123", " 7 ", "ünï"):
        assert ptr.key_u64(k) == jtr.key_u64(k), k
        assert 0 <= ptr.key_u64(k) < 2 ** 64
    assert ptr.key_u64("²") != ptr.key_u64("½")
    x = np.arange(0, 2 ** 20, 977, dtype=np.uint64)
    np.testing.assert_array_equal(ptr._mix64(x), jtr._mix64(x))


def test_csv_ingestion_with_header_and_string_keys(tmp_path):
    path = tmp_path / "trace.csv"
    path.write_text(
        "timestamp,key,size\n"
        "100.5,/wiki/Main_Page,0.25\n"
        "100.5,/wiki/Main_Page,0.25\n"
        "101.0,12345,1.5\n"
        "\n"
        "99.0,/wiki/Other,2.0\n")
    raw = ptr.load_trace_csv(path)
    assert raw.n_requests == 4
    assert list(raw.times) == [99.0, 100.5, 100.5, 101.0]
    assert raw.keys[1] == raw.keys[2] == ptr.key_u64("/wiki/Main_Page")
    assert raw.keys[3] == 12345
    _assert_raw_equal(raw, jtr.load_trace_csv(path))
    spaced = tmp_path / "spaced.csv"
    spaced.write_text("k1 3.0 10.0\nk2 1.0 20.0\n")
    kw = dict(time_col=2, key_col=0, size_col=1, delimiter=" ")
    _assert_raw_equal(ptr.load_trace_csv(spaced, **kw),
                      jtr.load_trace_csv(spaced, **kw))


def _assert_stream_matches_jax(raw_spec, **kw):
    raw = ptr.realworld_raw(ptr.RealWorldSpec(**raw_spec))
    got, gs = ptr.compact_requests(raw, **kw)
    want, ws = jtr.compact_requests(
        jtr.realworld_raw(jtr.RealWorldSpec(**raw_spec)), **kw)
    assert dataclasses.asdict(gs) == dataclasses.asdict(ws)
    for f in ("times", "objs", "sizes", "z_mean"):
        x, y = getattr(got, f), np.asarray(getattr(want, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    # the latency draw: the same law, from another generator
    unit = got.z_draw / got.z_mean[got.objs]
    assert got.z_draw.dtype == np.float32
    assert abs(unit.mean() - 1.0) < 0.05 and abs(unit.std() - 1.0) < 0.06
    return got, gs


def test_compaction_injective_when_universe_fits():
    stream, stats = _assert_stream_matches_jax(
        dict(n_requests=20_000, n_keys=3000), top_k=10_000, n_recycle=64)
    assert stats.n_objects == stats.n_unique
    assert stats.tail_mass == 0.0
    assert len(np.unique(stream.objs)) == stats.n_unique


def test_compaction_tail_pooling_and_stats():
    stream, stats = _assert_stream_matches_jax(
        dict(n_requests=20_000, n_keys=3000), top_k=500, n_recycle=32)
    assert stats.n_objects == 500 + 32
    assert stream.objs.max() < stats.n_objects
    assert stats.tail_unique == stats.n_unique - 500
    counts = np.bincount(stream.objs, minlength=stats.n_objects)
    assert counts[0] == counts[:500].max()
    assert 0.0 < stats.tail_mass < 1.0
    np.testing.assert_allclose(counts[500:].sum() / stream.n_requests,
                               stats.tail_mass, rtol=1e-6)


def test_exact_requests_matches_jax():
    raw = ptr.realworld_raw(ptr.RealWorldSpec(n_requests=3000, n_keys=900))
    got, gs = ptr.exact_requests(raw)
    want, ws = jtr.exact_requests(raw)
    assert dataclasses.asdict(gs) == dataclasses.asdict(ws)
    np.testing.assert_array_equal(got.objs, want.objs)
    np.testing.assert_array_equal(got.sizes, want.sizes)


def test_compaction_rejects_overflow_without_pool():
    raw = ptr.realworld_raw(ptr.RealWorldSpec(n_requests=5000, n_keys=2000))
    with pytest.raises(ValueError, match="n_recycle"):
        ptr.compact_requests(raw, top_k=10, n_recycle=0)


def test_compaction_draw_takes_an_explicit_generator():
    raw = ptr.realworld_raw(ptr.RealWorldSpec(n_requests=2000, n_keys=500))
    a, _ = ptr.compact_requests(raw, generator=torch.Generator()
                                .manual_seed(3))
    b, _ = ptr.compact_requests(raw, seed=3)
    c, _ = ptr.compact_requests(raw, seed=4)
    np.testing.assert_array_equal(a.z_draw, b.z_draw)
    assert not np.array_equal(a.z_draw, c.z_draw)


def test_compacted_stream_replays_end_to_end():
    raw = ptr.realworld_raw(ptr.RealWorldSpec(n_requests=3000, n_keys=800,
                                              start_time=1.7e9))
    stream, _ = ptr.compact_requests(raw, top_k=200, n_recycle=16)
    r = simulate_stream(stream, 50.0, "stoch_vacdh", chunk_size=512,
                        device="cpu")
    assert int(r.n_hits) + int(r.n_delayed) + int(r.n_misses) == 3000
    assert float(r.total_latency) > 0.0
    # the same stream moved to t = 0 replays identically through the f32
    # trace once rebasing is off
    early = stream._replace(times=stream.times - stream.times[0])
    a = simulate_stream(early, 50.0, "stoch_vacdh", chunk_size=512,
                        rebase=False, device="cpu")
    b = simulate(trace_of_stream(early, device="cpu"), 50.0, "stoch_vacdh",
                 device="cpu")
    _assert_same(a, b)
