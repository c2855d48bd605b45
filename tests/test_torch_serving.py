"""The port's serving engine against the JAX package's, request by request:
every policy, hedged and unhedged, single tier and a hierarchy with a
callable hop; the reclaim path; the ``prefill_fn`` hook; the device
mirror against the host statistics; and evict-until-fit walks longer than
one read-back."""
import heapq

import numpy as np
import pytest

from repro.serving import engine as je
from repro_torch.core import POLICIES
from repro_torch.serving import engine as te


def _trace(n, seed=0, n_prefix=40, alpha=1.1, gap=0.004):
    """A Zipf prefix workload: (time, key, tokens) triples."""
    rng = np.random.default_rng(seed)
    p = np.arange(1, n_prefix + 1, dtype=np.float64) ** -alpha
    keys = rng.choice(n_prefix, n, p=p / p.sum())
    times = np.cumsum(rng.exponential(gap, n))
    lengths = rng.integers(64, 2048, n_prefix)
    return [(float(t), f"p{k}", int(lengths[k])) for t, k in zip(times, keys)]


def _engine(m, **kw):
    if m is te:
        kw.setdefault("device", "cpu")
    else:
        kw.pop("use_kernel", None)
    return m.ServeEngine(**kw)


def _replay(eng, reqs):
    out = [eng.serve(t, k, n) for t, k, n in reqs]
    tiers = [eng] + ([eng.l2] if eng.l2 is not None else [])
    return out, [e.stats.as_dict() for e in tiers]


def _same(a, b):
    for k, (x, y) in enumerate(zip(a[0], b[0])):
        assert x == y, f"request {k}: jax {x} != port {y}"
    assert a == b


def _single(m, policy, hedging, **kw):
    return _engine(m, capacity=5000.0, policy=policy,
                   latency=m.LatencyModel(base_s=0.02, per_token_s=5e-5),
                   seed=7, hedging=hedging, **kw)


def _hier(m, policy, hedging, **kw):
    l2 = _engine(m, capacity=9000.0, policy=policy,
                 latency=m.LatencyModel(base_s=0.02, per_token_s=5e-5),
                 seed=3, hedging=hedging, **kw)
    return _engine(m, capacity=3000.0, policy=policy, seed=4,
                   hedging=hedging, l2=l2,
                   hop_s=lambda t: 0.002 if t < 0.4 else 0.009, **kw)


@pytest.mark.parametrize("mode", ["single", "hier"])
@pytest.mark.parametrize("hedging", [True, False], ids=["hedged",
                                                        "unhedged"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_engine_equals_reference(policy, hedging, mode):
    make = _single if mode == "single" else _hier
    reqs = _trace(200, seed=len(policy))
    a = _replay(make(je, policy, hedging), reqs)
    b = _replay(make(te, policy, hedging), reqs)
    _same(a, b)
    assert b[1][0]["misses"] > 0


@pytest.mark.parametrize("use_kernel", [False, "kernel", "ref"])
def test_score_modes_equal_reference(use_kernel):
    """The eq.-16 cache ranked through its epilogue (False), through the
    kernel's wrapper (on the CPU: its plain version) and through the plain
    version all give the reference's run."""
    reqs = _trace(300, seed=11)
    a = _replay(_single(je, "stoch_vacdh", True), reqs)
    eng = _single(te, "stoch_vacdh", True, use_kernel=use_kernel)
    assert eng.cache.kernelable == (use_kernel is not False)
    _same(a, _replay(eng, reqs))
    assert a[1][0]["evictions"] > 0


@pytest.mark.parametrize("policy", ["stoch_vacdh", "lru", "lhd"])
def test_walks_longer_than_one_read_back(policy, monkeypatch):
    """One victim a read-back: an admission that needs several victims
    ranks again after each, with the evictions masked out, and ends as
    the reference's."""
    monkeypatch.setattr(te, "EVICT_TOP", 1)
    reqs = _trace(400, seed=5, n_prefix=60, alpha=0.8)
    a = _replay(_single(je, policy, False), reqs)
    eng = _single(te, policy, False)
    assert eng.cache.top == 1
    b = _replay(eng, reqs)
    _same(a, b)
    c = eng.cache.counters
    assert c["ranks"] > c["admits"]          # relaunches happened
    assert c["syncs"] == c["ranks"]


@pytest.mark.parametrize("policy", ["stoch_vacdh", "lfu"])
def test_mirror_equals_host_at_every_rank(policy):
    """After each rank's flush, the device mirror holds the host statistics
    bit for bit; after the run's last flush, again."""
    eng = _single(te, policy, True)
    c = eng.cache
    ranks = c.ranks
    seen = []

    def check():
        host_f = np.stack([getattr(c.obj, k) for k in te.MIRROR_F32]
                          + [c._sizes])
        host_b = np.stack([getattr(c.obj, k) for k in te.MIRROR_BOOL])
        assert c.mirror_f.numpy().view(np.int32).tolist() == \
            host_f.view(np.int32).tolist()
        assert c.mirror_b.numpy().tolist() == host_b.tolist()

    def spy(t):
        out = ranks(t)
        check()
        seen.append(t)
        return out

    c.ranks = spy
    _replay(eng, _trace(250, seed=2))
    assert len(seen) == c.counters["admits"] > 20
    c.flush()
    check()
    assert c.mirror_bytes == (len(te.MIRROR_F32) + 1) * 4 * c.n + 2 * c.n


def test_prefill_hook_sees_the_reference_sequence():
    calls = {je: [], te: []}

    def run(m):
        def hook(key, n_tokens):
            calls[m].append((key, n_tokens))
            return ("state", key)
        eng = _engine(m, capacity=4000.0, policy="stoch_vacdh",
                      latency=m.LatencyModel(base_s=0.02, per_token_s=5e-5),
                      seed=1, prefill_fn=hook)
        return eng, _replay(eng, _trace(300, seed=9))

    (ea, a), (eb, b) = run(je), run(te)
    _same(a, b)
    assert calls[je] == calls[te] and len(calls[te]) > 10
    assert sorted(e.state for e in eb.cache.entries.values()) == \
        sorted(e.state for e in ea.cache.entries.values())


# --- the reclaim path and the reference's engine cases ---------------------
def test_prefix_table_reclaims_dead_slots():
    caches = [je.DelayedHitPrefixCache(capacity=1.0, policy="lru",
                                       max_objects=4),
              te.DelayedHitPrefixCache(capacity=1.0, policy="lru",
                                       max_objects=4, device="cpu")]
    for c in caches:
        for i in range(20):
            c.touch(f"k{i}", float(i))
    a, b = caches
    assert a.key_to_idx == b.key_to_idx and len(b.key_to_idx) <= 4
    assert "k19" in b.key_to_idx and "k0" not in b.key_to_idx
    for f in te.HostStats.__dataclass_fields__:
        assert getattr(a.obj, f).tobytes() == getattr(b.obj, f).tobytes()
    assert b.obj.count[b.key_to_idx["k19"]] == 1.0


def test_prefix_table_raises_only_when_every_slot_is_live():
    for m, kw in ((je, {}), (te, dict(device="cpu"))):
        cache = m.DelayedHitPrefixCache(capacity=2.0, policy="lru",
                                        max_objects=2, **kw)
        stats = m.EngineStats()
        for j, k in enumerate(["a", "b"]):
            i = cache.touch(k, float(j))
            cache.obj.in_flight[i] = True
            cache.obj.issue_t[i] = float(j)
            entry = m.PrefixEntry(k, 10, 1.0, complete_t=10.0 + j)
            assert cache.admit(entry, 10.0 + j, stats)
        with pytest.raises(RuntimeError, match="prefix table full"):
            cache.touch("c", 20.0)


def _one_hit_flood(m):
    eng = _engine(m, capacity=0.5, policy="lru",
                  latency=m.LatencyModel(base_s=0.01, per_token_s=0.0,
                                         stochastic=False),
                  state_size_fn=lambda n: 1.0, hedging=False, max_objects=8)
    return eng, [(0.1 * i, f"one_hit_{i}", 10) for i in range(200)]


def _reclaim_mixed(m):
    """Reclaim between admissions: a table of 16 slots under 60 keys, with
    room in the cache for a few prefixes."""
    eng = _engine(m, capacity=3000.0, policy="stoch_vacdh",
                  latency=m.LatencyModel(base_s=0.02, per_token_s=5e-5),
                  seed=2, max_objects=16)
    return eng, _trace(400, seed=4, n_prefix=60, alpha=0.7, gap=0.05)


def _accounting(m):
    eng = _engine(m, capacity=10.0, policy="lru",
                  latency=m.LatencyModel(base_s=1.0, per_token_s=0.0,
                                         stochastic=False),
                  state_size_fn=lambda n: 1.0, hedging=False)
    return eng, [(0.0, "p1", 100), (0.5, "p1", 100), (2.0, "p1", 100),
                 (3.0, "a", 10), (4.0, "b", 10), (10.0, "c", 10)]


def _capacity_two(m):
    eng = _engine(m, capacity=2.0, policy="lru",
                  latency=m.LatencyModel(base_s=0.1, per_token_s=0.0,
                                         stochastic=False),
                  state_size_fn=lambda n: 1.0, hedging=False)
    return eng, [(0.0, "a", 10), (1.0, "b", 10), (2.0, "c", 10),
                 (10.0, "d", 10), (11.0, "a", 10)]


def _never_admissible(m):
    eng = _engine(m, capacity=1.0, policy="lru",
                  latency=m.LatencyModel(base_s=0.3, per_token_s=0.0),
                  state_size_fn=lambda n: 2.0, hedging=True, seed=5)
    reqs = [(0.05 * i, "k" if i % 3 else f"u{i}", 10) for i in range(120)]
    return eng, reqs


def _brownout_hook(m):
    scale = lambda t: 5.0 if 10.0 <= t < 20.0 else 1.0
    lm = m.LatencyModel(base_s=0.2, per_token_s=1e-4, scale_fn=scale)
    eng = _engine(m, capacity=800.0, policy="stoch_vacdh", latency=lm,
                  seed=8)
    reqs = [(0.25 * i, f"k{i % 7}", 100 * (1 + i % 5)) for i in range(120)]
    return eng, reqs


ENGINE_CASES = {"one_hit_flood": _one_hit_flood,
                "reclaim_mixed": _reclaim_mixed,
                "accounting": _accounting, "capacity_two": _capacity_two,
                "never_admissible": _never_admissible,
                "brownout_hook": _brownout_hook}


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_engine_cases_equal_reference(name):
    ea, ra = ENGINE_CASES[name](je)
    eb, rb = ENGINE_CASES[name](te)
    _same(_replay(ea, ra), _replay(eb, rb))
    assert ea.cache.key_to_idx == eb.cache.key_to_idx
    assert ea.cache.free == eb.cache.free
    if name == "reclaim_mixed":       # reclaim ran between admissions
        assert len(set(k for _, k, _ in rb)) > 16
        assert eb.stats.evictions > 0 and eb.cache.counters["admits"] > 16


def test_stale_event_keeps_the_newer_entry():
    out = {}
    for m in (je, te):
        eng = _engine(m, capacity=10.0, policy="lru",
                      latency=m.LatencyModel(base_s=1.0, per_token_s=0.0,
                                             stochastic=False),
                      state_size_fn=lambda n: 1.0, hedging=False)
        r = [eng.serve(0.0, "k", 10)]
        eng._seq += 1
        heapq.heappush(eng.events, (0.5, eng._seq, "k"))
        r += [eng.serve(0.6, "k", 10), eng.serve(2.0, "k", 10)]
        out[m] = (r, eng.stats.as_dict())
    assert out[je] == out[te]
    assert [o for o, _ in out[te][0]] == ["miss", "delayed", "hit"]
